"""From a video clip to a map, one map at a time: the port's
tracking-to-mapping pipeline as klt_tpu's bench_slam_e2e runs it, with
the hand-off of the port's examples/slam_pipeline.py.  A request is the
whole clip:

1. front end: `track_sequence_replace(precomp=True)` over the clip with
   frame 0 given twice, from features that are all lost, so the first
   step's replacement selects the features on frame 0 and the table has
   a column for every frame;
2. the table to the host and the example's `keyframe_observations`
   (chains, keyframes by overlap, observations on keyframes) and
   `unit_depth_landmarks`;
3. `keyframe_pose_graph_init`: the pair solves and the pose graph;
4. `bundle_adjust_gated` from those poses and landmarks.

Set-up runs one whole map (every map captures its solves' graphs again).
The check takes one map of the window, drawn from the seed: 24 of its
front-end steps drawn from the seed and its first two (the start); then
the reference (benchmark/reference/slam, float64) works the hand-off and
the whole back end out again from the map's table, and the program's
keyframes and observations are held to its own exactly, its poses,
landmarks and loss to its own within the limits of check.LIMITS.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmark import trace as tracing
from benchmark.reference.check import Step
from benchmark.reference.slam import handoff, solve


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def differ(a, b) -> int:
    """Elements of a and b that differ in their bits (every element when
    the shapes differ)."""
    a, b = _bits(a), _bits(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int((a != b).sum())


class Loop:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        from klt_tpu_torch import slam
        from klt_tpu_torch.examples import slam_pipeline
        from klt_tpu_torch.runtime.pipeline import track_sequence_replace
        from klt_tpu_torch.slam.frontend import keyframe_pose_graph_init
        r = self.run
        self.entry = track_sequence_replace
        self.slam = slam
        self.example = slam_pipeline
        self.pg_init = keyframe_pose_graph_init
        f = r.frames[0]
        self.frames = torch.cat([f[:1], f])           # frame 0 twice
        r.frames = None
        n = r.config["n_features"]
        x = torch.full((n,), -1.0, device=r.device)
        self.start = (x, x.clone(),
                      torch.full((n,), -1, dtype=torch.int32,
                                 device=r.device))
        s = r.config["slam"]
        w, h = r.config["width"], r.config["height"]
        self.intr = solve.Intrinsics(s["focal_scale"] * w,
                                     s["focal_scale"] * w, w / 2.0, h / 2.0)
        self.request(0)
        r.sync()

    def request(self, i: int, spans: dict | None = None) -> dict:
        r, s, k = self.run, self.run.config["slam"], self.intr
        a = time.perf_counter()
        out = self.entry(self.frames, *self.start, r.program_cfg,
                         precomp=bool(r.config.get("precomp", False)))
        x, y, val = (o.T.cpu().numpy() for o in out)   # [N, T]
        done = {"out": out, "table": (x, y, val)}
        try:
            obs = self.example.keyframe_observations(
                types.SimpleNamespace(x=x, y=y, val=val))
        except ValueError:
            # nothing to adjust: the request failed
            r.counters["failed"] = r.counters.get("failed", 0) + 1
            return dict(done, failed=True)
        kfs, lm_idx, cam_idx, u, v = obs
        b = time.perf_counter()
        R0, t0, _ = self.pg_init(lm_idx, cam_idx, u, v, len(kfs), k.fx,
                                 k.fy, k.cx, k.cy, s["pair_iters"],
                                 s["pg_iters"], device=r.device)
        c = time.perf_counter()
        lm0 = self.example.unit_depth_landmarks(lm_idx, u, v, k.fx, k.fy,
                                                k.cx, k.cy)

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(r.device)

        prob = self.slam.BAProblem(
            R=on(R0), t=on(t0), landmarks=on(lm0), cam_idx=on(cam_idx),
            lm_idx=on(lm_idx),
            uv=on(np.stack([u, v], -1).astype(np.float32)),
            weight=torch.ones(len(cam_idx), dtype=torch.float32,
                              device=r.device),
            fx=k.fx, fy=k.fy, cx=k.cx, cy=k.cy)
        ba = self.slam.bundle_adjust_gated(
            prob, rounds=s["ba_rounds"], iterations=s["ba_iterations"],
            robust_delta=s["robust_delta"], gate_px=s["gate_px"])
        r.sync()
        d = time.perf_counter()
        if spans is not None:
            spans["frontend"].append(b - a)
            spans["pose_graph"].append(c - b)
            spans["ba"].append(d - c)
        return dict(done, obs=obs, pg=(R0, t0), ba=ba)

    def window(self, seconds: float) -> None:
        """Whole maps until `seconds` have passed; the window ends with
        the map in flight then."""
        r = self.run
        spans = {k: r.spans.setdefault(k, []) for k in
                 ("frontend", "pose_graph", "ba")}
        rng = np.random.default_rng([r.seed, 2])
        self.kept = None
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            done = self.request(i, spans)
            # a reservoir of one map
            if int(rng.integers(0, i + 1)) == 0:
                self.kept = done
            i += 1
        r.window_s = time.perf_counter() - t0
        r.attempted = i
        r.counters["maps"] = i
        if not self.kept.get("failed"):
            r.counters["keyframes"] = len(self.kept["obs"][0])
            r.counters["observations"] = len(self.kept["obs"][1])
            r.counters["landmarks"] = int(self.kept["obs"][1].max()) + 1

    def traced(self, maps: int):
        def work():
            for i in range(maps):
                with tracing.label("map.request"):
                    self.request(i)
        return work

    def steps(self) -> list[Step]:
        """The checked front-end steps of the kept map: its first two and
        24 drawn from the seed."""
        r = self.run
        out = self.kept["out"]
        rng = np.random.default_rng([r.seed, 1])
        ts = [0, 1] + sorted(int(t) for t in rng.choice(
            np.arange(2, out[0].shape[0]), r.sample_size, replace=False))
        return [Step(self.frames[t], self.frames[t + 1],
                     self.start if t == 0 else tuple(o[t - 1] for o in out),
                     tuple(o[t] for o in out)) for t in ts]

    def compare(self, control: bool = False) -> dict:
        """The kept map's hand-off and back end against the reference's,
        worked out from the map's table: keyframes and observations that
        differ (exactly), then the gaps of the pose graph's poses, of the
        bundle adjustment's poses and landmarks, and the share of its
        descent that the program's solution falls short of (solve.py).
        control: the reference in bfloat16 in the program's back end's
        place, from the same hand-off."""
        k, s = self.kept, self.run.config["slam"]
        x, y, val = k["table"]
        try:
            ref_obs = handoff.observations(x, y, val, s["keyframe_overlap"],
                                           s["min_track_length"])
        except ValueError:
            ref_obs = None
        if k.get("failed") or ref_obs is None:
            return {"handoff_mismatch": int(bool(k.get("failed")) !=
                                            (ref_obs is None))}
        n = sum(differ(a, b) for a, b in zip(ref_obs, k["obs"]))
        args = (ref_obs[1], ref_obs[2], ref_obs[3], ref_obs[4],
                len(ref_obs[0]), self.intr, s)
        dev = self.run.device
        ref = solve.back_end(*args, dtype=torch.float64, device=dev)
        if control:
            c = solve.back_end(*args, dtype=torch.bfloat16, device=dev)
            pg, ba = (c["pg_R"], c["pg_t"]), (c["R"], c["t"], c["X"])
        else:
            on = lambda a: torch.as_tensor(np.asarray(a), device=dev)
            pg = tuple(on(a) for a in k["pg"])
            ba = k["ba"][:3]
        # readings kept for the record, not compared
        self.run.counters["map_readings"] = {
            "ref_active": int(ref["active"].sum()),
            "observations": int(ref["active"].numel()),
            "ref_behind": solve.behind(ref["R"], ref["t"], ref["X"],
                                       ref["obs"], self.intr),
            "program_behind": solve.behind(*ba, ref["obs"], self.intr),
            "ref_nonfinite_landmarks": solve.nonfinite(ref["X"]),
            "program_nonfinite_landmarks": solve.nonfinite(ba[2])}
        return {"handoff_mismatch": n,
                "pose_graph_gap": solve.pose_gap(*pg, ref["pg_R"],
                                                 ref["pg_t"]),
                "ba_pose_gap": solve.pose_gap(ba[0], ba[1], ref["R"],
                                              ref["t"]),
                "ba_landmark_gap": solve.landmark_gap(ba[2], ref["X"]),
                "ba_loss_gap": solve.loss_gap(*ba, ref, self.intr,
                                              s["robust_delta"])}
