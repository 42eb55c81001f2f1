"""Recorded clips of several cameras on one card through the affine
consistency check: a closed loop, one request in flight.  A request is
one call of `track_sequences_affine_batched` on the mix's S streams of
pool + 1 frames ([S, pool + 1, H, W] u8 on the card), from the start
features of every stream; every request tracks the same clips from the
same features, as an analytics farm runs each batch of recorded clips.

The frames are the generator's (frames.py: the circle motion and the
blocks), warped on the card by a similarity about the image centre, so
that the saved patches meet a real affine deformation: frame k of stream
s is zoomed by zoom[0] .. zoom[1] and rolled by +-roll_deg, on a period
of `pool` frames, phase-shifted by s / S.  The phase is taken of
k mod pool, so frame `pool` stays frame 0.  A zoom of at least 1.04
keeps every bilinear sample inside the frame under a roll of 1.5
degrees.

Set-up warps the frames, selects `n_features` features on each stream's
frame 0 with the port's `KLTracker.select_good_features` and runs two
requests (the first captures the entry's graphs).  The check follows one
stream, drawn from the seed, of one request of the window (a reservoir
of `sample` requests, drawn from the seed), through its whole clip from
the request's start features: the plain reference's pyramid, its
Lucas-Kanade and its affine step (reference/affine.py), every slot's x,
y and val bits compared at every step.  `steps()` gives no step to
check.judge, which holds a path without the affine step.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from benchmark import trace as tracing
from benchmark.reference import affine as affine_ref, check

# the first request captures the entry's graphs, the second replays each
# for the first time: the window starts from the steady state
WARM_REQUESTS = 2


def _bilinear(imgs: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor
              ) -> torch.Tensor:
    """Bilinear samples of f32 frames [T, H, W] at [T, H, W] coordinates,
    the corner clamped into the frame."""
    t, h, w = imgs.shape
    x0 = sx.floor().clamp(0, w - 2)
    y0 = sy.floor().clamp(0, h - 2)
    fx, fy = sx - x0, sy - y0
    base = (torch.arange(t, device=imgs.device)[:, None, None] * h +
            y0.long()) * w + x0.long()
    flat = imgs.reshape(-1)
    p00, p01, p10, p11 = (flat[base + d] for d in (0, 1, w, w + 1))
    return ((1 - fx) * (1 - fy) * p00 + fx * (1 - fy) * p01 +
            (1 - fx) * fy * p10 + fx * fy * p11)


def warp(frames: torch.Tensor, p: dict) -> torch.Tensor:
    """u8 [S, T, H, W]: each frame under its stream's zoom and roll about
    the image centre (module docstring)."""
    n, t, h, w = frames.shape
    pool = int(p["pool"])
    z0, z1 = (float(z) for z in p["zoom"])
    roll = math.radians(float(p["roll_deg"]))
    dev = frames.device
    k = torch.arange(t, device=dev) % pool
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] - \
        (h - 1) / 2.0
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] - \
        (w - 1) / 2.0
    out = torch.empty_like(frames)
    for s in range(n):
        ph = 2.0 * math.pi * (k.to(torch.float64) / pool + s / n)
        zoom = z0 + (z1 - z0) * (1.0 - torch.cos(ph)) / 2.0
        theta = roll * torch.sin(ph)
        # frame pixel p samples the source at c + R(theta) (p - c) / zoom
        c = (torch.cos(theta) / zoom).to(torch.float32)[:, None, None]
        sn = (torch.sin(theta) / zoom).to(torch.float32)[:, None, None]
        sx = (w - 1) / 2.0 + c * xx - sn * yy
        sy = (h - 1) / 2.0 + sn * xx + c * yy
        img = _bilinear(frames[s].to(torch.float32), sx, sy)
        out[s] = img.round().clamp(0, 255).to(torch.uint8)
    return out


class Loop:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        import klt_tpu_torch as klt
        from klt_tpu_torch.parallel.batched_affine import \
            track_sequences_affine_batched
        r = self.run
        klt.set_verbosity(0)
        self.entry = track_sequences_affine_batched
        self.cfg = dataclasses.replace(r.program_cfg, **r.config["affine"])
        self.acfg = affine_ref.AffineConfig(**r.config["affine"])
        r.frames = self.frames = warp(r.frames, r.traffic)
        n = int(r.config["n_features"])
        tracker = klt.KLTracker(self.cfg, device=r.device)
        lists = []
        for s in range(self.frames.shape[0]):
            fl = klt.FeatureList.create(n)
            tracker.select_good_features(self.frames[s, 0].cpu().numpy(), fl)
            lists.append(fl)
        self.start = tuple(
            torch.from_numpy(np.stack([getattr(fl, k) for fl in lists]))
            .to(r.device) for k in ("x", "y", "val"))
        r.counters["start_features"] = int((self.start[2] >= 0).sum())
        for _ in range(WARM_REQUESTS):
            self.last = self.request()
        self.kept = []
        self._ref = None
        r.sync()

    def request(self):
        return self.entry(self.frames, *self.start, self.cfg)

    def window(self, seconds: float) -> None:
        """Requests until `seconds` have passed, then wait for the card;
        the host span of each call and a reservoir sample of the
        requests."""
        r = self.run
        spans = r.spans.setdefault("request", [])
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            slot = r.reservoir(i)
            a = time.perf_counter()
            out = self.request()
            spans.append(time.perf_counter() - a)
            r.keep(self.kept, slot, (i, out))
            i += 1
        r.sync()
        r.window_s = time.perf_counter() - t0
        r.attempted = i
        s, t = self.frames.shape[:2]
        r.frames_done = i * s * (t - 1)

    def traced(self, requests: int):
        """A fixed piece of work for the profiler: `requests` requests;
        then as many again, each with the card idle when it is called,
        for the host's own time a call."""
        def work():
            for _ in range(requests):
                with tracing.label("affine.request"):
                    self.request()
        self.run.sync()
        spans = self.run.spans.setdefault("request_idle_card", [])
        for _ in range(requests):
            a = time.perf_counter()
            self.request()
            spans.append(time.perf_counter() - a)
            self.run.sync()
        return work

    def steps(self) -> list:
        """No step for check.judge, which holds a path without the affine
        step: compare() checks this path."""
        return []

    def compare(self, control: bool = False) -> dict:
        """The followed stream's clip against the plain reference's
        (module docstring): `track_mismatch`, the slots of all its steps
        whose x, y or val bits differ.  control: the reference with its
        pyramid in bfloat16 in the program's place."""
        r = self.run
        rng = np.random.default_rng([r.seed, 1])
        s = int(rng.integers(0, self.frames.shape[0]))
        start = tuple(a[s] for a in self.start)
        if self._ref is None:
            affine_stats = []
            self._ref = affine_ref.follow(
                self.frames[s], *start, r.ref_cfg, self.acfg,
                lk_stats=r.lk_stats, affine_stats=affine_stats)
            r.counters["affine_stats"] = affine_stats
            r.counters["followed_stream"] = s
            r.counters["followed_steps"] = len(affine_stats)
            r.counters["affine_killed"] = sum(a[3] for a in affine_stats)
        if control:
            prog = affine_ref.follow(self.frames[s], *start, r.ref_cfg,
                                     self.acfg, dtype=torch.bfloat16)
        else:
            out = self.kept[0][1] if self.kept else self.last
            prog = tuple(o[:, s] for o in out)
        return {"track_mismatch": int(check._differ(prog, self._ref).sum())}
