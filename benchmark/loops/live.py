"""One live camera per process, through the reference's C-style API: for
each frame `KLTracker.track_features(img1, img2, fl)`, then
`replace_lost_features(img2, fl)`, with numpy frames and a `FeatureList`
in host memory, in a closed loop.  The frames are stream 0's pool of the
mix that `frames_of` names, played again and again (frame `pool` is
frame 0).

Set-up runs `warm_frames` frames from features that are all lost (the
first frame's replacement selects every feature, and the tracker's step
programs are captured).  The check takes a sample of the window's frames,
drawn from the seed, and the first two frames of the set-up: the start.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark import trace as tracing
from benchmark.reference.check import Step

_none = contextlib.nullcontext()


class Loop:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        import klt_tpu_torch as klt
        r = self.run
        klt.set_verbosity(0)
        self.pool = r.frames[0].cpu().numpy()          # [pool + 1, H, W]
        self.period = self.pool.shape[0] - 1
        self.tracker = klt.KLTracker(r.program_cfg, device=r.device)
        self.fl = klt.FeatureList.create(r.config["n_features"])
        self.k = 0
        self.first = [self.frame(keep=True)[1] for _ in range(2)]
        for _ in range(int(r.traffic["warm_frames"]) - 2):
            self.frame()
        r.sync()

    def frame(self, keep: bool = False, spans=None, traced: bool = False):
        """Track into the next frame and replace; returns (seconds,
        (k, pre, tracked, out)) with the states when `keep`; `traced`
        puts a span around each call for the profiler."""
        k = self.k % self.period
        img1, img2 = self.pool[k], self.pool[k + 1]
        fl = self.fl
        pre = fl.copy() if keep else None
        a = time.perf_counter()
        with tracing.label("live.track_features") if traced else _none:
            self.tracker.track_features(img1, img2, fl)
        b = time.perf_counter()
        tracked = fl.copy() if keep else None
        c = time.perf_counter()
        with tracing.label("live.replace_lost_features") if traced \
                else _none:
            self.tracker.replace_lost_features(img2, fl)
        d = time.perf_counter()
        self.k += 1
        if spans is not None:
            spans["track"].append(b - a)
            spans["replace"].append(d - c)
            spans["frame"].append(b - a + d - c)
        return d - a, (k, pre, tracked, fl.copy() if keep else None)

    def window(self, seconds: float) -> None:
        from klt_tpu_torch import cuda
        r = self.run
        self.kept = []
        spans = {k: r.spans.setdefault(k, []) for k in
                 ("frame", "track", "replace")}
        before = cuda.launch_counts()
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            slot = r.reservoir(i)
            _, done = self.frame(keep=slot is not None, spans=spans)
            r.keep(self.kept, slot, (i, done))
            i += 1
        r.sync()
        r.window_s = time.perf_counter() - t0
        r.counters["launches"] = sum(cuda.launch_counts()) - sum(before)
        r.attempted = r.frames_done = i

    def traced(self, frames: int):
        def work():
            for _ in range(frames):
                self.frame(traced=True)
        return work

    def steps(self) -> list[Step]:
        dev = self.run.device

        def on(fl):
            return tuple(torch.from_numpy(a.copy()).to(dev)
                         for a in (fl.x, fl.y, fl.val))

        kept = self.first + [d for _, d in sorted(self.kept,
                                                  key=lambda k: k[0])]
        return [Step(torch.from_numpy(self.pool[k]).to(dev),
                     torch.from_numpy(self.pool[k + 1]).to(dev), on(pre),
                     on(out), on(tracked))
                for k, pre, tracked, out in kept]
