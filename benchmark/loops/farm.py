"""Recorded video on one card, clip after clip: a closed loop over the
mix's S streams (cameras), one clip at a time, round robin.  A request is
stream s's next clip of `pool` frame pairs through
`track_sequence_replace`, with the features carried from its last clip;
the frames stay on the device.

Set-up runs one clip of every stream (the first captures the entry's
graphs), so the window starts from every stream's steady state.  The
check takes a sample of the window's clips, drawn from the seed, and one
step of each, and the first two steps of stream 0's first clip: the
start, from features that are all lost, where replacement selects every
feature.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import trace as tracing
from benchmark.reference.check import Step


class Loop:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        from klt_tpu_torch.runtime.pipeline import track_sequence_replace
        r = self.run
        self.entry = track_sequence_replace
        self.frames = r.frames                        # [S, pool + 1, H, W]
        n = r.config["n_features"]
        self.feats = []
        self.first = None
        for s in range(self.frames.shape[0]):
            x = torch.full((n,), -1.0, device=r.device)
            val = torch.full((n,), -1, dtype=torch.int32, device=r.device)
            start = (x, x.clone(), val)
            out = self.entry(self.frames[s], *start, r.program_cfg)
            if s == 0:
                self.first = (start, out)
            self.feats.append(tuple(t[-1] for t in out))
        r.sync()

    def request(self, i: int):
        s = i % self.frames.shape[0]
        x, y, val = self.feats[s]
        out = self.entry(self.frames[s], x, y, val, self.run.program_cfg)
        self.feats[s] = tuple(t[-1] for t in out)
        return s, (x, y, val), out

    def window(self, seconds: float) -> None:
        """Clips until `seconds` have passed, then wait for the card; the
        host span of each call and a reservoir sample of the clips."""
        r = self.run
        self.kept = []
        spans = r.spans.setdefault("clip", [])
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            slot = r.reservoir(i)
            a = time.perf_counter()
            done = self.request(i)
            spans.append(time.perf_counter() - a)
            r.keep(self.kept, slot, (i, done))
            i += 1
        r.sync()
        r.window_s = time.perf_counter() - t0
        r.attempted = i
        r.frames_done = i * (self.frames.shape[1] - 1)

    def traced(self, clips: int):
        """A fixed piece of work for the profiler: `clips` requests; then
        as many again, each with the card idle when it is called, for the
        host's own time a call (in the window a call waits while the
        card's queue is full)."""
        def work():
            for i in range(clips):
                with tracing.label("farm.clip"):
                    self.request(i)
        self.run.sync()
        spans = self.run.spans.setdefault("clip_idle_card", [])
        for i in range(clips):
            a = time.perf_counter()
            self.request(i)
            spans.append(time.perf_counter() - a)
            self.run.sync()
        return work

    def steps(self) -> list[Step]:
        """The checked steps (module docstring)."""
        r = self.run
        rng = np.random.default_rng([r.seed, 1])
        (start, out) = self.first
        picks = [(0, start, out, 0), (0, start, out, 1)]
        for _, (s, pre, out) in sorted(self.kept, key=lambda k: k[0]):
            picks.append((s, pre, out, int(rng.integers(0, out[0].shape[0]))))
        steps = []
        for s, pre, out, t in picks:
            before = pre if t == 0 else tuple(o[t - 1] for o in out)
            steps.append(Step(self.frames[s, t], self.frames[s, t + 1],
                              before, tuple(o[t] for o in out)))
        return steps
