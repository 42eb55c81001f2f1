"""The traced segment of a `--trace 1` run: torch.profiler over a fixed
piece of the cell's own work, read from the device's timeline.

The profiler drops device events at both ends of a window now and then
(the first ones in a process that has run for a while, the last ones
after some 18,000 launches).  So the segment opens with work that is not
read, then a marker kernel; after the work, the device is synchronised,
a second marker is put down, and a pause and launches that are not read
follow it.  Only the device events between the two markers are read.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
LABEL = "bench:"                # the harness's spans (record_function)
TAIL_PAUSE_S = 0.1
TAIL_LAUNCHES = 4096
TOP = 10


@dataclasses.dataclass
class Trace:
    busy_s: float                        # union of device intervals
    window_s: float                      # device time between the markers
    kernels: dict                        # name -> [seconds, launches]
    idle: dict                           # host activity -> gap seconds

    def kernel(self, patterns) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds one of
        `patterns`."""
        sec = n = 0
        for name, (s, c) in self.kernels.items():
            if any(p in name for p in patterns):
                sec, n = sec + s, n + c
        return sec, n

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v[0]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _marker() -> None:
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _tail() -> None:
    time.sleep(TAIL_PAUSE_S)
    buf = torch.zeros(1, device="cuda")
    for _ in range(TAIL_LAUNCHES):
        buf.add_(1.0)
    torch.cuda.synchronize()


def label(name: str):
    """A span of the harness around a call into the program, which the
    idle gaps are attributed to."""
    return torch.profiler.record_function(LABEL + name)


def _short(name: str) -> str:
    """A kernel's name without its namespace, return type and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:120]


def _on_device(e) -> bool:
    """A kernel, copy or fill on the card (not a span's annotation)."""
    return ("CUDA" in str(e.device_type) and
            not getattr(e, "is_user_annotation", False) and
            not e.name.startswith(LABEL))


def profile(head, work) -> Trace | None:
    """Profile head() (not read) and work(); None when the profiler saw
    no device event between the markers."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        head()
        torch.cuda.synchronize()
        _marker()
        work()
        torch.cuda.synchronize()
        _marker()
        _tail()
    dev, host = [], []
    for e in prof.events():
        if _on_device(e):
            dev.append(e)
        elif "CUDA" not in str(e.device_type):
            host.append(e)
    dev.sort(key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(dev) if MARKER in e.name]
    if len(marks) < 2:
        return None
    lo, hi = marks[0], marks[-1]
    window = dev[lo + 1:hi]
    if not window:
        return None
    t_open, t_close = dev[lo].time_range.end, dev[hi].time_range.start
    kernels = collections.defaultdict(lambda: [0.0, 0])
    busy = 0.0
    end = t_open
    gaps = []
    for e in window:
        s, f = e.time_range.start, e.time_range.end
        k = kernels[_short(e.name)]
        k[0] += (f - s) * 1e-6
        k[1] += 1
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    if t_close > end:
        gaps.append((end, t_close))
    return Trace(busy * 1e-6, (t_close - t_open) * 1e-6, dict(kernels),
                 _attribute(gaps, host))


def _attribute(gaps, host) -> dict:
    """Each idle gap's seconds, by the innermost host activity at its
    middle (a span of the harness, an operator or a runtime call)."""
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in host), key=lambda t: t[0])
    starts = [s for s, _, _ in spans]
    out = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        # the innermost span that holds the middle: the latest start
        # whose end lies beyond it
        for s, f, name in reversed(spans[max(0, i - 2000):i]):
            if f >= mid:
                best = name
                break
        out[best or "host: between operations"] += (b - a) * 1e-6
    return dict(out)
