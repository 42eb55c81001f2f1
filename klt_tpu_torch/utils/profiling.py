"""Profiling utilities — the GPU analogue of the reference's gprof/nsys
toolchain (src/V1/Makefile:76-91, src/V4/Makefile:100-103).

Two layers:
* `trace(...)` — context manager around `torch.profiler.profile` (CPU and
  CUDA activities) writing a Chrome trace (`*.pt.trace.json.gz`) under a
  directory;
* `op_breakdown(...)` — reads the newest such trace and aggregates the
  device's kernel and copy time by (category, name): a flat profile of
  what the card ran.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import time

import torch

# torch.cuda._sleep's kernel, which opens and closes a trace's window
MARKER = "spin_kernel"
# device event categories of torch's Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# launches that open the profiler's window before the first marker
HEAD_LAUNCHES = 256
# after the closing marker: a pause (s), then launches that are not read
TAIL_PAUSE_S = 0.1
TAIL_LAUNCHES = 4096


def marker() -> None:
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _tiny_launches(n: int) -> None:
    buf = torch.zeros(1, device="cuda")
    for _ in range(n):
        buf.add_(1.0)
    torch.cuda.synchronize()


def close_window() -> None:
    """Close a profiled window on the card: the closing marker, then a
    pause of TAIL_PAUSE_S and TAIL_LAUNCHES tiny kernels that are not
    read.  The profiler also drops device events at the end of its window
    (the closing marker among them after some 18,000 launches in the
    window; up to a few thousand of the launches after it), so the marker
    must not be the window's last event."""
    marker()
    time.sleep(TAIL_PAUSE_S)
    _tiny_launches(TAIL_LAUNCHES)


@contextlib.contextmanager
def trace(log_dir: str, head=None):
    """Profile the with-block into a Chrome trace under log_dir.

    With a CUDA device, the profiler now and then drops the first device
    events of its window (none in a process's first seconds, a handful in
    one that has run for a minute or two), and the last ones (see
    `close_window`).  So, as chip_smoke.py's `profile_device` does, the
    window opens with work that is not read — head() when given (the
    block's own workload is the best choice), else HEAD_LAUNCHES tiny
    kernels — then a marker kernel (MARKER); after the block the device is
    synchronised and `close_window` puts a second marker and work that is
    not read after it.  `op_breakdown` reads only the device events between the two
    markers.  Yields the profiler.  Without a CUDA device it traces the
    CPU alone."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        if cuda:
            if head is not None:
                head()
            else:
                _tiny_launches(HEAD_LAUNCHES)
            marker()
        yield prof
        if cuda:
            close_window()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json.gz")
    prof.export_chrome_trace(path)


def _latest_trace_json(log_dir: str) -> str:
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(log_dir, "**", pat),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no .json or .json.gz trace under {log_dir}")
    return max(paths, key=os.path.getmtime)


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def op_breakdown(log_dir: str, runs: int = 1, top: int = 30):
    """[(us_per_run, count_per_run, category, name), ...] sorted by time,
    over the device events (kernels, copies, fills) of the newest trace
    under log_dir that lie between its first and last marker kernel
    (see `trace`; a trace without two markers is not read).

    SELF-time accounting per device track (pid, tid): each event is
    charged its duration minus its nested children's, so an event nested
    in another is counted once."""
    ev = _load(_latest_trace_json(log_dir))["traceEvents"]
    dev = [e for e in ev if e.get("ph") == "X" and "dur" in e and
           e.get("cat") in DEVICE_CATS]
    if not dev:
        raise ValueError(f"the trace under {log_dir} holds no device event")
    marks = sorted(e["ts"] for e in dev if e.get("cat") == "kernel" and
                   MARKER in e.get("name", ""))
    if len(marks) < 2:
        raise ValueError(f"{len(marks)} of the 2 marker kernels in the "
                         f"trace under {log_dir}: not read")
    lo, hi = marks[0], marks[-1]

    tracks = collections.defaultdict(list)
    for e in dev:
        if lo < e["ts"] < hi:
            tracks[(e.get("pid"), e.get("tid"))].append(e)

    agg = collections.Counter()
    cnt = collections.Counter()

    def account(e, child_dur):
        key = (e["cat"], e.get("name", ""))
        agg[key] += max(e["dur"] - child_dur, 0.0)
        cnt[key] += 1

    for tr in tracks.values():
        tr.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [end_ts, child_dur, event]

        def close_until(ts):
            while stack and stack[-1][0] <= ts + 1e-9:
                _, ch, pe = stack.pop()
                account(pe, ch)
                if stack:
                    stack[-1][1] += pe["dur"]

        for e in tr:
            close_until(e["ts"])
            stack.append([e["ts"] + e["dur"], 0.0, e])
        close_until(float("inf"))

    return [(d / runs, cnt[k] / runs, k[0], k[1])
            for k, d in agg.most_common(top)]


def print_breakdown(log_dir: str, runs: int = 1, top: int = 30) -> None:
    for us, n, cat, name in op_breakdown(log_dir, runs, top):
        print(f"{us:9.1f} us  n={n:7.1f}  {cat[:22]:22s} {name}")
