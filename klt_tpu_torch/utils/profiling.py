"""Profiling utilities — the GPU analogue of the reference's gprof/nsys
toolchain (src/V1/Makefile:76-91, src/V4/Makefile:100-103).

Three layers:
* `trace(...)` — context manager around `torch.profiler.profile` (CPU and
  CUDA activities) writing a Chrome trace (`*.pt.trace.json.gz`) under a
  directory;
* `op_breakdown(...)` — reads the newest such trace and aggregates the
  device's kernel and copy time by (category, name): a flat profile of
  what the card ran;
* `span(name)` and `count(name)` — the program's own spans and counters
  at its layer boundaries (runtime/tracker.py, runtime/pipeline.py,
  cuda/graph.py).  A span records only while a torch profiler is active
  in the process: it is then a range named "klt:" + name on the
  profiler's host timeline, on the device trace's clock, and a
  record in an in-memory store (`spans()`, `span_seconds`,
  `self_seconds`, `reset_spans`).  With no profiler active a span costs
  one flag check.  Counters are always on (`counters()`); what a chunk
  function counts under a CUDA graph is taken back after the capture and
  credited at every replay (`take_counts`, `credit_counts`).  No span sits in
  anything a CUDA graph captures: it would run once, at capture, and
  never at a replay.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import itertools
import json
import os
import socket
import threading
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
# the prefix of the program's spans on the profiler's timeline
SPAN_PREFIX = "klt:"
# spans the store keeps, the oldest dropped first (counted under
# "spans.dropped")
MAX_SPANS = 65536


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


# ---------------------------------------------------------------- spans

# the module whose `_is_profiler_enabled` every torch profiler sets while
# it records (torch.profiler.profile, torch.autograd.profiler.profile)
_autograd_profiler = torch.autograd.profiler
# a profiler range on the host track, as `torch.profiler.record_function`
# opens, at a fifth to a tenth of its cost (3 us a span against 13-20 us
# on an H100 machine's host): the spans of a profiled loop must not turn a
# device-bound loop into a host-bound one
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_store: collections.deque = collections.deque(maxlen=MAX_SPANS)
_index = itertools.count()
_request = itertools.count()
_local = threading.local()
_counters: dict = {}


class Span:
    """One recorded span: its name, start and end (`time.perf_counter_ns`;
    end 0 while it is open), its index in the store since the last reset,
    the index of the span that encloses it (None for a root) and its
    request: a root opens a new one, its children carry it."""

    __slots__ = ("name", "start", "end", "index", "parent", "request")

    def __init__(self, name, index, parent, request):
        self.name = name
        self.index = index
        self.parent = parent
        self.request = request
        self.start = self.end = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class _Recording:
    """The context of a span while a profiler records.  The span's start
    and end enclose its own recording (the profiler's range and the
    store), so that its parent's self time is the parent's own work and
    not its children's instrumentation."""

    __slots__ = ("name", "span", "function")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        start = time.perf_counter_ns()
        stack = _stack()
        up = stack[-1] if stack else None
        sp = self.span = Span(
            self.name, next(_index), None if up is None else up.index,
            next(_request) if up is None else up.request)
        sp.start = start
        self.function = _range(SPAN_PREFIX + self.name)
        self.function.__enter__()
        if len(_store) == MAX_SPANS:
            count("spans.dropped")
        _store.append(sp)
        stack.append(sp)
        return sp

    def __exit__(self, *exc):
        _stack().pop()
        self.function.__exit__(*exc)
        self.span.end = time.perf_counter_ns()
        return False


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str):
    """A span named `name` around the with-block, recorded while a torch
    profiler is active in the process; otherwise a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name)


def spans() -> list:
    """The store's spans, oldest first (open ones with end 0)."""
    return list(_store)


def reset_spans() -> None:
    """Empty the store and start the indices and requests again."""
    global _index, _request
    _store.clear()
    _index = itertools.count()
    _request = itertools.count()


def _closed(name: str, root: str | None) -> list:
    done = [s for s in _store if s.end]
    if root is not None:
        roots = {s.request: s.name for s in done if s.parent is None}
        done = [s for s in done if roots.get(s.request) == root]
    return [s for s in done if s.name == name]


def span_seconds(name: str, root: str | None = None) -> list[float]:
    """The durations (s) of the closed spans named `name`, oldest first;
    with `root`, only those of requests whose root span is named so."""
    return [s.seconds for s in _closed(name, root)]


def self_seconds(name: str, root: str | None = None,
                 children=None) -> list[float]:
    """As `span_seconds`, each less the durations of its children: all of
    them (the span's self time), or those whose name is in `children`."""
    picked = _closed(name, root)
    less = {s.index: 0 for s in picked}
    for s in _store:
        if s.end and s.parent in less and \
                (children is None or s.name in children):
            less[s.parent] += s.end - s.start
    return [(s.end - s.start - less[s.index]) * 1e-9 for s in picked]


# ------------------------------------------------------------- counters

def count(name: str, n=1) -> None:
    """Add n to counter `name` (always on)."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of the counters since the process started."""
    return dict(_counters)


def take_counts(before: dict) -> dict:
    """The counts added since `before` (counters()), taken off again: a
    stream capture runs a chunk function's host code once and the card
    nothing (cuda/graph.py credits them at every replay)."""
    taken = {k: v - before.get(k, 0) for k, v in _counters.items()
             if v != before.get(k, 0)}
    for k in taken:
        if k in before:
            _counters[k] = before[k]
        else:
            del _counters[k]
    return taken


def credit_counts(taken: dict) -> None:
    """Add a replayed graph's counts (take_counts) to the counters."""
    for k, n in taken.items():
        count(k, n)
