"""Whole-sequence programs on the card: CUDA graphs of chunks of a frame
loop, captured once per key and replayed (the counterpart of the program
cache of klt_tpu's `jax.jit`, whose frame loops are `lax.scan`s compiled
into one XLA program each).

A sequence entry (runtime/pipeline.py, parallel/batched_lk.py,
parallel/batched_affine.py) keeps the state its frame loop carries in
static buffers, allocated once per key (entry, shapes, dtypes, config,
flags, device): the first pyramid, the features, the affine state, a
staging buffer of frames and the table's rows.  Its chunk function runs
n steps of the loop on those buffers and carries the last step's state
back into them.  `Program.run(n)` runs a chunk:

* on the card, the key's first chunk runs eagerly, on a side stream, as
  torch.cuda.graph's recipe warms up: the library is built and loaded and
  every kernel has run once before a capture; every later chunk replays
  the graph of its length, captured at its first use;
* on the CPU, or for the plain torch versions, the chunk function runs
  as it is, without capture, so that the bookkeeping around it (staging,
  carry, remainder, resume) is one code on both devices.

The graphs are held against their own chunk function: `run(n,
warm_up=True)` runs any chunk as a key's first one runs, eagerly on the
side stream, and the card tests run every entry so beside its replays,
its tables and kernel launches compared bit for bit.

Chunk lengths are klt_tpu's dispatch lengths (`chunk_lengths`): the
longest (K, or the stream's and the exact tier's `chunk`) while that many
steps are left, then powers of two, so a key holds at most
log2(longest) + 1 graphs.  A capture or replay that fails raises: nothing
falls back to an eager loop.

The SLAM solvers (slam/solvers.py::LMSolve) make their programs for one
solve and never cache them: a plan's gather tables hold one problem's
indices, not only its shapes.  A solve runs several programs in turn (a
linearization, CG's chunks, an update), some reading what another's
graph computed, so its first LM iteration runs every program eagerly
(`run(..., warm_up=True)`) and no graph is captured before the
linearization's.

What a graph must not do, and how the entries keep it so: read the host
(the debug checks OR their flags on the device, utils/checks.py); make
kernel R's ticket inside the capture (cuda/replace.py::graph_ticket takes
the program's); hand the caller a tensor from its pool (the rows are
copied out of the static buffers after each replay).  The kernels'
wrappers check their inputs only when the chunk function runs, at the
warm-up and at capture; a shape they would refuse is another key, so it
is still checked.

Every program records the spans `graph.warm_up`, `graph.capture` and
`graph.replay` (utils/profiling.py) around a warm-up, a capture and a
replay (on the CPU and for the plain versions: a run of the chunk
function as it is), and counts its captures and their seconds
(`graph.captures`, `graph.capture_s`: what `_Graph.seconds` keeps).  The
counts a chunk function makes (the affine step's `affine.steps` and
`affine.lanes`) are taken back after a capture and credited at every
replay, as the kernels' launch counts are.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import OrderedDict

import torch

from ..utils import checks
from ..utils.profiling import count, counters, credit_counts, span, \
    take_counts
from . import credit_launches, launch_counts, take_launches

# Steps a graph of the whole-sequence entries covers (measured with 8, 16
# and 32 on the card: PERF.md section 6).
K = 16
# Keys whose programs (static buffers and graphs) are kept, the least
# recently used dropped first.
CACHE_KEYS = 16

_lock = threading.Lock()
_cache: OrderedDict = OrderedDict()
_side_streams: dict[int, torch.cuda.Stream] = {}


def chunk_lengths(steps: int, longest: int) -> list[int]:
    """klt_tpu's dispatch lengths for `steps` steps: `longest` while at
    least that many are left, then the largest power of two that fits
    (klt_tpu/runtime/pipeline.py:318-320, :445-447)."""
    out = []
    while steps > 0:
        n = longest if steps >= longest else 1 << (steps.bit_length() - 1)
        out.append(n)
        steps -= n
    return out


class _Graph:
    """One captured chunk length: the graph, what the chunk function
    returned at capture (tensors of the graph's pool, rewritten by every
    replay), its debug flags, its kernel launches and the program's
    counts its chunk function made (utils/profiling.py)."""

    def __init__(self, graph, outputs, flags, launches, counts, seconds):
        self.graph = graph
        self.outputs = outputs
        self.flags = flags
        self.launches = launches
        self.counts = counts
        self.seconds = seconds


class Program:
    """The static buffers of one key (`static`, the entry's object), its
    chunk function and its graphs.

    chunk_fn(n) runs n steps on the static buffers and returns what the
    entry needs of the chunk besides them (the exact tier: each step's
    pyramid).  capture: replay graphs (CUDA, not plain) or run the chunk
    function as it is.  Graphs are kept by n."""

    def __init__(self, static, chunk_fn, device: torch.device,
                 capture: bool):
        self.static = static
        self.chunk_fn = chunk_fn
        if capture and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.capture = capture
        self.graphs: dict[int, _Graph] = {}
        self.warm = not capture
        self.replays = 0
        # kernel R's ticket in every graph of this program, which replays
        # one graph at a time on its caller's stream (made at the first
        # capture)
        self.ticket = None

    def run(self, n: int, flags: checks.Flags | None = None,
            warm_up: bool = False):
        """Run a chunk of n steps; the debug checks' flags go to `flags`
        (None: the chunk function has no checks).  warm_up: run the chunk
        eagerly, as the first one is, even when the program is warm.
        Returns the chunk function's outputs."""
        flags = checks.Flags() if flags is None else flags
        if not self.capture:
            with span("graph.replay"), checks.collecting(flags):
                return self.chunk_fn(n)
        with torch.cuda.device(self.device):
            if warm_up or not self.warm:
                out = self._warm_up(n, flags)
                self.warm = True
                return out
            g = self.graphs.get(n)
            if g is None:
                with span("graph.capture"):
                    g = self.graphs[n] = self._capture(n)
            with span("graph.replay"):
                g.graph.replay()
                credit_launches(g.launches)
                credit_counts(g.counts)
                flags.merge(g.flags)
                self.replays += 1
        return g.outputs

    def _warm_up(self, n: int, flags: checks.Flags):
        """The key's first chunk, eagerly on a side stream (its results
        are the call's: nothing runs twice)."""
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        try:
            with span("graph.warm_up"), torch.cuda.stream(side), \
                    checks.collecting(flags):
                return self.chunk_fn(n)
        finally:
            cur.wait_stream(side)

    def _capture(self, n: int) -> _Graph:
        from .replace import graph_ticket
        if self.ticket is None:
            self.ticket = torch.zeros(1, dtype=torch.int32,
                                      device=self.device)
        graph = torch.cuda.CUDAGraph()
        flags = checks.Flags()
        before = launch_counts()
        counted = counters()
        t0 = time.perf_counter()
        # no garbage collection inside the capture: one that frees another
        # program's graph there invalidates the capture
        collect = gc.isenabled()
        gc.disable()
        try:
            with graph_ticket(self.ticket), checks.collecting(flags), \
                    torch.cuda.graph(graph):
                outputs = self.chunk_fn(n)
        finally:
            launches = take_launches(before)
            counts = take_counts(counted)
            if collect:
                gc.enable()
        seconds = time.perf_counter() - t0
        count("graph.captures")
        count("graph.capture_s", seconds)
        return _Graph(graph, outputs, flags, launches, counts, seconds)

    def capture_seconds(self) -> float:
        """Capture plus instantiation, all of this key's graphs."""
        return sum(g.seconds for g in self.graphs.values())


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    with _lock:
        s = _side_streams.get(device.index)
        if s is None:
            s = _side_streams[device.index] = torch.cuda.Stream(device)
        return s


@contextlib.contextmanager
def program(key, make):
    """The program of `key` (made by make() when the cache has none),
    held by this caller alone while the context lasts (a concurrent call
    of the same key makes its own), then kept in the cache; a call that
    raises drops it."""
    with _lock:
        prog = _cache.pop(key, None)
    if prog is None:
        prog = make()
    yield prog
    with _lock:
        _cache[key] = prog
        while len(_cache) > CACHE_KEYS:
            _cache.popitem(last=False)


def programs() -> list:
    """(key, program) of the cached programs, least recently used first."""
    with _lock:
        return list(_cache.items())


def _clear() -> None:
    with _lock:
        _cache.clear()
