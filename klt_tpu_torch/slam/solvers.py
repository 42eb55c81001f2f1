"""The solvers' shared parts: segment sums in a fixed order, and CG.

klt_tpu reduces per-observation (per-edge) blocks with
`jax.ops.segment_sum`.  Its PyTorch counterparts on CUDA (`index_add_`,
`scatter_add_`) add with atomics in no fixed order, so two runs on the
card could differ in the last bits and flip an LM accept test
(`c_new < c_cur`) between runs.  `Segments` sorts the segment ids once per
problem instead and lays the members of each non-empty segment out in a
padded [S, K] gather table (K the largest segment); a sum is then one
gather and one reduction over K, whose order is fixed by the shapes: the
same inputs give the same bits on every run, on the CPU and on the card.

`pcg` is klt_tpu's preconditioned CG `while_loop` with its stop rule
read on the host only once every few iterations.

`LMSolve` is the counterpart of klt_tpu's compiled LM scans: one solve's
state in static buffers and its steps as programs of cuda/graph.py
(CUDA graphs on the card, captured at the second LM iteration and then
replayed), with `CG` as the program of CG's chunks; `pcg` and the
solvers' `*_eager` bodies are what the programs are held against.

`Shard` is a rank's part of a solve over a mesh (klt_tpu's shard_map with
`psum` over "data"): its contiguous block of the observations (edges),
whose partial normal equations are summed over the ranks by one
all_reduce; everything else is computed on the whole, replicated problem,
so every rank takes the same branches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import graph
from ..parallel.mesh import all_reduce_sum, axis_size, block


class Segments:
    """The members of each segment of an index vector, built once.

    idx: int [M] segment ids in [0, n) on any device; a negative id
    leaves its row out of every sum (for rows known to hold zeros, such as
    the padding of a batch of problems).  Building it asks the host for
    the sizes; `sum` never does."""

    def __init__(self, idx: torch.Tensor, n: int):
        idx = idx.reshape(-1).to(torch.int64)
        m = idx.shape[0]
        self.n, self.m = n, m
        dev = idx.device
        key = torch.where(idx >= 0, idx, torch.full_like(idx, n))
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=n + 1)[:n]
        kmax = int(counts.max()) if m and n else 0
        ids = torch.nonzero(counts).reshape(-1)
        rank = torch.zeros(n, dtype=torch.int64, device=dev)
        rank[ids] = torch.arange(ids.shape[0], device=dev)
        starts = torch.cumsum(counts, 0) - counts
        sid = key[order]
        kept = sid < n
        order, sid = order[kept], sid[kept]
        pos = torch.arange(sid.shape[0], device=dev) - starts[sid]
        # row m of the gathered values is the zero row padding points at
        table = torch.full((ids.shape[0], kmax), m, dtype=torch.int64,
                           device=dev)
        table[rank[sid], pos] = order
        self.ids, self.table = ids, table

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """[M, ...] -> [n, ...]: each segment's sum, zero where empty."""
        if vals.shape[0] != self.m:
            raise ValueError(f"expected {self.m} rows, got {vals.shape[0]}")
        tail = vals.shape[1:]
        padded = torch.cat([vals, vals.new_zeros((1,) + tail)])
        sums = padded[self.table].sum(1)
        out = vals.new_zeros((self.n,) + tail)
        return out.index_copy(0, self.ids, sums)


# CG reads its stop rule on the host once every this many iterations;
# the iterations in between are masked, so the result is the loop's that
# stops at the first failing iteration
CG_CHECK_EVERY = 8


def _cg_start(precond, rhs: torch.Tensor, cg_tol: float, out=None):
    """CG's state at x = 0: (x, r, p, rz, stop), stop the threshold of
    |r|^2 (cg_tol squared in f32, as klt_tpu's jnp.float32(cg_tol) ** 2,
    a Python scalar: a tensor made from one is a copy the host waits
    for).  out: those five static buffers, written in place."""
    scale = float(np.float32(cg_tol) ** 2)
    if out is None:
        z = precond(rhs)
        return (torch.zeros_like(rhs), rhs, z, torch.sum(rhs * z),
                scale * torch.sum(rhs * rhs))
    x, rr, p, rz, stop = out
    x.zero_()
    rr.copy_(rhs)
    z = precond(rr)
    p.copy_(z)
    rz.copy_(torch.sum(rr * z))
    torch.mul(torch.sum(rhs * rhs), scale, out=stop)
    return out


def _cg_chunk(matvec, precond, stop, state, n: int, out=None, flag=None):
    """n masked CG iterations from state (x, r, p, rz): an iteration
    past the stop leaves all four as they are.  out: static buffers of
    the four, written in place (they may be the state's); flag: one for
    the flag.  Returns the new state and the stop flag after the chunk
    (|r|^2 > stop: go on)."""
    for _ in range(n):
        x, rr, p, rz = state
        go = torch.sum(rr * rr) > stop
        hp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
        x_n = x + alpha * p
        rr_n = rr - alpha * hp
        z = precond(rr_n)
        rz_n = torch.sum(rr_n * z)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z + beta * p
        state = tuple(torch.where(go, a, b, out=o) for a, b, o in zip(
            (x_n, rr_n, p_n, rz_n), state, out or (None,) * 4))
    return state, torch.gt(torch.sum(state[1] * state[1]), stop, out=flag)


def pcg(matvec, precond, rhs: torch.Tensor, cg_iters: int,
        cg_tol: float) -> torch.Tensor:
    """Preconditioned CG from x = 0, as klt_tpu's `while_loop`: it runs
    while k < cg_iters and |r|^2 > cg_tol^2 |rhs|^2.  An iteration past
    the stop is masked (x, r, p and rz keep their values), and the host
    reads the stop flag once every CG_CHECK_EVERY iterations, so the
    result equals the loop that stops at the first failing iteration."""
    *state, stop = _cg_start(precond, rhs, cg_tol)
    k = 0
    while k < cg_iters:
        n = min(CG_CHECK_EVERY, cg_iters - k)
        state, go = _cg_chunk(matvec, precond, stop, state, n)
        k += n
        if k < cg_iters and not bool(go):
            break
    return state[0]


class CG:
    """`pcg` as a program (cuda/graph.py) on static buffers: x, r, p, rz,
    the stop threshold and the stop flag, for systems of `shape`.

    A solve's linearization calls `start` (inside its own step, so a
    graph of that step computes the system and CG's start), then `solve`
    runs chunks of CG_CHECK_EVERY masked iterations (the last one
    shorter when cg_iters is not a multiple) and reads the flag on the
    host after each but the last: on the card each chunk after the first
    is a replay of the graph of its length, which reads the system's
    tensors where the linearization's graph wrote them."""

    def __init__(self, shape, device: torch.device, cg_iters: int,
                 cg_tol: float, capture: bool):
        f32 = dict(dtype=torch.float32, device=device)
        self.x, self.r, self.p = (torch.empty(shape, **f32)
                                  for _ in range(3))
        self.rz, self.stop = torch.empty((), **f32), torch.empty((), **f32)
        self.go = torch.empty((), dtype=torch.bool, device=device)
        self.cg_iters, self.cg_tol = cg_iters, cg_tol
        self.matvec = self.precond = None
        self.program = graph.Program(self, self.chunk, device, capture)
        self.chunks = 0

    def start(self, matvec, precond, rhs: torch.Tensor) -> None:
        """The system's products and CG's state at x = 0."""
        self.matvec, self.precond = matvec, precond
        _cg_start(precond, rhs, self.cg_tol,
                  (self.x, self.r, self.p, self.rz, self.stop))

    def chunk(self, n: int) -> None:
        """n masked iterations on the static buffers, then the flag."""
        state = (self.x, self.r, self.p, self.rz)
        _cg_chunk(self.matvec, self.precond, self.stop, state, n, state,
                  self.go)

    def solve(self, warm_up: bool = False) -> torch.Tensor:
        """CG to its stop; returns x (the static buffer)."""
        k = 0
        while k < self.cg_iters:
            n = min(CG_CHECK_EVERY, self.cg_iters - k)
            self.program.run(n, warm_up=warm_up)
            self.chunks += 1
            k += n
            if k < self.cg_iters and not bool(self.go):
                break
        return self.x


class LMSolve:
    """One Levenberg-Marquardt solve as programs (cuda/graph.py): the
    counterpart of klt_tpu's jitted LM scan.

    A subclass copies the caller's tensors into static buffers, builds
    its plan (outside any program: Segments reads the host), and defines
    either `_iteration` (a whole LM iteration with a dense solve) or
    `_linearize` (the system and `self.cg.start`) and `_update` (from
    `self.cg.x` to the accept test).  Every step writes the state in
    place (the accept test's `where`s into the static buffers) and the
    iteration's cost into the slot `self.cost` (None: no cost curve).  On
    the card the first LM iteration runs eagerly (the warm-up, on a side
    stream), the second captures each step's graph and every later one
    replays them; on the CPU the steps run as they are.  The programs
    belong to the solve and die with it."""

    cost = None

    def __init__(self, device: torch.device, cg=None, cg_shape=None):
        """cg: (cg_iters, cg_tol) for a CG solve of systems of
        cg_shape, None for a dense one."""
        self.capture = device.type == "cuda"
        self.device = device
        if cg is None:
            self.cg = None
            self.steps = [self.program(self._iteration)]
        else:
            self.cg = CG(cg_shape, device, *cg, self.capture)
            self.steps = [self.program(self._linearize),
                          self.program(self._update)]
        self.warm = False

    def program(self, step) -> graph.Program:
        """A program of one step (a method of this solve, no
        arguments)."""
        return graph.Program(self, lambda n: step(), self.device,
                             self.capture)

    def lm_drive(self, iterations: int):
        """LM iterations from the static state; returns the cost curve
        [iterations] (a new tensor), or None without a cost slot."""
        costs = None if self.cost is None else \
            self.cost.new_empty(iterations)
        for i in range(iterations):
            self.iteration(not self.warm)
            self.warm = True
            if costs is not None:
                costs[i:i + 1].copy_(self.cost.reshape(1))
        return costs

    def iteration(self, eager: bool) -> None:
        """One LM iteration: its steps, with CG's chunks between them
        (eager: every program runs eagerly)."""
        self.steps[0].run(1, warm_up=eager)
        if self.cg is not None:
            self.cg.solve(eager)
            self.steps[1].run(1, warm_up=eager)

    def programs(self) -> list:
        """Every program of the solve (its steps', CG's and its own
        others' `extra_programs`)."""
        return self.steps + ([] if self.cg is None else
                             [self.cg.program]) + self.extra_programs()

    def extra_programs(self) -> list:
        return []


class Shard:
    """This rank's block of m observations (edges) over a mesh's "data"
    axis: `rows` slices them, `plan` is the solver's plan of that block
    (made by make_plan(rows); the whole problem's `full` when the block
    is everything), and `reduce(tensors)` sums partial results over the
    axis with one all_reduce.  Without a mesh: everything, and reduce
    returns its tensors as they are."""

    def __init__(self, m: int, mesh, full, make_plan):
        self.mesh = mesh
        self.rows = slice(0, m) if mesh is None else \
            block(mesh, "data", m, "observations")
        self.plan = full if self.rows == slice(0, m) else \
            make_plan(self.rows)

    def reduce(self, tensors):
        tensors = list(tensors)
        return tensors if self.mesh is None else \
            all_reduce_sum(tensors, self.mesh, "data")


def data_size(mesh) -> int:
    """The size of a mesh's "data" axis (1 without a mesh)."""
    return 1 if mesh is None else axis_size(mesh, "data")
