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

`Shard` is a rank's part of a solve over a mesh (klt_tpu's shard_map with
`psum` over "data"): its contiguous block of the observations (edges),
whose partial normal equations are summed over the ranks by one
all_reduce; everything else is computed on the whole, replicated problem,
so every rank takes the same branches.
"""

from __future__ import annotations

import numpy as np
import torch

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


def pcg(matvec, precond, rhs: torch.Tensor, cg_iters: int,
        cg_tol: float) -> torch.Tensor:
    """Preconditioned CG from x = 0, as klt_tpu's `while_loop`: it runs
    while k < cg_iters and |r|^2 > cg_tol^2 |rhs|^2.  An iteration past
    the stop is masked (x, r, p and rz keep their values), and the host
    reads the stop flag once every CG_CHECK_EVERY iterations, so the
    result equals the loop that stops at the first failing iteration."""
    x = torch.zeros_like(rhs)
    rr = rhs
    z = precond(rr)
    p = z
    rz = torch.sum(rr * z)
    # cg_tol squared in f32, as klt_tpu's jnp.float32(cg_tol) ** 2 (a
    # Python scalar: a tensor made from one is a copy the host waits for)
    stop = float(np.float32(cg_tol) ** 2) * torch.sum(rhs * rhs)
    k = 0
    while k < cg_iters:
        for _ in range(min(CG_CHECK_EVERY, cg_iters - k)):
            go = torch.sum(rr * rr) > stop
            hp = matvec(p)
            alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
            x_n = x + alpha * p
            rr_n = rr - alpha * hp
            z = precond(rr_n)
            rz_n = torch.sum(rr_n * z)
            beta = rz_n / torch.clamp(rz, min=1e-30)
            p_n = z + beta * p
            x = torch.where(go, x_n, x)
            rr = torch.where(go, rr_n, rr)
            p = torch.where(go, p_n, p)
            rz = torch.where(go, rz_n, rz)
            k += 1
        if k < cg_iters and not bool(torch.sum(rr * rr) > stop):
            break
    return x


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
