"""Kernel C's pyramid entry (`klt_lk_pyramid_batched`, the
`lk_pyramid_batched_kernel` launch): one launch tracks a frame pair of B
sequences at once, each lane in its own sequence's pyramids, with the
per-lane work of kernel B's entry (rooflines/klt_lk_pyramid.py)."""

from __future__ import annotations

from benchmark.reference import klt
from benchmark.rooflines import klt_lk_pyramid

KERNELS = ("lk_pyramid_batched_kernel",)


def work(stats: list, n_lanes: int, shapes: list, cfg: klt.Config,
         sequences: int) -> tuple[float, float]:
    """(bytes, flops) of one launch over `sequences` sequences of n_lanes
    lanes each, every sequence counted as the one whose frame pair the
    reference followed (stats: its (level, lanes in the loop, iterations)
    per level; shapes: each level's (cols, rows))."""
    n_bytes, n_flops = klt_lk_pyramid.work(stats, n_lanes, shapes, cfg)
    return sequences * n_bytes, sequences * n_flops
