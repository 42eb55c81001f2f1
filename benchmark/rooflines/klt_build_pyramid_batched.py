"""Kernel E (`klt_build_pyramid_batched`, the batched entry of
csrc/pyramid.cu, whose launches carry the names of kernel A's): B frames'
pyramids in one launch a step, each the bytes and operations of one
frame's pyramid (rooflines/klt_build_pyramid.py)."""

from __future__ import annotations

from benchmark.reference import klt
from benchmark.rooflines import klt_build_pyramid

KERNELS = klt_build_pyramid.KERNELS


def work(width: int, height: int, cfg: klt.Config, frames: int
         ) -> tuple[float, float]:
    """(bytes, flops) of the pyramids of `frames` u8 frames of width x
    height."""
    n_bytes, n_flops = klt_build_pyramid.work(width, height, cfg)
    return frames * n_bytes, frames * n_flops
