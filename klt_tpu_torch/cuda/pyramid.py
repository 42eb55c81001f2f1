"""Wrappers of kernels A and E (csrc/pyramid.cu): the whole pyramid of one
frame, and of a batch of frames in one launch sequence.

The plain torch versions are `ops.pyramid.build_pyramid_stacks_plain` and
`ops.pyramid.build_pyramid_stacks_batched_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import TrackingConfig, MAX_KERNEL_WIDTH, pyramid_shapes
from ..kernels import gaussian_kernels
from . import PYRAMID, PYRAMID_BATCHED, check_cuda_tensor, load_library


# The pre-smoothing of a frame that is not smoothed: one tap of 1.0, whose
# passes give every pixel's own value (x * 1.0f is x, to the bit).
_IDENTITY = np.ones(1, np.float32)


def _shapes_and_taps(h: int, w: int, cfg: TrackingConfig,
                     n_levels: int | None = None, smooth: bool = True):
    n_levels = cfg.n_pyramid_levels if n_levels is None else n_levels
    shapes = pyramid_shapes(w, h, cfg)[:n_levels]
    if n_levels < 1 or len(shapes) < n_levels or \
            min(min(s) for s in shapes) < 1:
        raise ValueError(f"a {w}x{h} frame has no {n_levels} non-empty "
                         f"pyramid levels ({shapes})")
    taps = [np.ascontiguousarray(t, np.float32) for t in (
        gaussian_kernels(cfg.smooth_sigma)[0] if smooth else _IDENTITY,
        *gaussian_kernels(cfg.grad_sigma),
        gaussian_kernels(cfg.pyramid_sigma)[0])]
    if max(len(t) for t in taps) > MAX_KERNEL_WIDTH:
        raise ValueError("tap width above MAX_KERNEL_WIDTH")
    tap_args = []
    for t in taps:
        tap_args += [t.ctypes.data, len(t)]
    # the numpy arrays must outlive the call that reads their pointers
    return shapes, taps, tap_args


@functools.lru_cache(maxsize=None)
def _needs_scratch(n_levels: int, subsampling: int, n_pyr: int) -> bool:
    return bool(load_library().klt_pyramid_needs_scratch(
        n_levels, subsampling, n_pyr))


def _scratch(shape, n_levels: int, subsampling: int, n_pyr: int, dev):
    """The one-plane scratch of the global-memory decimation, for the few
    configurations whose pyramid smoothing fits no tile; else None."""
    if _needs_scratch(n_levels, subsampling, n_pyr):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return None


def build_pyramid_stacks_cuda(img: torch.Tensor, cfg: TrackingConfig,
                              n_levels: int | None = None,
                              smooth: bool = True,
                              out: list | None = None) -> list[torch.Tensor]:
    """uint8/f32 [H, W] CUDA frame -> finest-first list of f32
    [3, H_l, W_l] stacks (intensity, gradx, grady), `n_levels` of them
    (default: the configuration's), one kernel call; level 0 is the frame
    itself when not `smooth`.  out: the stacks to write (returned), else
    new ones."""
    check_cuda_tensor(img, "img", (torch.uint8, torch.float32), 2)
    h, w = img.shape
    shapes, taps, tap_args = _shapes_and_taps(h, w, cfg, n_levels, smooth)
    dev = img.device
    if out is None:
        outs = [torch.empty((3, r, c), dtype=torch.float32, device=dev)
                for c, r in shapes]
    else:
        outs = list(out)
        if len(outs) != len(shapes):
            raise ValueError(f"out holds {len(outs)} stacks, the pyramid "
                             f"{len(shapes)}")
        for lvl, (o, (c, r)) in enumerate(zip(outs, shapes)):
            check_cuda_tensor(o, f"out[{lvl}]", torch.float32, 3)
            if tuple(o.shape) != (3, r, c) or o.device != dev:
                raise ValueError(f"out[{lvl}] must be [3, {r}, {c}] on "
                                 f"{dev}, got {tuple(o.shape)} on "
                                 f"{o.device}")
    scratch = _scratch((h, w), len(shapes), cfg.subsampling, len(taps[3]),
                       dev)
    out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        PYRAMID(img.data_ptr(), int(img.dtype == torch.uint8), h, w,
                len(shapes), cfg.subsampling, *tap_args,
                out_ptrs, None if scratch is None else scratch.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return outs


# The most frames of one call; the grid's x dimension holds every image's
# tiles, far below its limit at this many.
MAX_BATCH = 65535 // 3


def build_pyramid_stacks_batched_cuda(imgs: torch.Tensor, cfg: TrackingConfig
                                      ) -> list[torch.Tensor]:
    """uint8/f32 [B, H, W] CUDA frames -> finest-first list of f32
    [B, 3, H_l, W_l] stacks, one kernel call; each image's stacks are
    bit-equal to kernel A's.  Memory grows with B: the caller chunks."""
    check_cuda_tensor(imgs, "imgs", (torch.uint8, torch.float32), 3)
    b, h, w = imgs.shape
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} frames; kernel E takes 1 to "
                         f"{MAX_BATCH}")
    shapes, taps, tap_args = _shapes_and_taps(h, w, cfg)
    dev = imgs.device
    outs = [torch.empty((b, 3, r, c), dtype=torch.float32, device=dev)
            for c, r in shapes]
    scratch = _scratch((b, h, w), len(shapes), cfg.subsampling, len(taps[3]),
                       dev)
    out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        PYRAMID_BATCHED(imgs.data_ptr(), int(imgs.dtype == torch.uint8), b,
                        h, w, cfg.n_pyramid_levels, cfg.subsampling,
                        *tap_args, out_ptrs,
                        None if scratch is None else scratch.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    return outs
