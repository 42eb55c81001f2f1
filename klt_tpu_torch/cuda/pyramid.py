"""Wrapper of kernel A (csrc/pyramid.cu): the whole pyramid of one frame.

The plain torch version is `ops.pyramid.build_pyramid_stacks_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import TrackingConfig, MAX_KERNEL_WIDTH, pyramid_shapes
from ..kernels import gaussian_kernels
from . import PYRAMID, check_cuda_tensor


def build_pyramid_stacks_cuda(img: torch.Tensor, cfg: TrackingConfig
                              ) -> list[torch.Tensor]:
    """uint8/f32 [H, W] CUDA frame -> finest-first list of f32
    [3, H_l, W_l] stacks (intensity, gradx, grady), one kernel call."""
    check_cuda_tensor(img, "img", (torch.uint8, torch.float32), 2)
    h, w = img.shape
    shapes = pyramid_shapes(w, h, cfg)
    if min(min(s) for s in shapes) < 1:
        raise ValueError(f"a {w}x{h} frame has an empty pyramid level "
                         f"({shapes})")
    taps = [np.ascontiguousarray(t, np.float32) for t in (
        gaussian_kernels(cfg.smooth_sigma)[0],
        *gaussian_kernels(cfg.grad_sigma),
        gaussian_kernels(cfg.pyramid_sigma)[0])]
    if max(len(t) for t in taps) > MAX_KERNEL_WIDTH:
        raise ValueError("tap width above MAX_KERNEL_WIDTH")

    dev = img.device
    outs = [torch.empty((3, r, c), dtype=torch.float32, device=dev)
            for c, r in shapes]
    scratch = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    tap_args = []
    for t in taps:
        tap_args += [t.ctypes.data, len(t)]
    with torch.cuda.device(dev):
        PYRAMID(img.data_ptr(), int(img.dtype == torch.uint8), h, w,
                cfg.n_pyramid_levels, cfg.subsampling, *tap_args,
                out_ptrs, scratch.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return outs
