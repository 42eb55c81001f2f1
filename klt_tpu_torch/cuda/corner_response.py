"""Wrapper of kernel D (csrc/corner_response.cu): the min-eigenvalue
corner response of a frame's gradients.

Two entries, picked by the window's size: the tiled kernel (one launch, no
scratch) for every window a shared-memory tile holds, and the two
global-memory passes through a [3, H, W] scratch for a wider one.  The
plain torch version of both is `ops.selection.corner_response_plain`.
"""

from __future__ import annotations

import functools

import torch

from . import (CORNER_RESPONSE, CORNER_RESPONSE_GLOBAL, check_cuda_tensor,
               load_library)


@functools.lru_cache(maxsize=64)
def library_tile_rows(window_width: int, window_height: int) -> int:
    """Output rows of the tiled entry's tile for this window as the
    library chooses them (before the choice of flat tiles for small maps),
    or 0: no tile holds it.  `ops.selection.response_tile_rows` is the
    same rule in Python, for the plain model of the tiling."""
    return load_library().klt_corner_response_tile(window_width,
                                                   window_height)


def corner_response_cuda(gradx: torch.Tensor, grady: torch.Tensor,
                         window_width: int, window_height: int
                         ) -> torch.Tensor:
    """f32 [H, W] CUDA gradients -> f32 [H, W] response, one kernel call."""
    check_cuda_tensor(gradx, "gradx", torch.float32, 2)
    check_cuda_tensor(grady, "grady", torch.float32, 2)
    if gradx.shape != grady.shape or gradx.device != grady.device:
        raise ValueError(f"gradx {tuple(gradx.shape)} on {gradx.device} and "
                         f"grady {tuple(grady.shape)} on {grady.device} "
                         f"differ")
    if window_width < 1 or window_height < 1:
        raise ValueError(f"window {window_width}x{window_height}")
    h, w = gradx.shape
    dev = gradx.device
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if library_tile_rows(window_width, window_height):
            CORNER_RESPONSE(gradx.data_ptr(), grady.data_ptr(), h, w,
                            window_width, window_height, out.data_ptr(),
                            stream)
        else:
            scratch = torch.empty((3, h, w), dtype=torch.float32, device=dev)
            CORNER_RESPONSE_GLOBAL(gradx.data_ptr(), grady.data_ptr(), h, w,
                                   window_width, window_height,
                                   out.data_ptr(), scratch.data_ptr(),
                                   stream)
    return out
