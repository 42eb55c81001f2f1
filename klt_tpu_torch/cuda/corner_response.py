"""Wrapper of kernel D (csrc/corner_response.cu): the min-eigenvalue
corner response of a frame's gradients.

The plain torch version is `ops.selection.corner_response_plain`.
"""

from __future__ import annotations

import torch

from . import CORNER_RESPONSE, check_cuda_tensor


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
    scratch = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        CORNER_RESPONSE(gradx.data_ptr(), grady.data_ptr(), h, w,
                        window_width, window_height, out.data_ptr(),
                        scratch.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    return out
