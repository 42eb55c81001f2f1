"""Shi-Tomasi (min-eigenvalue) corner response and candidate extraction.

`corner_response` is kernel D's wrapper: CUDA gradients go to the
corner-response kernel (csrc/corner_response.cu), CPU gradients to
`corner_response_plain`, the dense structure-tensor scan of the reference
(src/V1/selectGoodFeatures.c:394-424) as two separable box filters over
the gradient products.  Both follow klt_tpu's Pallas kernel
(pallas/selection.py) and zero the box filter's borders; klt_tpu's XLA
path zero-pads instead, which differs only outside the candidate region.

`candidate_points` turns a response map into the reference's row-major
candidate list (src/V1/selectGoodFeatures.c:394-424), which the native
host runtime (klt_tpu_torch/native) sorts tie-exactly and thins by
minimum distance.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TrackingConfig
from .convolve import convolve_1d
from .ieee import sqrt_rn

# int-capacity clamp (src/V1/selectGoodFeatures.c:415-420): the largest
# f32 below 2^31 - 1
_INT_LIMIT = float(np.float32(2147483583.0))


def corner_response_plain(gradx: torch.Tensor, grady: torch.Tensor,
                          window_width: int, window_height: int
                          ) -> torch.Tensor:
    """Plain torch version of kernel D, on any device: f32 [H, W]
    gradients -> f32 [H, W] min-eigenvalue map, zero where the window
    leaves the frame."""
    ones_w = np.ones(window_width, np.float32)
    ones_h = np.ones(window_height, np.float32)

    def box(img):
        return convolve_1d(convolve_1d(img, ones_w, -1), ones_h, -2)

    gxx = box(gradx * gradx)
    gxy = box(gradx * grady)
    gyy = box(grady * grady)
    # reference: _minEigenvalue, src/V1/selectGoodFeatures.c:289-292
    lam = (gxx + gyy -
           sqrt_rn((gxx - gyy) * (gxx - gyy) + 4.0 * gxy * gxy)) / 2.0
    return torch.clamp(lam, max=_INT_LIMIT)


def corner_response(gradx: torch.Tensor, grady: torch.Tensor,
                    window_width: int, window_height: int) -> torch.Tensor:
    """Min-eigenvalue map of the windowed structure tensor.  CUDA: one
    call of the corner-response kernel.  CPU: the plain version."""
    if gradx.device.type == "cuda":
        from ..cuda.corner_response import corner_response_cuda
        return corner_response_cuda(gradx, grady, window_width,
                                    window_height)
    if gradx.device.type != "cpu":
        raise ValueError(f"no corner-response path for device "
                         f"{gradx.device}")
    return corner_response_plain(gradx, grady, window_width, window_height)


def _candidate_borders(cfg: TrackingConfig):
    window_hw = cfg.window_width // 2
    window_hh = cfg.window_height // 2
    return (max(cfg.borderx, window_hw), max(cfg.bordery, window_hh),
            cfg.n_skipped_pixels + 1)


def candidate_points(response: np.ndarray, cfg: TrackingConfig,
                     ncols: int, nrows: int) -> np.ndarray:
    """Host-side pointlist [(x, y, int(val)), ...] in the reference's
    row-major scan order (src/V1/selectGoodFeatures.c:394-424).

    Returns int32 [n, 3].  Truncation toward zero matches the C cast.
    """
    borderx, bordery, step = _candidate_borders(cfg)

    ys = np.arange(bordery, nrows - bordery, step, dtype=np.int32)
    xs = np.arange(borderx, ncols - borderx, step, dtype=np.int32)
    vals = np.asarray(response)[np.ix_(ys, xs)].astype(np.int32)  # trunc

    gx, gy = np.meshgrid(xs, ys)
    pts = np.empty((vals.size, 3), dtype=np.int32)
    pts[:, 0] = gx.ravel()
    pts[:, 1] = gy.ravel()
    pts[:, 2] = vals.ravel()
    return pts
