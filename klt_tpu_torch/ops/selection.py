"""Shi-Tomasi (min-eigenvalue) corner response and candidate extraction.

`corner_response` is kernel D's wrapper: CUDA gradients go to the
corner-response kernel (csrc/corner_response.cu; `corner_response_tiled`
is its tiling written out in plain torch), CPU gradients to
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


# The tiling of csrc/corner_response.cu (kTileW, kTall, kFlat, kMinBlocks,
# kDefaultShared, kMaxShared there).
_TILE_W, _TALL, _FLAT, _MIN_BLOCKS = 32, 32, 8, 264
_DEFAULT_SHARED, _MAX_SHARED = 48 * 1024, 227 * 1024


def response_tile_rows(window_width: int, window_height: int,
                       rows: int, cols: int) -> int:
    """Output rows of a tile of kernel D's tiled entry on a [rows, cols]
    map: 32 (tall) when its shared memory leaves room for several blocks
    on an SM and the map has enough tiles to fill the card, else 8
    (flat), or 0 when no tile holds the window (the global-memory
    entry)."""
    def shared(th):
        pitch = (_TILE_W + window_width - 1) | 1
        return 3 * (th + window_height - 1) * (pitch + _TILE_W + 1) * 4

    if shared(_TALL) <= _DEFAULT_SHARED:
        tiles = -(-cols // _TILE_W) * -(-rows // _TALL)
        return _TALL if tiles >= _MIN_BLOCKS else _FLAT
    return _FLAT if shared(_FLAT) <= _MAX_SHARED else 0


def corner_response_tiled(gradx: torch.Tensor, grady: torch.Tensor,
                          window_width: int, window_height: int):
    """Kernel D's tiled entry written out in plain torch, tile by tile as
    a block runs it: the crop of both gradients with a halo of
    window_width - 1 columns and window_height - 1 rows (pixels outside
    the map are zeros, which feed only zeroed outputs), the three products
    once per pixel, their horizontal sums on every row of the crop, the
    vertical sums of those and the eigenvalue; each sum in sequence from
    the first term, zeroing by global coordinates.  Returns the [H, W]
    response, bit-equal to `corner_response_plain`, or None when no tile
    holds the window."""
    rows, cols = gradx.shape
    ww, wh = window_width, window_height
    th = response_tile_rows(ww, wh, rows, cols)
    if th == 0:
        return None
    rx, ry = ww // 2, wh // 2
    ih, iw = th + wh - 1, _TILE_W + ww - 1
    out = torch.full((rows, cols), float("nan"), device=gradx.device)
    zero = torch.zeros((), device=gradx.device)
    ar_x = torch.arange(_TILE_W, device=gradx.device)
    ar_y = torch.arange(th, device=gradx.device)
    for i0 in range(0, rows, th):
        for j0 in range(0, cols, _TILE_W):
            gy0, gx0 = i0 - ry, j0 - rx
            crops = []
            for g in (gradx, grady):
                crop = torch.zeros((ih, iw), device=gradx.device)
                ys = slice(max(gy0, 0), min(gy0 + ih, rows))
                xs = slice(max(gx0, 0), min(gx0 + iw, cols))
                if ys.start < ys.stop and xs.start < xs.stop:
                    crop[ys.start - gy0:ys.stop - gy0,
                         xs.start - gx0:xs.stop - gx0] = g[ys, xs]
                crops.append(crop)
            cx, cy = crops
            x_in = ((j0 + ar_x >= rx) & (j0 + ar_x < cols - rx))[None, :]
            y_in = ((i0 + ar_y >= ry) & (i0 + ar_y < rows - ry))[:, None]
            sums = []
            for prod in (cx * cx, cx * cy, cy * cy):
                mid = prod[:, 0:_TILE_W]
                for m in range(1, ww):
                    mid = mid + prod[:, m:m + _TILE_W]
                mid = torch.where(x_in, mid, zero)
                acc = mid[0:th]
                for m in range(1, wh):
                    acc = acc + mid[m:m + th]
                sums.append(torch.where(y_in, acc, zero))
            gxx, gxy, gyy = sums
            lam = (gxx + gyy - sqrt_rn((gxx - gyy) * (gxx - gyy) +
                                       4.0 * gxy * gxy)) / 2.0
            n_i, n_j = min(th, rows - i0), min(_TILE_W, cols - j0)
            out[i0:i0 + n_i, j0:j0 + n_j] = \
                torch.clamp(lam, max=_INT_LIMIT)[:n_i, :n_j]
    return out


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
