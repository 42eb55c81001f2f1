"""Reference-exact lost-feature replacement on the device.

The counterpart of klt_tpu/ops/replace_exact.py.  The reference's picks
are decided by the integer-cast min-eigenvalue response
(src/V1/selectGoodFeatures.c:421) and its quicksort tie order (:62-96), so
a response summed in another order than C's flips integer casts and the
picks cascade away from the reference.  This module keeps C's order:

* the separable passes of the C convolution (src/V1/convolve.c:137-242):
  term m of output i is pixel[i - radius + m] * taps[width-1-m], summed
  in sequence from the first term, borders zeroed, a map narrower than
  the taps all zeros (`_conv_h_exact`, `_conv_v_exact`: the port's
  `ops/convolve.py::convolve_1d`, which already sums in that order, as
  its smoothing and gradients do);
* the window sums per cell, row-major, each starting at 0.0f
  (src/V1/selectGoodFeatures.c:398-406; 0 + (-0.0) is +0.0);
* _minEigenvalue's mixed precision (:289-292): f32 sums and products, the
  square root and the final combine in double, one round to f32; then
  min(lam, 2147483583) and -3e38 outside the window interior.  klt_tpu
  emulates the double on the TPU; the card has it, and its sqrt(double)
  is correctly rounded.

`replace_lost_features_exact` fills lost slots by the masked argmax of
the int response, which is the reference's sorted greedy walk whenever
the maximum at a pick is unique; it returns a `tie` flag when at some
pick more than one cell held the maximum, the one case the argmax cannot
decide as the reference does (runtime/pipeline.py repairs such frames on
the host with the native quicksort walk).

Wrappers: `exact_response_from_grads` is kernel H2's (csrc/exact.cu),
`replace_lost_exact_` the tie entry of kernel R's (csrc/replace.cu); each
takes its plain version below for tensors on the CPU or with plain=True.
`exact_response_tiled` writes H2's tiling out in plain torch, for the
tests: the kernel cannot run without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TrackingConfig
from .convolve import convolve_1d
from .ieee import sqrt_rn
from .replace import replace_lost_plain_

_INT_LIMIT = float(np.float32(2147483583.0))  # largest f32 below 2^31-1
_OUTSIDE = float(np.float32(-3e38))

# kernel H2's tile (kRespTileW, kRespTY of csrc/exact.cu): 32 output
# columns, 16 rows; the three product planes of a tile and its halo must
# fit a block's 227 KB of shared memory
EXACT_TILE_W, EXACT_TILE_H = 32, 16
_MAX_SHARED = 227 * 1024


def _conv_h_exact(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Horizontal pass in the C order (src/V1/convolve.c:137-182)."""
    return convolve_1d(img, taps, -1)


def _conv_v_exact(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Vertical pass in the C order (src/V1/convolve.c:189-242)."""
    return convolve_1d(img, taps, -2)


def exact_response_plain(gx: torch.Tensor, gy: torch.Tensor,
                         window_width: int, window_height: int
                         ) -> torch.Tensor:
    """Plain torch version of kernel H2, on any device: f32 [H, W]
    gradients -> f32 [H, W] response in the C order, -3e38 outside the
    window interior."""
    h, w = gx.shape
    hw, hh = window_width // 2, window_height // 2
    vh, vw = h - 2 * hh, w - 2 * hw
    out = torch.full((h, w), _OUTSIDE, dtype=torch.float32, device=gx.device)
    if vh <= 0 or vw <= 0:
        return out
    gxx = torch.zeros((vh, vw), dtype=torch.float32, device=gx.device)
    gxy = torch.zeros_like(gxx)
    gyy = torch.zeros_like(gxx)
    for dy in range(window_height):
        for dx in range(window_width):
            a = gx[dy:dy + vh, dx:dx + vw]
            b = gy[dy:dy + vh, dx:dx + vw]
            gxx = gxx + a * a
            gxy = gxy + a * b
            gyy = gyy + b * b
    out[hh:h - hh, hw:w - hw] = _min_eigenvalue_exact(gxx, gxy, gyy)
    return out


def _min_eigenvalue_exact(gxx, gxy, gyy) -> torch.Tensor:
    """_minEigenvalue's mixed precision: disc and trace in f32, the square
    root and the combine in double, one round to f32; then the clamp."""
    t1 = gxx - gyy
    disc = t1 * t1 + (4.0 * gxy) * gxy
    s = sqrt_rn(disc.to(torch.float64))
    lam = ((gxx + gyy).to(torch.float64) - s) / 2.0
    lam = lam.to(torch.float32)
    return torch.where(lam > _INT_LIMIT, _INT_LIMIT, lam)  # NaN stays NaN


def exact_response_tile(window_width: int, window_height: int) -> int:
    """Output rows of kernel H2's tile for this window, or 0 when no tile
    holds it (the rule of klt_exact_response_tile, csrc/exact.cu)."""
    if not (1 <= window_width <= 4096 and 1 <= window_height <= 4096):
        return 0
    pitch = (EXACT_TILE_W + window_width - 1) | 1
    rows = EXACT_TILE_H + window_height - 1
    return EXACT_TILE_H if 3 * rows * pitch * 4 <= _MAX_SHARED else 0


def exact_response_tiled(gx: torch.Tensor, gy: torch.Tensor,
                         window_width: int, window_height: int
                         ) -> torch.Tensor:
    """Kernel H2's tiled entry written out in plain torch, all tiles at
    once: each tile of EXACT_TILE_H x EXACT_TILE_W outputs takes the
    gradients under it and a halo of window_width - 1 columns and
    window_height - 1 rows (zeros outside the image), forms gx*gx, gx*gy,
    gy*gy once per pixel, and sums each output's window from those
    products, one row-major chain a sum from 0.0f; the eigenvalue as the
    plain version's, -3e38 outside the window interior.  Raises for a
    window no tile holds (the card takes the global-memory entry there,
    whose plain version is `exact_response_plain`)."""
    if not exact_response_tile(window_width, window_height):
        raise ValueError(f"no tile of kernel H2 holds a {window_width}x"
                         f"{window_height} window")
    h, w = gx.shape
    th, tw = EXACT_TILE_H, EXACT_TILE_W
    hw, hh = window_width // 2, window_height // 2
    ny, nx = -(-h // th), -(-w // tw)
    ih, iw = th + window_height - 1, tw + window_width - 1

    def tiles(g):  # [ny, nx, ih, iw]: image pixel (y, x) at (y + hh, x + hw)
        pad = torch.zeros((ny * th + window_height - 1,
                           nx * tw + window_width - 1), dtype=torch.float32,
                          device=g.device)
        pad[hh:hh + h, hw:hw + w] = g
        return pad.unfold(0, ih, th).unfold(1, iw, tw)

    a, b = tiles(gx), tiles(gy)
    prods = (a * a, a * b, b * b)
    sums = [torch.zeros((ny, nx, th, tw), dtype=torch.float32,
                        device=gx.device) for _ in range(3)]
    for dy in range(window_height):
        for dx in range(window_width):
            for k in range(3):
                sums[k] = sums[k] + prods[k][..., dy:dy + th, dx:dx + tw]
    lam = _min_eigenvalue_exact(*sums).permute(0, 2, 1, 3).reshape(
        ny * th, nx * tw)[:h, :w]
    out = torch.full((h, w), _OUTSIDE, dtype=torch.float32, device=gx.device)
    out[hh:h - hh, hw:w - hw] = lam[hh:h - hh, hw:w - hw]
    return out


def exact_response_from_grads(gx: torch.Tensor, gy: torch.Tensor,
                              cfg: TrackingConfig, plain: bool = False
                              ) -> torch.Tensor:
    """The exact-order response from C-order level-0 gradients (the
    sequential-mode reuse of the tracking pyramid's gradients,
    src/V1/selectGoodFeatures.c:342-348).  CUDA: one call of kernel H2.
    CPU, or plain=True: the plain version."""
    if not plain and gx.is_cuda:
        from ..cuda.exact import exact_response_cuda
        return exact_response_cuda(gx, gy, cfg.window_width,
                                   cfg.window_height)
    if not plain and gx.device.type != "cpu":
        raise ValueError(f"no exact-response path for device {gx.device}")
    return exact_response_plain(gx, gy, cfg.window_width, cfg.window_height)


def exact_response_device(frame: torch.Tensor, cfg: TrackingConfig,
                          plain: bool = False) -> torch.Tensor:
    """The exact-order selection response of a raw uint8/f32 [H, W]
    frame: smoothed with smooth_sigma when cfg.smooth_before_selecting
    (as klt_tpu does; C's replacement always takes the smoothed pyramid's
    gradients), gradients with grad_sigma, then the response.  CUDA: one
    call each of kernel A (level 0 alone) and kernel H2."""
    from .pyramid import build_pyramid_stacks, build_pyramid_stacks_plain
    st = (build_pyramid_stacks_plain if plain else build_pyramid_stacks)(
        frame, cfg, 1, cfg.smooth_before_selecting)
    return exact_response_from_grads(st[0][1], st[0][2], cfg, plain)


def replace_lost_exact_(resp: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor, val: torch.Tensor,
                        cfg: TrackingConfig, tie: torch.Tensor,
                        plain: bool = False) -> None:
    """Fill the lost slots of x, y, val in place from the f32 [H, W]
    response with klt_tpu's exact pick semantics (negative responses
    clamped to 0 before the int cast, live stamps, the masked argmax
    loop), and write 1 to the int32 `tie` (one element) when a pick's
    maximum was not unique, else 0.  CUDA: one launch of kernel R's tie
    entry, nothing read back.  CPU, or plain=True: kernel R's plain loop,
    which counts the cells of each pick's maximum."""
    if not plain and resp.is_cuda:
        from ..cuda.replace import replace_lost_tie_cuda_
        replace_lost_tie_cuda_(resp, x, y, val, cfg, tie)
        return
    if not plain and resp.device.type != "cpu":
        raise ValueError(f"no replacement path for device {resp.device}")
    clamped = torch.where(resp > 0, resp, 0.0)
    tie.fill_(int(replace_lost_plain_(clamped, x, y, val, cfg)))


def replace_lost_features_exact(frame: torch.Tensor, x: torch.Tensor,
                                y: torch.Tensor, val: torch.Tensor,
                                cfg: TrackingConfig, grads=None,
                                plain: bool = False):
    """Fill lost slots (val < 0) with the reference's exact picks; returns
    new (x, y, val) and `tie`, a bool tensor: True when the outcome
    depended on an integer tie of the response.

    frame: raw uint8/f32 [H, W]; x, y f32 [N]; val i32 [N]; grads: the
    exact level-0 (gx, gy) of the frame to reuse (the sequential-mode
    gradient reuse), else the response comes from the frame."""
    x, y, val = x.clone(), y.clone(), val.clone()
    tie = torch.zeros(1, dtype=torch.int32, device=x.device)
    if plain or not x.is_cuda:
        if not bool((val < 0).any()):  # klt_tpu's no_replace branch
            return x, y, val, tie[0].bool()
    resp = (exact_response_from_grads(*grads, cfg, plain) if grads
            is not None else exact_response_device(frame, cfg, plain))
    replace_lost_exact_(resp, x, y, val, cfg, tie, plain)
    return x, y, val, tie[0].bool()
