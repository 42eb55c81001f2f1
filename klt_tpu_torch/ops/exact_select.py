"""Bit-exact host-side selection response.

The selection contract is integer-exact: the reference casts the
min-eigenvalue response to (int) (src/V1/selectGoodFeatures.c:421) and
sorts candidates by that integer, so a single-ulp difference in the f32
response can land on the far side of an integer boundary, flip the sort
order deep in the list and cascade into a different minimum-distance
suppression outcome.  A device response that sums in a parallel
reduction order differs from the reference's sequential order by ulps —
harmless for tracking (<= 0.5 px contract) but fatal for deep selections
(klt_tpu measured dozens of swapped/shifted picks at N=2000 on
images_laptops).

This module recomputes the response on the host with numpy, replicating
the reference's exact f32 operation ORDER (vectorised across pixels —
each pixel's accumulation chain is the same sequence of f32 rounds the C
code performs for that pixel):

* separable convolution taps accumulate k = width-1 .. 0 with the pixel
  offset running -radius .. +radius (src/V1/convolve.c:170-174,225-230),
  horizontal pass first (:249-266), borders zeroed;
* the structure tensor accumulates gx*gx / gx*gy / gy*gy per window cell
  in row-major order (src/V1/selectGoodFeatures.c:398-406) — each of the
  three accumulators is an independent sequential f32 chain;
* _minEigenvalue evaluates in the C expression's mixed precision
  (src/V1/selectGoodFeatures.c:289-292): f32 sums/products, the sqrt and
  the final subtract/divide in f64, one final round to f32.

Selection is a once-per-sequence (or per-replacement) host step in the
reference too (even the V3 GPU build links the CPU selection,
src/V3/Makefile:23-24), so exactness here costs nothing on the tracking
hot path.
"""

from __future__ import annotations

import numpy as np

from ..kernels import gaussian_kernels

_F32 = np.float32


def convolve_horiz_exact(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Horizontal pass, C accumulation order (src/V1/convolve.c:137-182).

    C sums tap index k = width-1..0 while the pixel pointer advances
    from column i-radius to i+radius: term m (m = 0..width-1) is
    pixel[i - radius + m] * taps[width-1-m], accumulated sequentially
    in f32.  Borders (radius columns each side) are zeroed.
    """
    img = np.ascontiguousarray(img, dtype=_F32)
    taps = np.asarray(taps, dtype=_F32)
    width = taps.shape[0]
    radius = width // 2
    h, w = img.shape
    out = np.zeros((h, w), _F32)
    if w < width:
        return out
    acc = img[:, 0:w - 2 * radius] * taps[width - 1]
    for m in range(1, width):
        acc = acc + img[:, m:w - 2 * radius + m] * taps[width - 1 - m]
    out[:, radius:w - radius] = acc
    return out


def convolve_vert_exact(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Vertical pass, C accumulation order (src/V1/convolve.c:189-242)."""
    img = np.ascontiguousarray(img, dtype=_F32)
    taps = np.asarray(taps, dtype=_F32)
    width = taps.shape[0]
    radius = width // 2
    h, w = img.shape
    out = np.zeros((h, w), _F32)
    if h < width:
        return out
    acc = img[0:h - 2 * radius, :] * taps[width - 1]
    for m in range(1, width):
        acc = acc + img[m:h - 2 * radius + m, :] * taps[width - 1 - m]
    out[radius:h - radius, :] = acc
    return out


def _convolve_separate_exact(img, horiz_taps, vert_taps):
    return convolve_vert_exact(convolve_horiz_exact(img, horiz_taps),
                               vert_taps)


def smoothed_image_exact(img: np.ndarray, sigma: float) -> np.ndarray:
    """_KLTComputeSmoothedImage (src/V1/convolve.c:300-314)."""
    gauss, _ = gaussian_kernels(sigma)
    return _convolve_separate_exact(img, gauss, gauss)


def gradients_exact(img: np.ndarray, sigma: float):
    """_KLTComputeGradients (src/V1/convolve.c:273-293)."""
    gauss, deriv = gaussian_kernels(sigma)
    gradx = _convolve_separate_exact(img, deriv, gauss)
    grady = _convolve_separate_exact(img, gauss, deriv)
    return gradx, grady


def corner_response_exact(gradx: np.ndarray, grady: np.ndarray,
                          window_width: int, window_height: int
                          ) -> np.ndarray:
    """Min-eigenvalue map, C semantics, valid in the window-interior
    region; outside it the map holds a large negative sentinel (the
    candidate scan never reads there).

    The reference interleaves the three accumulators per window cell
    (src/V1/selectGoodFeatures.c:398-406); since each accumulator only
    ever adds its own products, the per-accumulator f32 rounding
    sequence equals an independent row-major chain.
    """
    gx = np.ascontiguousarray(gradx, dtype=_F32)
    gy = np.ascontiguousarray(grady, dtype=_F32)
    h, w = gx.shape
    hw, hh = window_width // 2, window_height // 2
    vh, vw = h - 2 * hh, w - 2 * hw
    out = np.full((h, w), _F32(-3e38))
    if vh <= 0 or vw <= 0:
        return out
    gxx = np.zeros((vh, vw), _F32)
    gxy = np.zeros((vh, vw), _F32)
    gyy = np.zeros((vh, vw), _F32)
    for dy in range(window_height):
        for dx in range(window_width):
            a = gx[dy:dy + vh, dx:dx + vw]
            b = gy[dy:dy + vh, dx:dx + vw]
            gxx = gxx + a * a
            gxy = gxy + a * b
            gyy = gyy + b * b
    # (float)((gxx + gyy - sqrt((gxx-gyy)^2 + 4*gxy*gxy)) / 2.0f):
    # products/sums in f32, sqrt and the outer expression in f64
    # (C's sqrt() promotes), one final round to f32.
    t1 = gxx - gyy
    disc = t1 * t1 + (_F32(4.0) * gxy) * gxy
    s = np.sqrt(disc.astype(np.float64))
    tr = (gxx + gyy).astype(np.float64)
    lam = ((tr - s) / np.float64(2.0)).astype(_F32)
    # int-capacity clamp (src/V1/selectGoodFeatures.c:415-420): the C
    # comparison promotes limit=2^31-1 to f32 (== 2^31), so values in
    # [2^31-1, 2^31) pass unclamped and the later (int) cast saturates;
    # clamp to the largest f32 below 2^31 — identical ints for every
    # non-saturating value.
    lam = np.minimum(lam, _F32(2147483583.0))
    out[hh:h - hh, hw:w - hw] = lam
    return out


def selection_response_exact(img: np.ndarray, cfg) -> np.ndarray:
    """Full selection response from a uint8 frame
    (_KLTSelectGoodFeatures' preprocessing chain,
    src/V1/selectGoodFeatures.c:350-364)."""
    fi = np.asarray(img, dtype=_F32)
    if cfg.smooth_before_selecting:
        fi = smoothed_image_exact(fi, cfg.smooth_sigma)
    gradx, grady = gradients_exact(fi, cfg.grad_sigma)
    return corner_response_exact(gradx, grady, cfg.window_width,
                                 cfg.window_height)
