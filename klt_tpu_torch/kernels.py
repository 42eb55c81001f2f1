"""Truncated Gaussian / Gaussian-derivative convolution taps.

Host-side (NumPy) generation of the 1-D separable kernels used by the
smoothing, gradient, and pyramid operators.  The construction mirrors the
reference's float32 arithmetic bit-for-bit (reference: _computeKernels,
src/V1/convolve.c:60-114): taps are evaluated in f32, the width is found by
a 1% tail cutoff against the analytic maximum, and normalization divides by
a sequentially accumulated f32 sum.  Getting these taps exactly right is
what keeps the whole pipeline within sub-pixel tolerance of the CPU oracle.

Kernel widths are static Python ints; the pyramid kernel takes the taps
as launch arguments (csrc/pyramid.cu).
"""

from __future__ import annotations

import functools

import numpy as np

from .config import MAX_KERNEL_WIDTH

_TAIL_FACTOR = 0.01  # 1% tail truncation (src/V1/convolve.c:65)


@functools.lru_cache(maxsize=64)
def gaussian_kernels(sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Return (gauss, gaussderiv) float32 tap arrays for this sigma.

    Both arrays are ordered by spatial offset (index 0 = most negative
    offset), exactly as the reference stores them.  The reference's
    convolution loop applies taps in *reversed* order (true convolution);
    see ops/convolve.py for how that orientation is consumed.
    """
    f32 = np.float32
    sigma = f32(sigma)
    if sigma < 0:
        raise ValueError("sigma must be >= 0")

    hw = MAX_KERNEL_WIDTH // 2
    i = np.arange(-hw, hw + 1, dtype=np.int32)

    # t = -i*i / (2*sigma*sigma) evaluated in f32, exp() in double, cast f32.
    denom = f32(2) * sigma * sigma
    t = (-(i * i)).astype(f32) / denom
    gauss = np.exp(t.astype(np.float64)).astype(f32)
    deriv = (-i).astype(f32) * gauss

    # Width search: shrink from MAX while |tap/max| < 1% (double compare).
    max_gauss = f32(1.0)
    max_deriv = f32(float(sigma) * np.exp(-0.5))
    gw = MAX_KERNEL_WIDTH
    k = 0
    while abs(np.float64(gauss[k] / max_gauss)) < _TAIL_FACTOR:
        k += 1
        gw -= 2
    dw = MAX_KERNEL_WIDTH
    k = 0
    while abs(np.float64(deriv[k] / max_deriv)) < _TAIL_FACTOR:
        k += 1
        dw -= 2
    if gw == MAX_KERNEL_WIDTH or dw == MAX_KERNEL_WIDTH:
        raise ValueError(
            f"MAX_KERNEL_WIDTH {MAX_KERNEL_WIDTH} too small for sigma {sigma}")

    gauss = gauss[(MAX_KERNEL_WIDTH - gw) // 2:][:gw].copy()
    deriv = deriv[(MAX_KERNEL_WIDTH - dw) // 2:][:dw].copy()

    # Normalize with sequential f32 accumulation to match the oracle.
    den = f32(0.0)
    for v in gauss:
        den = den + v
    gauss = gauss / den

    dhw = dw // 2
    den = f32(0.0)
    for idx in range(-dhw, dhw + 1):
        den = den - f32(idx) * deriv[idx + dhw]
    deriv = deriv / den

    gauss.flags.writeable = False
    deriv.flags.writeable = False
    return gauss, deriv


def kernel_widths(sigma: float) -> tuple[int, int]:
    """(gauss_width, gaussderiv_width) — reference: src/V1/convolve.c:122-130."""
    g, d = gaussian_kernels(sigma)
    return len(g), len(d)
