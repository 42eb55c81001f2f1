"""Separable convolution ops (smoothing + gradients), plain torch.

Semantics of the reference (src/V1/convolve.c:137-242), which the JAX
package keeps in klt_tpu/ops/convolve.py:

* taps are applied in reversed order (true convolution, not correlation)
  — the reference's inner loop walks taps from width-1 down to 0;
* output borders within `radius` of the edge are ZEROED, not clamped or
  zero-padded — and the vertical pass consumes the horizontally-zeroed
  intermediate, exactly like the C code;
* every output pixel accumulates its taps sequentially in f32:
  acc = x[i-r] * t[w-1], then acc = acc + x[i-r+m] * t[w-1-m].

The loop below is that accumulation, one whole-image shift-and-add per
tap, so each pixel sees the same chain of f32 roundings as the C code,
the host exact chain (ops/exact_select.py) and the pyramid kernel
(csrc/pyramid.cu).  `F.conv2d` is deliberately not used: cuDNN rounds
its operands through TF32 by default and sums in another order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import gaussian_kernels


def to_float_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 frame -> float32 image (reference: src/V1/convolve.c:37-53)."""
    return img.to(torch.float32)


def convolve_1d(img: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """One zero-bordered pass of reversed `taps` along `dim` (-1 rows,
    -2 columns) of a [..., H, W] f32 image."""
    width = len(taps)
    radius = width // 2
    n = img.shape[dim]
    out = torch.zeros_like(img)
    if n < width:
        return out
    m = n - 2 * radius
    t = [float(v) for v in np.asarray(taps, np.float32)]  # exact f32 values
    acc = img.narrow(dim, 0, m) * t[width - 1]
    for k in range(1, width):
        acc = acc + img.narrow(dim, k, m) * t[width - 1 - k]
    out.narrow(dim, radius, m).copy_(acc)
    return out


def convolve_separable(img: torch.Tensor, horiz_taps: np.ndarray,
                       vert_taps: np.ndarray) -> torch.Tensor:
    """Horizontal pass then vertical pass with zeroed borders
    (_convolveSeparate, src/V1/convolve.c:249-266)."""
    return convolve_1d(convolve_1d(img, horiz_taps, -1), vert_taps, -2)


def compute_smoothed_image(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian smooth (reference: _KLTComputeSmoothedImage,
    src/V1/convolve.c:300-314)."""
    gauss, _ = gaussian_kernels(sigma)
    return convolve_separable(img, gauss, gauss)


def compute_gradients(img: torch.Tensor, sigma: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(gradx, grady) via derivative-of-Gaussian (reference:
    _KLTComputeGradients, src/V1/convolve.c:273-293)."""
    gauss, deriv = gaussian_kernels(sigma)
    gradx = convolve_separable(img, deriv, gauss)
    grady = convolve_separable(img, gauss, deriv)
    return gradx, grady
