"""Tracking configuration for the PyTorch KLT engine.

Mirrors the reference tracking context's tunables and derived quantities
(reference: src/V1/klt.h:41-89 struct, src/V1/klt.c:20-44 defaults,
src/V1/klt.c:288-343 pyramid derivation, src/V1/klt.c:362-431 border
derivation) as a frozen dataclass.  Field for field the same as
`klt_tpu.config.TrackingConfig`, less the TPU kernel's re-anchor knob.
"""

from __future__ import annotations

import dataclasses
import math

# Feature status codes (reference: src/V1/klt.h:28-33).
TRACKED = 0
NOT_FOUND = -1
SMALL_DET = -2
MAX_ITERATIONS = -3
OOB = -4
LARGE_RESIDUE = -5

MAX_KERNEL_WIDTH = 71  # reference: src/V1/convolve.c:16


def _odd_at_least_3(v: int) -> int:
    """Window sizes must be odd and >= 3 (reference: src/V1/klt.c:296-315)."""
    if v % 2 != 1:
        v += 1
    return max(v, 3)


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Static tracker configuration.

    Defaults match the reference's compile-time defaults
    (src/V1/klt.c:20-44).  Derived fields (n_pyramid_levels, subsampling,
    border) are computed in __post_init__ unless given explicitly.
    """

    mindist: int = 10
    window_width: int = 7
    window_height: int = 7
    sequential_mode: bool = False
    smooth_before_selecting: bool = True
    lighting_insensitive: bool = False

    min_eigenvalue: int = 1
    min_determinant: float = 0.01
    min_displacement: float = 0.1
    max_iterations: int = 10
    max_residue: float = 10.0
    grad_sigma: float = 1.0
    smooth_sigma_fact: float = 0.1
    pyramid_sigma_fact: float = 0.9
    step_factor: float = 1.0
    n_skipped_pixels: int = 0
    search_range: int = 15

    # Affine consistency check: -1 off, 0 translation, 1 similarity, 2 affine
    # (reference: src/V1/klt.h:73-78).
    affine_consistency_check: int = -1
    affine_window_width: int = 15
    affine_window_height: int = 15
    affine_max_iterations: int = 10
    affine_max_residue: float = 10.0
    affine_min_displacement: float = 0.02
    affine_max_displacement_differ: float = 1.5

    # Derived (auto-computed when <0).
    n_pyramid_levels: int = -1
    subsampling: int = -1
    borderx: int = -1
    bordery: int = -1

    def __post_init__(self):
        ww = _odd_at_least_3(self.window_width)
        wh = _odd_at_least_3(self.window_height)
        object.__setattr__(self, "window_width", ww)
        object.__setattr__(self, "window_height", wh)

        if self.n_pyramid_levels < 0 or self.subsampling < 0:
            nlev, ss = derive_pyramid(ww, wh, self.search_range)
            object.__setattr__(self, "n_pyramid_levels", nlev)
            object.__setattr__(self, "subsampling", ss)

        if self.borderx < 0 or self.bordery < 0:
            border = derive_border(self)
            object.__setattr__(self, "borderx", border)
            object.__setattr__(self, "bordery", border)

    @property
    def smooth_sigma(self) -> float:
        """sigma for pre-smoothing (reference: src/V1/klt_util.c:20-24)."""
        return self.smooth_sigma_fact * max(self.window_width,
                                            self.window_height)

    @property
    def pyramid_sigma(self) -> float:
        """sigma for inter-level smoothing (reference: src/V1/klt.c:350-354)."""
        return self.pyramid_sigma_fact * self.subsampling


def derive_pyramid(window_width: int, window_height: int,
                   search_range: int) -> tuple[int, int]:
    """Pyramid depth and subsampling from the search range.

    Reference: KLTChangeTCPyramid, src/V1/klt.c:288-343.
    """
    window_halfwidth = min(window_width, window_height) / 2.0
    ratio = float(search_range) / window_halfwidth
    if ratio < 1.0:
        return 1, 2  # subsampling unused with one level; keep a valid value
    if ratio <= 3.0:
        return 2, 2
    if ratio <= 5.0:
        return 2, 4
    if ratio <= 9.0:
        return 2, 8
    val = math.log(7.0 * ratio + 1.0) / math.log(8.0)
    return int(val + 0.99), 8


def derive_border(cfg: TrackingConfig) -> int:
    """Border inside which features are valid at level 0.

    Reference: KLTUpdateTCBorder, src/V1/klt.c:362-431 — propagates the
    per-level count of convolution-invalidated pixels back to level 0.
    """
    from .kernels import kernel_widths

    window_hw = max(cfg.window_width, cfg.window_height) // 2
    smooth_gauss_hw = kernel_widths(cfg.smooth_sigma)[0] // 2
    pyramid_gauss_hw = kernel_widths(cfg.pyramid_sigma)[0] // 2

    ss = cfg.subsampling
    n_invalid = smooth_gauss_hw
    for _ in range(1, cfg.n_pyramid_levels):
        n_invalid = int((float(n_invalid) + pyramid_gauss_hw) / ss + 0.99)

    ss_power = ss ** (cfg.n_pyramid_levels - 1)
    return (n_invalid + window_hw) * ss_power


def pyramid_shapes(ncols: int, nrows: int,
                   cfg: TrackingConfig) -> list[tuple[int, int]]:
    """(ncols, nrows) per pyramid level (reference: src/V1/pyramid.c:55-59)."""
    shapes = []
    for _ in range(cfg.n_pyramid_levels):
        shapes.append((ncols, nrows))
        ncols //= cfg.subsampling
        nrows //= cfg.subsampling
    return shapes
