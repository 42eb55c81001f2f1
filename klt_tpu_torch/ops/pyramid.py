"""Gaussian pyramid construction.

Reference semantics (_KLTComputePyramid, src/V1/pyramid.c:87-131): level 0
is the pre-smoothed input; each coarser level smooths the previous level
with sigma = subsampling * pyramid_sigma_fact and decimates with stride
`subsampling` at offset `subsampling // 2`.  Level dims shrink by integer
division.  Every level carries its gradients (grad_sigma), stacked as
[3, H_l, W_l] (intensity, gradx, grady), finest first — the layout the
LK level loop reads.

`build_pyramid_stacks` is kernel A's wrapper: a CUDA frame goes to the
pyramid kernel (csrc/pyramid.cu), a CPU frame to the plain version
below.  Stacks stay on the frame's device.
"""

from __future__ import annotations

import torch

from ..config import TrackingConfig, pyramid_shapes
from ..kernels import gaussian_kernels
from .convolve import convolve_separable


def build_pyramid_stacks_plain(img: torch.Tensor, cfg: TrackingConfig
                               ) -> list[torch.Tensor]:
    """Plain torch version of kernel A, on any device: uint8/f32 [H, W]
    -> finest-first list of f32 [3, H_l, W_l] stacks."""
    g_s, _ = gaussian_kernels(cfg.smooth_sigma)
    gauss, deriv = gaussian_kernels(cfg.grad_sigma)
    g_p, _ = gaussian_kernels(cfg.pyramid_sigma)
    s = cfg.subsampling
    sh = s // 2
    shapes = pyramid_shapes(img.shape[-1], img.shape[-2], cfg)

    # pre-smoothing (reference: src/V1/trackFeatures.c:1296-1308)
    level = convolve_separable(img.to(torch.float32), g_s, g_s)
    stacks = []
    for lvl in range(cfg.n_pyramid_levels):
        gradx = convolve_separable(level, deriv, gauss)
        grady = convolve_separable(level, gauss, deriv)
        stacks.append(torch.stack([level, gradx, grady]))
        if lvl < cfg.n_pyramid_levels - 1:
            sm = convolve_separable(level, g_p, g_p)
            ncols, nrows = shapes[lvl + 1]
            level = sm[sh::s, sh::s][:nrows, :ncols].contiguous()
    return stacks


def build_pyramid_stacks(img: torch.Tensor, cfg: TrackingConfig
                         ) -> list[torch.Tensor]:
    """Finest-first [3, H_l, W_l] stacks of a uint8/f32 [H, W] frame.
    CUDA: one call of the pyramid kernel.  CPU: the plain version."""
    if img.device.type == "cuda":
        from ..cuda.pyramid import build_pyramid_stacks_cuda
        return build_pyramid_stacks_cuda(img, cfg)
    if img.device.type != "cpu":
        raise ValueError(f"no pyramid path for device {img.device}")
    return build_pyramid_stacks_plain(img, cfg)


def build_image_pyramids(img: torch.Tensor, cfg: TrackingConfig):
    """(pyr, gradx, grady) finest-first lists of [H_l, W_l] maps."""
    stacks = build_pyramid_stacks(img, cfg)
    return ([s[0] for s in stacks], [s[1] for s in stacks],
            [s[2] for s in stacks])
