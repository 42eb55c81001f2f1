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
below.  Every output sums its taps in the reference C convolution's
order (ops/convolve.py), so these stacks are also the bit-exact tier's
pyramid (ops/lk_exact.py::build_pyramids_exact) and, at one level without
the pre-smoothing, its response's gradients of a frame that is not
smoothed before selecting (ops/replace_exact.py).  `build_pyramid_stacks_batched` is kernel E's: a [B, H, W] batch
of frames in one launch sequence, bit-equal per image to kernel A.
Stacks stay on the frames' device.
"""

from __future__ import annotations

import torch

from ..config import TrackingConfig, pyramid_shapes
from ..kernels import gaussian_kernels
from .convolve import compute_smoothed_image, convolve_separable


def build_pyramid(img: torch.Tensor, cfg: TrackingConfig
                  ) -> list[torch.Tensor]:
    """List of per-level float32 images, finest first: `img` itself (no
    pre-smoothing), then each coarser level the previous one smoothed
    with pyramid_sigma and decimated at [sh::s, sh::s]."""
    s = cfg.subsampling
    sh = s // 2
    shapes = pyramid_shapes(img.shape[-1], img.shape[-2], cfg)
    levels = [img]
    for lvl in range(1, cfg.n_pyramid_levels):
        sm = compute_smoothed_image(levels[-1], cfg.pyramid_sigma)
        ncols, nrows = shapes[lvl]
        levels.append(sm[..., sh::s, sh::s][..., :nrows, :ncols])
    return levels


def build_pyramid_stacks_plain(img: torch.Tensor, cfg: TrackingConfig,
                               n_levels: int | None = None,
                               smooth: bool = True) -> list[torch.Tensor]:
    """Plain torch version of kernel A, on any device: uint8/f32 [H, W]
    -> finest-first list of f32 [3, H_l, W_l] stacks, `n_levels` of them
    (default: the configuration's); level 0 is the frame itself when not
    `smooth`."""
    n_levels = cfg.n_pyramid_levels if n_levels is None else n_levels
    g_s, _ = gaussian_kernels(cfg.smooth_sigma)
    gauss, deriv = gaussian_kernels(cfg.grad_sigma)
    g_p, _ = gaussian_kernels(cfg.pyramid_sigma)
    s = cfg.subsampling
    sh = s // 2
    shapes = pyramid_shapes(img.shape[-1], img.shape[-2], cfg)

    # pre-smoothing (reference: src/V1/trackFeatures.c:1296-1308)
    level = img.to(torch.float32)
    if smooth:
        level = convolve_separable(level, g_s, g_s)
    stacks = []
    for lvl in range(n_levels):
        gradx = convolve_separable(level, deriv, gauss)
        grady = convolve_separable(level, gauss, deriv)
        stacks.append(torch.stack([level, gradx, grady]))
        if lvl < n_levels - 1:
            sm = convolve_separable(level, g_p, g_p)
            ncols, nrows = shapes[lvl + 1]
            level = sm[sh::s, sh::s][:nrows, :ncols].contiguous()
    return stacks


def build_pyramid_stacks(img: torch.Tensor, cfg: TrackingConfig,
                         n_levels: int | None = None, smooth: bool = True,
                         out: list | None = None) -> list[torch.Tensor]:
    """Finest-first [3, H_l, W_l] stacks of a uint8/f32 [H, W] frame
    (contract of `build_pyramid_stacks_plain`), written into `out`'s
    stacks when given (which are returned).  CUDA: one call of the
    pyramid kernel.  CPU: the plain version."""
    if img.device.type == "cuda":
        from ..cuda.pyramid import build_pyramid_stacks_cuda
        return build_pyramid_stacks_cuda(img, cfg, n_levels, smooth, out)
    if img.device.type != "cpu":
        raise ValueError(f"no pyramid path for device {img.device}")
    stacks = build_pyramid_stacks_plain(img, cfg, n_levels, smooth)
    if out is None:
        return stacks
    if [tuple(o.shape) for o in out] != [tuple(s.shape) for s in stacks]:
        raise ValueError(f"out's stacks {[tuple(o.shape) for o in out]} "
                         f"differ from the pyramid's "
                         f"{[tuple(s.shape) for s in stacks]}")
    for o, s in zip(out, stacks):
        o.copy_(s)
    return list(out)


def build_pyramid_stacks_batched_plain(imgs: torch.Tensor,
                                      cfg: TrackingConfig
                                      ) -> list[torch.Tensor]:
    """Plain torch version of kernel E, on any device: uint8/f32
    [B, H, W] -> finest-first list of f32 [B, 3, H_l, W_l] stacks."""
    per_image = [build_pyramid_stacks_plain(im, cfg) for im in imgs]
    return [torch.stack([st[lvl] for st in per_image])
            for lvl in range(cfg.n_pyramid_levels)]


def build_pyramid_stacks_batched(imgs: torch.Tensor, cfg: TrackingConfig
                                 ) -> list[torch.Tensor]:
    """Finest-first [B, 3, H_l, W_l] stacks of uint8/f32 [B, H, W]
    frames.  CUDA: one call of the batched pyramid kernel.  CPU: the
    plain version."""
    if imgs.device.type == "cuda":
        from ..cuda.pyramid import build_pyramid_stacks_batched_cuda
        return build_pyramid_stacks_batched_cuda(imgs, cfg)
    if imgs.device.type != "cpu":
        raise ValueError(f"no pyramid path for device {imgs.device}")
    return build_pyramid_stacks_batched_plain(imgs, cfg)


def build_image_pyramids(img: torch.Tensor, cfg: TrackingConfig):
    """(pyr, gradx, grady) finest-first lists of [H_l, W_l] maps."""
    stacks = build_pyramid_stacks(img, cfg)
    return ([s[0] for s in stacks], [s[1] for s in stacks],
            [s[2] for s in stacks])
