"""Debug dumps and config printing.

Equivalents of the reference's observability helpers:
* `print_tracking_config`  — KLTPrintTrackingContext (src/V1/klt.c:243-280)
* `write_internal_images`  — the `tc->writeInternalImages` PGM dumps of
  every pyramid / gradient level (src/V1/trackFeatures.c:1323-1340,
  src/V1/selectGoodFeatures.c:366-371)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import TrackingConfig
from ..io.pnm import write_pgm


def print_tracking_config(cfg: TrackingConfig, file=None) -> None:
    """Dump every tunable + derived field, mirroring the field order of
    KLTPrintTrackingContext (src/V1/klt.c:243-280)."""
    f = file or sys.stderr
    w = lambda s: print(s, file=f)
    w("\n\nTracking context:\n")
    w(f"\tmindist = {cfg.mindist}")
    w(f"\twindow_width = {cfg.window_width}")
    w(f"\twindow_height = {cfg.window_height}")
    w(f"\tsequentialMode = {cfg.sequential_mode}")
    w(f"\tsmoothBeforeSelecting = {cfg.smooth_before_selecting}")
    w(f"\tlighting_insensitive = {cfg.lighting_insensitive}")
    w(f"\tmin_eigenvalue = {cfg.min_eigenvalue}")
    w(f"\tmin_determinant = {cfg.min_determinant:g}")
    w(f"\tmin_displacement = {cfg.min_displacement:g}")
    w(f"\tmax_iterations = {cfg.max_iterations}")
    w(f"\tmax_residue = {cfg.max_residue:g}")
    w(f"\tgrad_sigma = {cfg.grad_sigma:g}")
    w(f"\tsmooth_sigma_fact = {cfg.smooth_sigma_fact:g}")
    w(f"\tpyramid_sigma_fact = {cfg.pyramid_sigma_fact:g}")
    w(f"\tnSkippedPixels = {cfg.n_skipped_pixels}")
    w(f"\taffineConsistencyCheck = {cfg.affine_consistency_check}")
    w(f"\taffine_window_width = {cfg.affine_window_width}")
    w(f"\taffine_window_height = {cfg.affine_window_height}")
    w(f"\taffine_max_iterations = {cfg.affine_max_iterations}")
    w(f"\taffine_max_residue = {cfg.affine_max_residue:g}")
    w(f"\taffine_min_displacement = {cfg.affine_min_displacement:g}")
    w("\taffine_max_displacement_differ = "
      f"{cfg.affine_max_displacement_differ:g}")
    w(f"\tnPyramidLevels = {cfg.n_pyramid_levels}")
    w(f"\tsubsampling = {cfg.subsampling}")
    w(f"\tborderx = {cfg.borderx}")
    w(f"\tbordery = {cfg.bordery}")


def _float_to_pgm_u8(img) -> np.ndarray:
    """Min/max normalize to 0..255 like _KLTWriteFloatImageToPGM
    (src/V1/klt_util.c:95-129), on the host in f32."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float32)
    mn, mx = float(img.min()), float(img.max())
    scale = 255.0 / (mx - mn) if mx != mn else 1.0
    return ((img - mn) * scale).astype(np.uint8)


def write_internal_images(pyr, gradx, grady, prefix: str = "klt_debug",
                          tag: str = "1") -> list[str]:
    """Dump every pyramid/gradient level as normalized PGM files.

    pyr, gradx, grady: finest-first sequences of [H_l, W_l] maps, numpy
    arrays or tensors on any device (for stacks: [s[0] for s in stacks],
    and so on).  Mirrors the reference's writeInternalImages naming:
    {prefix}_i{tag}{"", _gx, _gy}_l{level}.pgm
    (src/V1/trackFeatures.c:1323-1340).  Returns the written paths."""
    paths = []
    for lvl, (p, gx, gy) in enumerate(zip(pyr, gradx, grady)):
        for suffix, img in (("", p), ("_gx", gx), ("_gy", gy)):
            fname = f"{prefix}_i{tag}{suffix}_l{lvl}.pgm"
            write_pgm(fname, _float_to_pgm_u8(img))
            paths.append(fname)
    return paths
