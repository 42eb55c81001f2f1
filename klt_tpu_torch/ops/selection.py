"""Candidate extraction for Shi-Tomasi (min-eigenvalue) selection.

The response map comes from the host exact chain (ops/exact_select.py);
this module turns it into the reference's row-major candidate list
(src/V1/selectGoodFeatures.c:394-424), which the native host runtime
(klt_tpu_torch/native) sorts tie-exactly and thins by minimum distance.
"""

from __future__ import annotations

import numpy as np

from ..config import TrackingConfig


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
