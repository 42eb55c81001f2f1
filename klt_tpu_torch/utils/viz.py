"""Feature visualization (PPM overlays).

reference: KLTWriteFeatureListToPPM, src/V1/writeFeatures.c:36-89 —
3x3 red squares at each live feature's rounded position over the grey
frame.
"""

from __future__ import annotations

import numpy as np

from ..features import FeatureList
from ..io.pnm import write_ppm


def feature_overlay(fl: FeatureList, grey: np.ndarray) -> np.ndarray:
    """uint8 [H, W] grey + features -> uint8 [H, W, 3] RGB overlay."""
    nrows, ncols = grey.shape
    rgb = np.repeat(grey[:, :, None], 3, axis=2).astype(np.uint8)
    live = fl.val >= 0
    xs = (fl.x[live] + 0.5).astype(np.int32)
    ys = (fl.y[live] + 0.5).astype(np.int32)
    for x, y in zip(xs, ys):
        x0, x1 = max(x - 1, 0), min(x + 1, ncols - 1)
        y0, y1 = max(y - 1, 0), min(y + 1, nrows - 1)
        rgb[y0:y1 + 1, x0:x1 + 1] = (255, 0, 0)
    return rgb


def write_feature_list_ppm(fl: FeatureList, grey: np.ndarray,
                           path: str) -> None:
    """Write fl's overlay on the grey frame as a binary PPM."""
    write_ppm(path, feature_overlay(fl, grey))
