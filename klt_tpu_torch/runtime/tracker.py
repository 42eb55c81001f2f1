"""High-level tracker runtime.

`KLTracker` is the counterpart of the reference's KLT_TrackingContext and
its entry points (KLTSelectGoodFeatures / KLTTrackFeatures,
src/V1/klt.h:150-169), bound to one torch device:

* selection runs on the host: the integer-exact response chain
  (ops/exact_select.py — the (int)-cast sort makes selection
  ulp-sensitive) and the native tie-exact sort and greedy suppression,
  mirroring the reference's CPU-side selection;
* tracking builds pyramids and runs the coarse-to-fine LK on the device;
  sequential mode keeps the previous frame's pyramids there between
  calls — the V3 lesson (src/V3/trackFeaturesGPU.cu:481-484): never
  round-trip frames through the host.

Lost-feature replacement and the affine consistency check are later
slices of the port (ROADMAP.md, queue 1, items 5 and 7).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import TrackingConfig
from ..features import FeatureList
from ..ops.exact_select import selection_response_exact
from ..ops.selection import candidate_points
from ..ops.pyramid import build_pyramid_stacks
from ..ops.lk import track_features_pyramid_stacks
from .. import native

_verbosity = 1


def set_verbosity(level: int) -> None:
    """reference: KLTSetVerbosity, src/V1/klt.c:524-528."""
    global _verbosity
    _verbosity = level


def _log(msg: str) -> None:
    if _verbosity >= 1:
        print(msg, file=sys.stderr, flush=True)


class KLTracker:
    """Stateful tracker bound to one TrackingConfig and one device."""

    def __init__(self, cfg: TrackingConfig | None = None,
                 device: str | torch.device = "cpu"):
        self.cfg = cfg or TrackingConfig()
        self.device = torch.device(device)
        self.sequential = self.cfg.sequential_mode
        self._pyr_last = None  # finest-first [3, H_l, W_l] stacks

    def select_good_features(self, img: np.ndarray, fl: FeatureList) -> None:
        """reference: KLTSelectGoodFeatures, src/V1/selectGoodFeatures.c:472.

        img: uint8 [H, W] numpy frame."""
        img = np.asarray(img)
        nrows, ncols = img.shape
        _log(f"(KLT) Selecting the {fl.n_features} best features from a "
             f"{ncols} by {nrows} image...")
        cfg = self.cfg
        response = selection_response_exact(img, cfg)
        pts = candidate_points(response, cfg, ncols, nrows)
        native.sort_points_desc(pts)
        native.min_dist_suppress(pts, fl.x, fl.y, fl.val, ncols, nrows,
                                 cfg.mindist, cfg.min_eigenvalue,
                                 overwrite_all=True)
        _log(f"\t{fl.count_remaining()} features found.")

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def track_features(self, img1: np.ndarray, img2: np.ndarray,
                       fl: FeatureList) -> None:
        """reference: KLTTrackFeatures, src/V1/trackFeatures.c:1234-1529.

        img1, img2: uint8 [H, W] numpy frames; fl is updated in place."""
        cfg = self.cfg
        if cfg.affine_consistency_check >= 0:
            raise NotImplementedError(
                "affine_consistency_check >= 0 is not ported yet "
                "(ROADMAP.md, queue 1, item 7: affine consistency check)")
        _log(f"(KLT) Tracking {fl.count_remaining()} features in a "
             f"{img2.shape[1]} by {img2.shape[0]} image...")

        if self.sequential and self._pyr_last is not None:
            pyr1 = self._pyr_last
            if tuple(pyr1[0].shape[-2:]) != tuple(img2.shape):
                raise ValueError(
                    f"incoming image {tuple(img2.shape)} differs from "
                    f"previous image {tuple(pyr1[0].shape[-2:])}")
        else:
            pyr1 = build_pyramid_stacks(self._upload(img1), cfg)
        pyr2 = build_pyramid_stacks(self._upload(img2), cfg)

        xn, yn, vn = track_features_pyramid_stacks(
            pyr1, pyr2, self._upload(fl.x), self._upload(fl.y),
            self._upload(fl.val), cfg)
        fl.x[:] = xn.cpu().numpy()
        fl.y[:] = yn.cpu().numpy()
        fl.val[:] = vn.cpu().numpy()

        if self.sequential:
            self._pyr_last = pyr2
        _log(f"\t{fl.count_remaining()} features successfully tracked.")

    def stop_sequential_mode(self) -> None:
        """reference: KLTStopSequentialMode, src/V1/klt.c:490-500."""
        self._pyr_last = None
        self.sequential = False
