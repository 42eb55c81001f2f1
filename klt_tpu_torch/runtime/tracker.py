"""High-level tracker runtime.

`KLTracker` is the counterpart of the reference's KLT_TrackingContext and
its entry points (KLTSelectGoodFeatures / KLTTrackFeatures /
KLTReplaceLostFeatures, src/V1/klt.h:150-169), bound to one torch device:

* selection and replacement take a response map from one of three
  sources, then the native tie-exact sort and greedy suppression on the
  host, mirroring the reference's CPU-side selection:
  - replacement in sequential mode: the corner response (kernel D on a
    CUDA device) of the cached pyramid's level-0 gradients, as the
    reference reuses tc->pyramid_last (src/V1/selectGoodFeatures.c:342);
  - by default: the integer-exact host chain (ops/exact_select.py — the
    (int)-cast sort makes selection ulp-sensitive);
  - with KLT_TPU_EXACT_SELECT=0 (the switch klt_tpu reads): the corner
    response of the frame's gradients on the device;
  with prefilter=True the candidates are first cut to the best few of
  each (mindist x mindist) cell on the response's device
  (ops/selection.py::candidate_points_topk), so that a response on the
  card comes back as O(k * nCells) values instead of the whole map; the
  full list is taken whenever the exactness audit cannot certify the cut;
* tracking builds pyramids and runs the coarse-to-fine LK on the device;
  sequential mode keeps the previous frame's pyramids there between
  calls — the V3 lesson (src/V3/trackFeaturesGPU.cu:481-484): never
  round-trip frames through the host.

* with affine_consistency_check >= 0 every tracked feature is then
  verified against the reference patch saved at its first successful
  track (ops/affine.py) and killed when it drifted; selection and
  replacement reset the patches of the slots they fill.
  lighting_insensitive with the affine check is a valid combination: the
  reference's affine stage has no gain or bias terms
  (src/V1/trackFeatures.c:952-1220), the translation stage keeps them.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ..config import TrackingConfig
from ..device import default_device
from ..features import FeatureList
from ..ops.convolve import compute_gradients
from ..ops.exact_select import selection_response_exact
from ..ops.selection import (candidate_points, candidate_points_topk,
                             corner_response, selection_prefilter_audit)
from ..ops.pyramid import build_pyramid_stacks
from ..ops.lk import track_features_pyramid_stacks
from ..ops.affine import AffineState, affine_consistency_step
from .. import native

_verbosity = 1


def _exact_select_enabled() -> bool:
    """Integer-exact host selection response (default on);
    KLT_TPU_EXACT_SELECT=0 takes the device response instead, as in
    klt_tpu."""
    return os.environ.get("KLT_TPU_EXACT_SELECT", "1") != "0"


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
                 device: str | torch.device | None = None,
                 prefilter: bool = False):
        """device None is the card ("cuda"), and raises without one; the
        CPU is taken only when the caller names it (device="cpu").
        prefilter=True selects from the per-cell prefiltered candidate
        list where the audit certifies it (klt_tpu's KLT_TPU_PREFILTER=1);
        the selected features are the same either way."""
        self.cfg = cfg or TrackingConfig()
        self.device = default_device(device)
        self.prefilter = prefilter
        self.sequential = self.cfg.sequential_mode
        self._pyr_last = None  # finest-first [3, H_l, W_l] stacks
        self._affine = None    # AffineState, made at the first track

    def select_good_features(self, img: np.ndarray, fl: FeatureList) -> None:
        """reference: KLTSelectGoodFeatures, src/V1/selectGoodFeatures.c:472.

        img: uint8 [H, W] numpy frame."""
        img = np.asarray(img)
        _log(f"(KLT) Selecting the {fl.n_features} best features from a "
             f"{img.shape[1]} by {img.shape[0]} image...")
        self._select(img, fl, overwrite_all=True)
        _log(f"\t{fl.count_remaining()} features found.")

    def replace_lost_features(self, img: np.ndarray, fl: FeatureList) -> None:
        """reference: KLTReplaceLostFeatures,
        src/V1/selectGoodFeatures.c:514-541.

        img: uint8 [H, W] numpy frame (the one just tracked into); the lost
        slots of fl are refilled in place or become NOT_FOUND."""
        n_lost = fl.n_features - fl.count_remaining()
        _log(f"(KLT) Attempting to replace {n_lost} features...")
        if n_lost > 0:
            self._select(np.asarray(img), fl, overwrite_all=False)

    def _select(self, img: np.ndarray, fl: FeatureList,
                overwrite_all: bool) -> None:
        nrows, ncols = img.shape
        cfg = self.cfg
        if (not overwrite_all and self.sequential
                and self._pyr_last is not None):
            # replacement in sequential mode reuses the cached pyramid's
            # level-0 gradients (src/V1/selectGoodFeatures.c:342-348)
            lvl0 = self._pyr_last[0]
            response = corner_response(lvl0[1], lvl0[2], cfg.window_width,
                                       cfg.window_height)
        elif _exact_select_enabled():
            response = selection_response_exact(img, cfg)
        else:
            response = self._device_response(img)
        newly = None if overwrite_all else (fl.val < 0)
        if not self._suppress_prefiltered(response, fl, ncols, nrows,
                                          overwrite_all):
            if isinstance(response, torch.Tensor):
                response = response.cpu().numpy()
            pts = candidate_points(response, cfg, ncols, nrows)
            native.sort_points_desc(pts)
            native.min_dist_suppress(pts, fl.x, fl.y, fl.val, ncols, nrows,
                                     cfg.mindist, cfg.min_eigenvalue,
                                     overwrite_all)
        # reset the affine reference patches of (re)selected slots
        if cfg.affine_consistency_check >= 0 and self._affine is not None:
            reset = np.ones(fl.n_features, bool) if overwrite_all else newly
            self._affine.invalidate(np.nonzero(reset)[0])

    def _suppress_prefiltered(self, response, fl: FeatureList, ncols: int,
                              nrows: int, overwrite_all: bool) -> bool:
        """Sort and suppression on the prefiltered candidate list; True
        when the exactness audit certifies that it selected what the full
        list would.  Otherwise (and without prefilter, or with mindist
        under 2) returns False with the feature list as it was, and the
        caller takes the full list.  Reference contract:
        src/V1/selectGoodFeatures.c:135-239."""
        cfg = self.cfg
        if not self.prefilter or cfg.mindist < 2:
            return False
        pts, dropped_cells = candidate_points_topk(response, cfg, ncols,
                                                   nrows)
        save = (fl.x.copy(), fl.y.copy(), fl.val.copy())
        native.sort_points_desc(pts)
        native.min_dist_suppress(pts, fl.x, fl.y, fl.val, ncols, nrows,
                                 cfg.mindist, cfg.min_eigenvalue,
                                 overwrite_all)
        target = np.ones(fl.n_features, bool) if overwrite_all \
            else (save[2] < 0)
        added = target & (fl.val >= 0)  # every target slot now filled
        n_unfilled = int((target & (fl.val < 0)).sum())
        exist = np.zeros(fl.n_features, bool) if overwrite_all \
            else (save[2] >= 0)
        ok = selection_prefilter_audit(
            pts, dropped_cells, fl.val[added],
            fl.x[added].astype(np.int32), fl.y[added].astype(np.int32),
            save[0][exist].astype(np.int32), save[1][exist].astype(np.int32),
            n_unfilled, cfg)
        if not ok:
            fl.x[:], fl.y[:], fl.val[:] = save
        return ok

    def _device_response(self, img: np.ndarray) -> torch.Tensor:
        """The selection response computed on the tracker's device: the
        smoothed frame's gradients (kernel A's level 0 with one pyramid
        level: the smoothing and gradient chain of _KLTSelectGoodFeatures,
        src/V1/selectGoodFeatures.c:350-364), then kernel D."""
        cfg = self.cfg
        frame = self._upload(img)
        if cfg.smooth_before_selecting:
            one_level = dataclasses.replace(cfg, n_pyramid_levels=1)
            _, gx, gy = build_pyramid_stacks(frame, one_level)[0]
        else:
            gx, gy = compute_gradients(frame.to(torch.float32),
                                       cfg.grad_sigma)
        return corner_response(gx, gy, cfg.window_width, cfg.window_height)

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def track_features(self, img1: np.ndarray, img2: np.ndarray,
                       fl: FeatureList) -> None:
        """reference: KLTTrackFeatures, src/V1/trackFeatures.c:1234-1529.

        img1, img2: uint8 [H, W] numpy frames; fl is updated in place."""
        cfg = self.cfg
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

        x, y, val = (self._upload(a) for a in (fl.x, fl.y, fl.val))
        xn, yn, vn = track_features_pyramid_stacks(pyr1, pyr2, x, y, val,
                                                   cfg)
        if cfg.affine_consistency_check >= 0:
            if self._affine is None:
                self._affine = AffineState.create(fl.n_features, cfg,
                                                  self.device)
            xn, yn, vn = affine_consistency_step(
                self._affine, pyr1[0], pyr2[0], x, y, val, xn, yn, vn, cfg)
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
