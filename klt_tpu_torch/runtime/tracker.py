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
  full list is taken whenever the exactness audit cannot certify the cut.
  The full list is built in buffers the tracker keeps for the
  selection's geometry (`_Lists`), so that a call allocates nothing: from
  a numpy or CPU response one C pass writes it into an int32 [n, 3] host
  buffer; from a response on the card kernel S (cuda/select_sort.py)
  writes it there and makes the sort's partitions of the ranges that the
  walk's head meets, and only that head and the sort's state come back.
  On the full list the sort is lazy (native.LazySort): the suppression
  stops once the free slots are filled, so only the head of the list it
  reads is sorted, with the full sort's rows and tie order;
* tracking builds pyramids and runs the coarse-to-fine LK on the device;
  sequential mode keeps the previous frame's pyramids there between
  calls — the V3 lesson (src/V3/trackFeaturesGPU.cu:481-484): never
  round-trip frames through the host.  A call is one step program
  (cuda/graph.py's Program, one step), as klt_tpu compiles each call into
  one XLA program: on the card, after the key's first call (the warm-up,
  run eagerly), a replay of the CUDA graph of the step.  The step reads
  and writes static buffers of the tracker: the frames and the features
  come in by one copy each from a staging buffer (pinned on the card),
  image 1's pyramid is the carried one (or is built from image 1 on a
  first or non-sequential call), image 2's is built into the other of
  two slots, so that nothing is copied to carry it (a graph for each
  parity), and the features go out by one copy.

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
from collections import OrderedDict

import numpy as np
import torch

from ..config import TrackingConfig, pyramid_shapes
from ..device import default_device
from ..features import FeatureList
from ..ops.convolve import compute_gradients
from ..ops.exact_select import selection_response_exact
from ..ops.selection import (_candidate_borders, candidate_count,
                             candidate_points, candidate_points_topk,
                             corner_response, selection_prefilter_audit)
from ..ops.pyramid import build_pyramid_stacks
from ..ops import select_sort
from ..ops.lk import track_features_pyramid_stacks
from ..ops.affine import AffineState, affine_consistency_step
from ..cuda import graph
from ..cuda.select_sort import (candidate_list_cuda, head_partitions_cuda,
                                scratch_for)
from ..utils import checks
from ..utils.profiling import count, span
from .. import native

_verbosity = 1
# Geometries (frame shape and dtype, feature count, configuration) whose
# step buffers and programs a tracker keeps, the least recently used
# dropped first; as many geometries of its selection's list buffers.
STEP_KEYS = 4


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
        # geometry -> (_Step, its programs); the programs hold the step,
        # never the other way round, so a dropped tracker frees its
        # buffers and graphs at once, not at the next garbage collection
        self._steps: OrderedDict = OrderedDict()
        # (frame shape, borders and step) -> _Lists; selection may come
        # before any track, so these are not the step's
        self._lists: OrderedDict = OrderedDict()

    def select_good_features(self, img: np.ndarray, fl: FeatureList) -> None:
        """reference: KLTSelectGoodFeatures, src/V1/selectGoodFeatures.c:472.

        img: uint8 [H, W] numpy frame."""
        img = np.asarray(img)
        _log(f"(KLT) Selecting the {fl.n_features} best features from a "
             f"{img.shape[1]} by {img.shape[0]} image...")
        with span("tracker.select"):
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
            with span("tracker.replace"):
                self._select(np.asarray(img), fl, overwrite_all=False)

    def _select(self, img: np.ndarray, fl: FeatureList,
                overwrite_all: bool) -> None:
        nrows, ncols = img.shape
        cfg = self.cfg
        count("select.calls")
        with span("select.response"):
            if (not overwrite_all and self.sequential
                    and self._pyr_last is not None):
                # replacement in sequential mode reuses the cached
                # pyramid's level-0 gradients
                # (src/V1/selectGoodFeatures.c:342-348)
                lvl0 = self._pyr_last[0]
                response = corner_response(lvl0[1], lvl0[2],
                                           cfg.window_width,
                                           cfg.window_height)
            elif _exact_select_enabled():
                response = selection_response_exact(img, cfg)
            else:
                response = self._device_response(img)
        newly = None if overwrite_all else (fl.val < 0)
        if not self._suppress_prefiltered(response, fl, ncols, nrows,
                                          overwrite_all):
            bufs = self._list_buffers(img.shape)
            if isinstance(response, torch.Tensor) and \
                    response.device.type == "cuda":
                lazy = self._sort_on_card(response, bufs, fl, ncols, nrows,
                                          overwrite_all)
            else:
                if isinstance(response, torch.Tensor):
                    with span("select.readback"):
                        response = response.numpy()
                with span("select.candidates"):
                    pts = candidate_points(response, cfg, ncols, nrows,
                                           out=bufs.pts)
                count("select.candidates", len(pts))
                # the walk reads a few % of the list: sort only that head
                with span("select.sort"):
                    lazy = native.LazySort(pts, bufs.walk_map)
                with span("select.suppress"):
                    lazy.min_dist_suppress(fl.x, fl.y, fl.val, ncols, nrows,
                                           cfg.mindist, cfg.min_eigenvalue,
                                           overwrite_all)
            count("select.sorted", lazy.n_final)
        # reset the affine reference patches of (re)selected slots
        if cfg.affine_consistency_check >= 0 and self._affine is not None:
            reset = np.ones(fl.n_features, bool) if overwrite_all else newly
            self._affine.invalidate(np.nonzero(reset)[0])

    def _sort_on_card(self, response: torch.Tensor, bufs: "_Lists",
                      fl: FeatureList, ncols: int,
                      nrows: int, overwrite_all: bool) -> native.LazySort:
        """The full-list selection from a response on the card: kernel S
        makes the list there and the lazy sort's partitions of the ranges
        that the walk's head meets, and only the list's first
        `select_sort.prefix_rows` rows come back with the sort's state; the
        walk finishes the sort on the host and brings the rest of the list
        back only if it reads past them.  The same features, the same rows
        made final, as the host chain.  Returns the lazy sort."""
        cfg = self.cfg
        if bufs.card is None:
            bufs.card = _CardList.create(bufs.pts.shape[0], self.device)
        card = bufs.card
        n = bufs.pts.shape[0]
        rows = select_sort.prefix_rows(n)
        with span("select.candidates"):
            candidate_list_cuda(response, cfg, card.pts, card.state)
        count("select.candidates", n)
        count("select.card_lists")
        with span("select.sort"):
            head_partitions_cuda(card.pts, card.state, card.scratch,
                                 select_sort.K0, select_sort.S_MIN,
                                 select_sort.ROUNDS)
        with span("select.readback"):
            card.stage_state.copy_(card.state, non_blocking=True)
            card.stage_pts[:rows].copy_(card.pts[:rows])
        with span("select.suppress"):
            lazy = native.LazySort.resume(card.stage_pts.numpy(),
                                          card.stage_state.numpy(), rows,
                                          bufs.walk_map)

            def rest() -> int:
                count("select.card_spills")
                card.stage_pts[rows:].copy_(card.pts[rows:])
                return n

            lazy.min_dist_suppress(fl.x, fl.y, fl.val, ncols, nrows,
                                   cfg.mindist, cfg.min_eigenvalue,
                                   overwrite_all, more=rest)
        return lazy

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
        with span("select.prefilter"):
            pts, dropped_cells = candidate_points_topk(response, cfg, ncols,
                                                       nrows)
            count("select.candidates", len(pts))
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
                save[0][exist].astype(np.int32),
                save[1][exist].astype(np.int32), n_unfilled, cfg)
            if not ok:
                fl.x[:], fl.y[:], fl.val[:] = save
            return ok

    def _list_buffers(self, shape: tuple) -> "_Lists":
        """The owned buffers of a full-list selection on a frame of this
        shape under the tracker's borders and step; counted as made or
        reused."""
        key = (shape, _candidate_borders(self.cfg))
        bufs = self._lists.pop(key, None)
        if bufs is None:
            count("select.lists_made")
            bufs = _Lists.create(shape, self.cfg)
        else:
            count("select.lists_reused")
        self._lists[key] = bufs
        while len(self._lists) > STEP_KEYS:
            self._lists.popitem(last=False)
        return bufs

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

        img1, img2: uint8 [H, W] numpy frames; fl is updated in place.
        One replay of the step's CUDA graph on the card (module
        docstring)."""
        cfg = self.cfg
        img2 = np.asarray(img2)
        if _verbosity >= 1:    # the counts cost host time: skip them
            _log(f"(KLT) Tracking {fl.count_remaining()} features in a "
                 f"{img2.shape[1]} by {img2.shape[0]} image...")

        pyr1 = self._pyr_last if self.sequential else None
        if pyr1 is not None and tuple(pyr1[0].shape[-2:]) != img2.shape:
            raise ValueError(
                f"incoming image {tuple(img2.shape)} differs from "
                f"previous image {tuple(pyr1[0].shape[-2:])}")
        if pyr1 is None:
            img1 = np.asarray(img1)
            if img1.shape != img2.shape or img1.dtype != img2.dtype:
                raise ValueError(
                    f"img1 ({img1.shape}, {img1.dtype}) and img2 "
                    f"({img2.shape}, {img2.dtype}) differ in shape or dtype")
        with span("tracker.track"):
            with span("track.stage"):
                b, programs, src = self._stage(img1, img2, fl, pyr1)
            key = (src, checks.debug_enabled())
            prog = programs.get(key)
            if prog is None:
                state = self._affine if cfg.affine_consistency_check >= 0 \
                    else None
                prog = programs[key] = graph.Program(
                    b, lambda n: _track_step(b, cfg, state, src),
                    self.device, self.device.type == "cuda")
            flags = checks.Flags()
            prog.run(1, flags)
            flags.report()
            with span("track.readback"):
                b.stage_out.copy_(b.out)
            with span("track.unpack"):
                out = b.stage_out.numpy()
                fl.x[:] = out[0].view(np.float32)
                fl.y[:] = out[1].view(np.float32)
                fl.val[:] = out[2]
                if self.sequential:
                    self._pyr_last = b.slots[_carry_slot(src)]
        if _verbosity >= 1:
            _log(f"\t{fl.count_remaining()} features successfully tracked.")

    def _stage(self, img1: np.ndarray, img2: np.ndarray, fl: FeatureList,
               pyr1) -> tuple:
        """A call's frames and features into the pinned staging buffer of
        its geometry, and their copies to the device enqueued.  Returns
        (the step buffers, their programs, the slot that holds image 1's
        pyramid, or None when the step builds it from image 1)."""
        cfg = self.cfg
        if cfg.affine_consistency_check >= 0 and self._affine is None:
            self._affine = AffineState.create(fl.n_features, cfg,
                                              self.device)
        b, programs = self._step_buffers(img2, fl.n_features)
        if pyr1 is None:
            src = None
            b.stage_np[0] = img1
        else:
            src = next((i for i, s in enumerate(b.slots) if s is pyr1),
                       None)
            if src is None:
                # carried by another geometry's buffers: into slot 0,
                # outside the graph
                src = 0
                for dst, st in zip(b.slots[0], pyr1):
                    dst.copy_(st)
        b.stage_np[1] = img2
        feats = b.stage_feats.numpy()
        feats[0], feats[1] = fl.x.view(np.int32), fl.y.view(np.int32)
        feats[2] = fl.val
        if src is None:
            b.frames.copy_(b.stage, non_blocking=True)
        else:
            b.frames[1].copy_(b.stage[1], non_blocking=True)
        b.feats.copy_(b.stage_feats, non_blocking=True)
        return b, programs, src

    def _step_buffers(self, img2: np.ndarray, n: int) -> tuple:
        """The static buffers of this call's geometry and their programs,
        keyed by (the source of image 1's pyramid, KLT_TPU_DEBUG)."""
        key = (img2.shape, img2.dtype.str, n, self.cfg)
        entry = self._steps.pop(key, None)
        if entry is None:
            dtype = torch.from_numpy(np.empty(0, img2.dtype)).dtype
            entry = (_Step.create(img2.shape, dtype, n, self.cfg,
                                  self.device), {})
        self._steps[key] = entry
        while len(self._steps) > STEP_KEYS:
            self._steps.popitem(last=False)
        return entry

    def stop_sequential_mode(self) -> None:
        """reference: KLTStopSequentialMode, src/V1/klt.c:490-500."""
        self._pyr_last = None
        self.sequential = False


@dataclasses.dataclass
class _Step:
    """The static buffers of a tracker's step programs for one geometry
    (frame shape and dtype, N, cfg)."""

    stage: torch.Tensor        # host [2, H, W]: image 1, image 2
    stage_feats: torch.Tensor  # host i32 [3, N]: x, y (f32 bits), val
    stage_out: torch.Tensor    # host i32 [3, N]: the step's x, y, val
    frames: torch.Tensor       # device [2, H, W]
    feats: torch.Tensor        # device i32 [3, N]
    out: torch.Tensor          # device i32 [3, N]
    slots: tuple               # two pyramids: finest-first [3, H_l, W_l]

    @classmethod
    def create(cls, shape, dtype, n: int, cfg: TrackingConfig,
               device: torch.device) -> "_Step":
        pin = device.type == "cuda"
        host = lambda size, dt: torch.empty(size, dtype=dt,
                                            pin_memory=pin)
        dev = lambda t: torch.empty_like(t, device=device)
        stage = host((2, *shape), dtype)
        feats = host((3, n), torch.int32)
        shapes = pyramid_shapes(shape[1], shape[0], cfg)
        return cls(stage=stage, stage_feats=feats,
                   stage_out=host((3, n), torch.int32), frames=dev(stage),
                   feats=dev(feats), out=dev(feats),
                   slots=tuple([torch.empty((3, r, c), dtype=torch.float32,
                                            device=device)
                                for c, r in shapes] for _ in range(2)))

    @property
    def stage_np(self) -> np.ndarray:
        return self.stage.numpy()


@dataclasses.dataclass
class _CardList:
    """A selection's list on the card (kernel S) and what of it comes
    back to the host, for one geometry."""

    pts: torch.Tensor          # device i32 [n, 3]: the candidate list
    state: torch.Tensor        # device i64 [3 + 2 * LAZY_PENDING]: its sort
    scratch: torch.Tensor      # device i32: kernel S's partition entry's
    stage_pts: torch.Tensor    # pinned i32 [n, 3]: the list's head, back
    stage_state: torch.Tensor  # pinned i64: the sort's state, back

    @classmethod
    def create(cls, n: int, device: torch.device) -> "_CardList":
        state = torch.empty(3 + 2 * native.LAZY_PENDING, dtype=torch.int64)
        return cls(pts=torch.empty((n, 3), dtype=torch.int32, device=device),
                   state=state.to(device), scratch=scratch_for(n, device),
                   stage_pts=torch.empty((n, 3), dtype=torch.int32,
                                         pin_memory=True),
                   stage_state=state.pin_memory())


@dataclasses.dataclass
class _Lists:
    """The buffers of a full-list selection for one geometry (frame
    shape, borders and step), kept from call to call: nothing is
    allocated per call."""

    pts: np.ndarray           # i32 [n, 3]: the candidate list on the host
    walk_map: np.ndarray      # u8 [H, W]: the walk's map of stamps
    card: _CardList | None    # the list on the card, made at the first
    #                           selection from a response there

    @classmethod
    def create(cls, shape, cfg: TrackingConfig) -> "_Lists":
        n = candidate_count(cfg, shape[1], shape[0])
        return cls(pts=np.empty((n, 3), np.int32),
                   walk_map=np.empty(shape, np.uint8), card=None)


def _carry_slot(src: int | None) -> int:
    """The slot image 2's pyramid is built into: the other one, or slot 0
    after a pair built from both frames."""
    return 0 if src is None else 1 - src


def _track_step(b: _Step, cfg: TrackingConfig, state,
                src: int | None) -> None:
    """A call of `track_features` on b's static buffers: image 1's
    pyramid from slot `src` (None: built from b.frames[0]), image 2's
    into slot _carry_slot(src), the coarse-to-fine LK and, with `state`,
    the affine check, the features into b.out."""
    x, y = (b.feats[i].view(torch.float32) for i in (0, 1))
    val = b.feats[2]
    pyr1 = build_pyramid_stacks(b.frames[0], cfg) if src is None \
        else b.slots[src]
    pyr2 = build_pyramid_stacks(b.frames[1], cfg,
                                out=b.slots[_carry_slot(src)])
    xn, yn, vn = track_features_pyramid_stacks(pyr1, pyr2, x, y, val, cfg)
    if state is not None:
        xn, yn, vn = affine_consistency_step(state, pyr1[0], pyr2[0], x, y,
                                             val, xn, yn, vn, cfg)
    torch.stack([xn.view(torch.int32), yn.view(torch.int32), vn],
                out=b.out)
