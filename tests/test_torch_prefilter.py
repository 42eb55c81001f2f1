"""The selection prefilter of the port held against klt_tpu's on the CPU:
the per-cell top-(k+1) (`cell_topk` against `_cell_topk_device`),
`candidate_points_topk`, the exactness audit and KLTracker's
prefilter=True (klt_tpu's KLT_TPU_PREFILTER=1) select + replace flow."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu.ops.selection as jsel
import klt_tpu.runtime.tracker as jtracker
import klt_tpu_torch as kt
import klt_tpu_torch.runtime.tracker as ttracker
from chip_smoke import corner_scene, synthetic_frames
from klt_tpu_torch import native
from klt_tpu_torch.interop import config_from_fields
from klt_tpu_torch.ops.exact_select import selection_response_exact
from klt_tpu_torch.ops.selection import (_candidate_borders,
                                         candidate_points_topk, cell_topk,
                                         selection_prefilter_audit)

HERE = os.path.dirname(os.path.abspath(__file__))
POS_TOL = 1e-3  # px, as tests/test_torch_slice.py: XLA sums in another order


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads for this module's small tensors: pytest-xdist
    runs several workers on the cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def fixture_scene(rows=150, cols=200):
    """The fixture scene quantized to u8, a crop of rows x cols whose
    sides are not multiples of the default cell (10)."""
    img = np.fromfile(os.path.join(HERE, "fixtures", "smoothed_img0.f32"),
                      np.float32).reshape(240, 320)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)[30:30 + rows,
                                                          50:50 + cols]


def planted_response(rows=96, cols=115):
    """A response of equal values planted in one cell, across cells, on
    off-step pixels and in the border; fractional values truncate."""
    r = np.random.RandomState(3).uniform(0, 40, (rows, cols)).astype(
        np.float32)
    r[30:38, 41:45] = 500.7        # a block of equal values, one cell
    r[45, 30], r[47, 60], r[60, 70] = 800.2, 800.9, 800.0  # -> 800 each
    r[2, 2] = 5000.0               # in the border: never a candidate
    r[50:54, 40:50] = -3.5         # truncates to -3
    return r


CONFIGS = [{}, {"mindist": 7, "n_skipped_pixels": 1},
           {"mindist": 4, "borderx": 9, "window_width": 9}]


def configs(kw):
    jcfg = klt_tpu.TrackingConfig(**kw)
    return jcfg, config_from_fields(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("source", ["scene", "planted"])
@pytest.mark.parametrize("k", [1, 4])
def test_cell_topk_and_candidates_equal_klt_tpus(kw, source, k):
    jcfg, cfg = configs(kw)
    if source == "scene":
        resp = selection_response_exact(fixture_scene(), cfg)
    else:
        resp = planted_response()
    rows, cols = resp.shape
    cell = max(cfg.mindist, 1)
    bx, by, step = _candidate_borders(cfg)
    vals, idx = cell_topk(torch.from_numpy(resp), cell, k, bx, by, step)
    jvals, jidx = jsel._cell_topk_device(resp, cell, k, bx, by, step)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    pts, dropped = candidate_points_topk(resp, cfg, cols, rows, k)
    jpts, jdropped = jsel.candidate_points_topk(resp, jcfg, cols, rows, k)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(dropped, jdropped)
    assert pts.dtype == dropped.dtype == np.int32
    if source == "planted" and k == 4 and not kw:
        # the equal block's cell keeps its lowest flat indices first
        blk = pts[(pts[:, 2] == 500)]
        assert [tuple(p[:2]) for p in blk] == [
            (41, 30), (42, 30), (43, 30), (44, 30)]
        assert (dropped[:, 2] == 500).any()


def audit_inputs(resp, cfg, fl, overwrite_all):
    """The audit's arguments as KLTracker._suppress_prefiltered makes
    them, after the prefiltered suppression into a copy of fl."""
    rows, cols = resp.shape
    pts, dropped = candidate_points_topk(resp, cfg, cols, rows)
    x, y, val = fl.x.copy(), fl.y.copy(), fl.val.copy()
    native.sort_points_desc(pts)
    native.min_dist_suppress(pts, x, y, val, cols, rows, cfg.mindist,
                             cfg.min_eigenvalue, overwrite_all)
    target = np.ones(len(val), bool) if overwrite_all else fl.val < 0
    added = target & (val >= 0)
    exist = np.zeros(len(val), bool) if overwrite_all else fl.val >= 0
    return (pts, dropped, val[added], x[added].astype(np.int32),
            y[added].astype(np.int32), fl.x[exist].astype(np.int32),
            fl.y[exist].astype(np.int32),
            int((target & (val < 0)).sum()))


def test_audit_verdicts_equal_klt_tpus():
    """Selections and replacements of several depths on the scene and on
    the planted response: both audits give the same verdict on the same
    inputs, and both verdicts occur."""
    verdicts = []
    for kw in CONFIGS:
        jcfg, cfg = configs(kw)
        for resp in (selection_response_exact(fixture_scene(), cfg),
                     planted_response()):
            for n, lost in ((4, 0), (40, 0), (400, 0), (40, 3), (40, 20)):
                fl = kt.FeatureList.create(n)
                rows, cols = resp.shape
                pts = jsel.candidate_points(resp, jcfg, cols, rows)
                native.sort_points_desc(pts)
                native.min_dist_suppress(pts, fl.x, fl.y, fl.val, cols, rows,
                                         cfg.mindist, cfg.min_eigenvalue,
                                         True)
                if lost:
                    fl.val[::max(n // lost, 1)][:lost] = -1
                args = audit_inputs(resp, cfg, fl, overwrite_all=not lost)
                ours = selection_prefilter_audit(*args, cfg)
                assert ours == jsel.selection_prefilter_audit(*args, jcfg)
                verdicts.append(ours)
    assert True in verdicts and False in verdicts


@pytest.fixture(scope="module")
def frames():
    """Known motion with a flat patch from frame 3 on (features lost and
    replaced), as tests/test_torch_replace.py."""
    fr = synthetic_frames(11)
    fr[3:, 60:120, 100:180] = 128
    return fr


def counting(monkeypatch, cls, calls):
    orig = cls._suppress_prefiltered

    def wrap(self, *a, **k):
        ok = orig(self, *a, **k)
        # a port tracker without the prefilter declines at once
        if getattr(self, "prefilter", True):
            calls["certified" if ok else "fallback"] += 1
        return ok

    monkeypatch.setattr(cls, "_suppress_prefiltered", wrap)


def test_tracker_prefilter_flow_equals_full_list_and_klt_tpu(frames,
                                                             monkeypatch):
    """Select + track + replace over 10 frames: prefilter=True gives the
    feature lists of prefilter=False bit for bit, and klt_tpu's under
    KLT_TPU_PREFILTER=1 (statuses and picks exact, positions within
    POS_TOL), with the same numbers of certified and fallen-back calls."""
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    monkeypatch.setenv("KLT_TPU_PREFILTER", "1")
    kw = {"sequential_mode": True, "mindist": 8}
    jcfg, cfg = configs(kw)
    ours_calls = {"certified": 0, "fallback": 0}
    ref_calls = {"certified": 0, "fallback": 0}
    counting(monkeypatch, ttracker.KLTracker, ours_calls)
    counting(monkeypatch, jtracker.KLTracker, ref_calls)
    on = kt.KLTracker(cfg, device="cpu", prefilter=True)
    off = kt.KLTracker(cfg, device="cpu")
    ref_t = klt_tpu.KLTracker(jcfg)
    lists = [kt.FeatureList.create(60) for _ in range(2)]
    ref = klt_tpu.FeatureList.create(60)
    on.select_good_features(frames[0], lists[0])
    off.select_good_features(frames[0], lists[1])
    ref_t.select_good_features(frames[0], ref)

    def same():
        for f in ("x", "y", "val"):
            np.testing.assert_array_equal(getattr(lists[0], f),
                                          getattr(lists[1], f))
        np.testing.assert_array_equal(lists[0].val, ref.val)
        for f in ("x", "y"):
            np.testing.assert_allclose(getattr(lists[0], f),
                                       getattr(ref, f), rtol=0,
                                       atol=POS_TOL)

    same()
    replaced = 0
    for i in range(1, len(frames)):
        for tr, fl in ((on, lists[0]), (off, lists[1]), (ref_t, ref)):
            tr.track_features(frames[i - 1], frames[i], fl)
        same()
        lost = lists[0].val < 0
        for tr, fl in ((on, lists[0]), (off, lists[1]), (ref_t, ref)):
            tr.replace_lost_features(frames[i], fl)
        same()
        replaced += int((lost & (lists[0].val > 0)).sum())
    assert replaced >= 10
    # one call per selection or replacement with a lost slot; on these
    # frames the audit certifies none of them (deep selections, flat
    # patch edges), so each took the full list
    assert ours_calls == ref_calls, (ours_calls, ref_calls)
    assert sum(ours_calls.values()) >= 5


def test_prefilter_certifies_replacement_as_klt_tpu(monkeypatch):
    """A replacement the audit certifies: select 4 corners, lose one,
    replace it.  Both packages certify the same calls and end with the
    same list, which equals the full list's."""
    monkeypatch.setenv("KLT_TPU_PREFILTER", "1")
    img = corner_scene()
    jcfg, cfg = configs({})
    ours_calls = {"certified": 0, "fallback": 0}
    ref_calls = {"certified": 0, "fallback": 0}
    counting(monkeypatch, ttracker.KLTracker, ours_calls)
    counting(monkeypatch, jtracker.KLTracker, ref_calls)
    out = []
    for tr, fl in ((kt.KLTracker(cfg, device="cpu", prefilter=True),
                    kt.FeatureList.create(4)),
                   (kt.KLTracker(cfg, device="cpu"),
                    kt.FeatureList.create(4)),
                   (klt_tpu.KLTracker(jcfg), klt_tpu.FeatureList.create(4))):
        tr.select_good_features(img, fl)
        assert (fl.val >= 0).sum() == 4
        fl.val[2] = -1
        tr.replace_lost_features(img, fl)
        out.append(fl)
    assert ours_calls == ref_calls and ours_calls["certified"] >= 1
    for fl in out[1:]:
        for f in ("x", "y", "val"):
            np.testing.assert_array_equal(getattr(out[0], f), getattr(fl, f))


def test_prefilter_reads_no_environment(frames, monkeypatch):
    """The port's prefilter is its argument alone: KLT_TPU_PREFILTER
    changes nothing (klt_tpu reads it)."""
    calls = {"certified": 0, "fallback": 0}
    counting(monkeypatch, ttracker.KLTracker, calls)
    monkeypatch.setenv("KLT_TPU_PREFILTER", "1")
    fl = kt.FeatureList.create(20)
    kt.KLTracker(kt.TrackingConfig(), device="cpu").select_good_features(
        frames[0], fl)
    assert calls == {"certified": 0, "fallback": 0}
    monkeypatch.delenv("KLT_TPU_PREFILTER")
    fl2 = kt.FeatureList.create(20)
    kt.KLTracker(kt.TrackingConfig(), device="cpu",
                 prefilter=True).select_good_features(frames[0], fl2)
    assert sum(calls.values()) == 1
    np.testing.assert_array_equal(fl.val, fl2.val)
