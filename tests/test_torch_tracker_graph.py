"""KLTracker's step programs and track_pair_carry's (runtime/tracker.py,
runtime/pipeline.py) on the CPU, where cuda/graph.py runs each step
function as it is, without capture: the bookkeeping that the card's CUDA
graphs share (the staging of frames and features, the carried pyramid in
two slots and its parity, the affine state's invalidation between calls,
the copies out).

The program path is held bit for bit at 64x80 against the same flow with
the tracker's step buffers and programs dropped before every call, so
that each call gets fresh static buffers and the carried pyramid comes
in by a copy into slot 0: slot parity, buffer reuse and the program cache
are what the two runs differ in.  `track_pair_carry` is held against
`track_sequence` over the same frames and start features (the same
kernels through another entry) and against klt_tpu's (XLA path,
KLT_TPU_NO_PALLAS=1): statuses exact, positions within POS_TOL.  The
graphs themselves are held against the same step functions run eagerly
on a card in test_torch_cuda.py and chip_smoke.py phase 41.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import affine_frames, synthetic_frames, tie_frames
from klt_tpu.runtime import pipeline as jpipeline
from klt_tpu_torch.cuda import graph
from klt_tpu_torch.runtime import pipeline

POS_TOL = 3.1e-5   # px, tests/test_torch_affine.py's
H, W = 64, 80
N_FEAT = 30
T = 8

kt.set_verbosity(0)
klt_tpu.set_verbosity(0)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def scene(origin=(40, 60)) -> np.ndarray:
    """T frames of 64x80 of the synthetic scene with a flat patch from
    frame 3 (tie_frames): features are lost and replaced."""
    r0, c0 = origin
    return np.ascontiguousarray(
        tie_frames(synthetic_frames(T), 3)[:, r0:r0 + H, c0:c0 + W])


@functools.lru_cache(maxsize=None)
def affine_scene() -> np.ndarray:
    """T frames of 64x80 around affine_frames' deforming region, where
    the check kills features."""
    return np.ascontiguousarray(
        affine_frames(T, rate=0.12)[:, 88:88 + H, 120:120 + W])


CASES = {
    # name: (config fields, frames, replace every frame, the calls at
    # which the flow reselects all or stops sequential mode)
    "sequential": ({"sequential_mode": True}, scene, False, {}),
    "replace": ({"sequential_mode": True}, scene, True, {}),
    "affine": ({"sequential_mode": True, "affine_consistency_check": 2,
                "n_pyramid_levels": 2, "subsampling": 2}, affine_scene, True,
               {4: "select"}),
    "non-sequential": ({}, scene, True, {}),
    "stop sequential mode": ({"sequential_mode": True}, scene, True,
                             {3: "stop"}),
}


def run_flow(case, cleared=False):
    """The reference's example3 flow on the case's frames through a CPU
    KLTracker: the feature list after every call.  cleared: the tracker's
    step buffers and programs dropped before every track_features."""
    kw, frames, replace, events = CASES[case]
    frames = frames()
    cfg = kt.TrackingConfig(mindist=3, **kw)
    tr = kt.KLTracker(cfg, device="cpu")
    fl = kt.FeatureList.create(N_FEAT)
    tr.select_good_features(frames[0], fl)
    rows = [fl.copy()]
    for i in range(1, len(frames)):
        if events.get(i) == "stop":
            tr.stop_sequential_mode()
        if cleared:
            tr._steps.clear()
        tr.track_features(frames[i - 1], frames[i], fl)
        rows.append(fl.copy())
        if events.get(i) == "select":
            tr.select_good_features(frames[i], fl)
            rows.append(fl.copy())
        elif replace:
            tr.replace_lost_features(frames[i], fl)
            rows.append(fl.copy())
    return tr, rows


def assert_same_lists(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for k in ("x", "y", "val"):
            np.testing.assert_array_equal(getattr(a, k).view(np.int32),
                                          getattr(b, k).view(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_program_path_equals_the_eager_body(case):
    """Every feature list of the flow bit-equal to the cleared flow's,
    the affine state too; the programs made are the ones the call
    sequence needs (a pair built from both frames; then the two parities
    of the carried pyramid, or pairs again after stop_sequential_mode)."""
    tr, got = run_flow(case)
    ref_tr, ref = run_flow(case, cleared=True)
    assert_same_lists(got, ref)
    lost = sum(int((r.val < 0).sum()) for r in got)
    assert lost > 0
    if CASES[case][2]:
        assert any(((a.val < 0) & (b.val >= 0)).any()
                   for a, b in zip(got[1::2], got[2::2]))
    ((_, programs),) = tr._steps.values()
    srcs = sorted({src for src, _ in programs}, key=str)
    want = {"non-sequential": [None], "stop sequential mode": [0, None]}
    assert srcs == want.get(case, [0, 1, None])
    if case == "affine":
        assert tr._affine is not None
        assert torch.equal(tr._affine.valid, ref_tr._affine.valid)
        assert torch.equal(tr._affine.patches, ref_tr._affine.patches)
        assert not tr._affine.valid.all() and tr._affine.valid.any()
    if case == "stop sequential mode":
        assert tr._pyr_last is None and not tr.sequential


def test_a_frame_of_another_shape_raises_before_any_step():
    cfg = kt.TrackingConfig(sequential_mode=True, mindist=3)
    frames = scene()
    tr = kt.KLTracker(cfg, device="cpu")
    fl = kt.FeatureList.create(N_FEAT)
    tr.select_good_features(frames[0], fl)
    tr.track_features(frames[0], frames[1], fl)
    before = fl.copy()
    small = np.ascontiguousarray(frames[2][:48])
    with pytest.raises(ValueError, match="differs from previous image"):
        tr.track_features(frames[1], small, fl)
    assert_same_lists([fl], [before])
    tr2 = kt.KLTracker(kt.TrackingConfig(mindist=3), device="cpu")
    with pytest.raises(ValueError, match="differ in shape or dtype"):
        tr2.track_features(small, frames[1], fl)


def test_two_trackers_interleaved_equal_each_run_alone():
    """Two trackers (replacement, two scenes) stepped frame by frame in
    turns: each one's lists equal its run alone; no buffer is shared."""
    cfg = kt.TrackingConfig(sequential_mode=True, mindist=3)
    scenes = [scene(), scene((100, 150))]
    alone = []
    for frames in scenes:
        tr = kt.KLTracker(cfg, device="cpu")
        fl = kt.FeatureList.create(N_FEAT)
        tr.select_good_features(frames[0], fl)
        rows = []
        for i in range(1, T):
            tr.track_features(frames[i - 1], frames[i], fl)
            tr.replace_lost_features(frames[i], fl)
            rows.append(fl.copy())
        alone.append(rows)
    trs = [kt.KLTracker(cfg, device="cpu") for _ in scenes]
    fls = [kt.FeatureList.create(N_FEAT) for _ in scenes]
    for tr, fl, frames in zip(trs, fls, scenes):
        tr.select_good_features(frames[0], fl)
    turns = [[], []]
    for i in range(1, T):
        for k, (tr, fl, frames) in enumerate(zip(trs, fls, scenes)):
            tr.track_features(frames[i - 1], frames[i], fl)
            tr.replace_lost_features(frames[i], fl)
            turns[k].append(fl.copy())
    for got, ref in zip(turns, alone):
        assert_same_lists(got, ref)
    ptrs = [{t.data_ptr() for s, _ in tr._steps.values()
             for t in (s.stage, s.frames, s.feats, s.out,
                       *s.slots[0], *s.slots[1])} for tr in trs]
    assert not ptrs[0] & ptrs[1]


def pair_inputs():
    frames = scene()
    cfg = kt.TrackingConfig(sequential_mode=True, mindist=3)
    fl = kt.FeatureList.create(N_FEAT)
    kt.KLTracker(cfg, device="cpu").select_good_features(frames[0], fl)
    return cfg, frames, fl


def test_track_pair_carry_returns_what_the_caller_owns():
    """Every tensor returned stays as it was while later calls run, and
    shares no storage with the program's static buffers; each step's
    features equal `track_sequence`'s row on the same frames bit for bit,
    and its pyramid `prepare_pyramids` of the new frame."""
    cfg, frames, fl = pair_inputs()
    graph._clear()
    feats = [torch.from_numpy(a.copy()) for a in (fl.x, fl.y, fl.val)]
    imgs = torch.from_numpy(frames)
    ref = pipeline.track_sequence(imgs, *feats, cfg)
    state = pipeline.prepare_pyramids(imgs[0], cfg)
    outs, snaps = [], []
    for i in range(1, T):
        feats, state = pipeline.track_pair_carry(state, imgs[i], feats, cfg)
        ref_state = pipeline.prepare_pyramids(imgs[i], cfg)
        for a, b in zip((*feats, *state),
                        (*(r[i - 1] for r in ref), *ref_state)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        outs.append((*feats, *state))
        snaps.append([a.clone() for a in outs[-1]])
    for got, snap in zip(outs, snaps):
        for a, b in zip(got, snap):
            assert torch.equal(a, b)
    (key, prog), = [kp for kp in graph.programs()
                    if kp[0][0] == "pair_carry"]
    b = prog.static
    static = {t.untyped_storage().data_ptr()
              for t in (*b.st1, b.img2, *b.feats)}
    assert not static & {a.untyped_storage().data_ptr()
                         for got in outs for a in got}
    assert (outs[-1][2] < 0).any() and (outs[-1][2] >= 0).sum() > 10


def test_track_pair_carry_matches_klt_tpu(monkeypatch):
    """A chain of T - 1 pair steps from prepare_pyramids against klt_tpu's
    (XLA path): statuses exact, positions within POS_TOL."""
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    cfg, frames, fl = pair_inputs()
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True, mindist=3)
    feats = [torch.from_numpy(a.copy()) for a in (fl.x, fl.y, fl.val)]
    jfeats = tuple(jnp.asarray(a) for a in (fl.x, fl.y, fl.val))
    state = pipeline.prepare_pyramids(torch.from_numpy(frames[0]), cfg)
    jstate = jpipeline.prepare_pyramids(jnp.asarray(frames[0]), jcfg)
    for i in range(1, T):
        feats, state = pipeline.track_pair_carry(
            state, torch.from_numpy(frames[i]), feats, cfg)
        jfeats, jstate = jpipeline.track_pair_carry(
            jstate, jnp.asarray(frames[i]), jfeats, jcfg)
        np.testing.assert_array_equal(feats[2].numpy(), np.asarray(jfeats[2]))
        for a, b in zip(feats[:2], jfeats[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=POS_TOL)
    assert (feats[2].numpy() < 0).any()
