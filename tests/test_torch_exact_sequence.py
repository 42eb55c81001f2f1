"""track_sequence_replace_exact (plain, on the CPU) held against klt_tpu's
entry of that name, in both tiers: statuses, picks, repaired frames and
positions.

Frames: a 160x120 crop of the synthetic scene, 9 frames, with a flat patch
from frame 3 on (features are lost) and from frame 5 on a block of texture
pasted at two places (`chip_smoke.tie_frames`: equal responses to the bit,
so replacement meets integer ties), 60 features.  klt_tpu runs one
jit-compiled chunk per power of two; each tier is one test, so a worker
compiles only the tier it runs.
"""

import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import synthetic_frames, tie_frames
from klt_tpu_torch.ops import exact_select as es
from klt_tpu_torch.runtime import pipeline

# px.  klt_tpu on XLA:CPU does not keep the C order to the bit
# (PARITY.md:243-249); its positions differ from the port's by ~4e-5 px
# on these frames, far inside klt_tpu's own 0.05 px against the C table
# (tests/test_tracking.py:199-205).
POS_TOL = 1e-3


@pytest.fixture(scope="module")
def inputs():
    kt.set_verbosity(0)
    frames = tie_frames(synthetic_frames(9)[:, 40:160, 60:220], 5)
    cfg = kt.TrackingConfig(sequential_mode=True)
    fl = kt.FeatureList.create(60)
    kt.KLTracker(cfg, device="cpu").select_good_features(frames[0], fl)
    return frames, cfg, (fl.x, fl.y, fl.val)


def frame_index(frames, frame):
    frame = np.asarray(frame.cpu() if isinstance(frame, torch.Tensor)
                       else frame)
    return next(i for i in range(len(frames))
                if np.array_equal(frames[i], frame))


def port_run(frames, cfg, feats, tier, chunk, monkeypatch=None):
    """The port's table as numpy, and the frames it repaired."""
    repaired = []
    if monkeypatch is not None:
        orig = pipeline._repair_replacement_host

        def spy(frame, *args):
            repaired.append(frame_index(frames, frame))
            return orig(frame, *args)

        monkeypatch.setattr(pipeline, "_repair_replacement_host", spy)
    out = kt.track_sequence_replace_exact(
        torch.from_numpy(frames), *(torch.from_numpy(a) for a in feats), cfg,
        tier=tier, chunk=chunk)
    return [a.numpy() for a in out], repaired


def jax_run(frames, feats, tier, monkeypatch):
    from klt_tpu.runtime import pipeline as jp
    repaired = []
    orig = jp._repair_replacement_host

    def spy(frame, *args):
        repaired.append(frame_index(frames, frame))
        return orig(frame, *args)

    monkeypatch.setattr(jp, "_repair_replacement_host", spy)
    monkeypatch.setenv("KLT_TPU_REPLACE_CHUNK", "8")
    monkeypatch.setenv("KLT_TPU_REPLACE_TRACK_TIER", tier)
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True)
    out = jp.track_sequence_replace_exact(frames, *feats, jcfg)
    return [np.asarray(a) for a in out], repaired


@pytest.mark.parametrize("tier", ["exact", "fast"])
def test_replace_run_equals_klt_tpus(tier, inputs, monkeypatch):
    """Equal statuses (every non-positive value), the same slots refilled
    at the same integer positions, the same frames repaired on the host,
    positions within POS_TOL.  A refilled slot's value is the integer of
    the numpy C-order chain's response of its frame at the pick, to the
    bit; klt_tpu's may be one off (its response on XLA:CPU)."""
    frames, cfg, feats = inputs
    (xs, ys, vs), rep = port_run(frames, cfg, feats, tier, 8, monkeypatch)
    (jx, jy, jv), jrep = jax_run(frames, feats, tier, monkeypatch)
    assert rep == jrep and len(rep) >= 1
    np.testing.assert_array_equal(vs > 0, jv > 0)
    np.testing.assert_array_equal(vs[vs <= 0], jv[jv <= 0])
    np.testing.assert_allclose(xs, jx, atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(ys, jy, atol=POS_TOL, rtol=0)
    assert (np.abs(vs.astype(np.int64) - jv) <= 1).all()
    fresh = vs > 0  # a tracked feature's value is 0: these are picks
    assert fresh.sum() >= 10 and (vs < 0).any()
    for t in np.flatnonzero(fresh.any(axis=1)):
        resp = es.selection_response_exact(frames[t + 1], cfg)
        new = fresh[t]
        np.testing.assert_array_equal(
            xs[t][new], np.trunc(xs[t][new]))  # picks lie on pixels
        np.testing.assert_array_equal(
            vs[t][new], resp[ys[t][new].astype(int),
                             xs[t][new].astype(int)].astype(np.int32))


@pytest.mark.parametrize("tier", ["exact", "fast"])
def test_table_does_not_depend_on_chunk(tier, inputs, monkeypatch):
    frames, cfg, feats = inputs
    (ref, rep) = port_run(frames, cfg, feats, tier, 32, monkeypatch)
    assert rep  # a tie-flagged frame in the chunk: a repair and a resume
    for chunk in (1, 3):
        got, _ = port_run(frames, cfg, feats, tier, chunk)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_entry_point_takes_the_card_unless_told_otherwise(inputs):
    frames, cfg, feats = inputs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.track_sequence_replace_exact(frames[:3], *feats, cfg)
    xs, ys, vs = kt.track_sequence_replace_exact(frames[:3], *feats, cfg,
                                                 device="cpu")
    assert xs.shape == (2, 60) and xs.device.type == "cpu"
    with pytest.raises(ValueError, match="tier"):
        kt.track_sequence_replace_exact(frames[:3], *feats, cfg,
                                        tier="other", device="cpu")
