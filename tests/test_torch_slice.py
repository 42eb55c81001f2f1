"""The port's main path held against klt_tpu end to end: track_sequence
and KLTracker select+track on synthetic sequences with known motion; the
port without jax; chip_smoke.py without a card."""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import shift, synthetic_frames
from klt_tpu_torch.interop import config_from_fields, features_from_numpy
from klt_tpu_torch.runtime.pipeline import (prepare_pyramids,
                                            track_pair_carry, track_sequence)

POS_TOL = 1e-3  # px; XLA sums windows in another order than C and the port
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(6)


def select(img, n, cfg_kw=None):
    fl = kt.FeatureList.create(n)
    kt.KLTracker(kt.TrackingConfig(**(cfg_kw or {}))).select_good_features(
        img, fl)
    return fl


def assert_same_tracks(ours, ref):
    np.testing.assert_array_equal(np.asarray(ours[2]), np.asarray(ref[2]))
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=POS_TOL)


def test_track_sequence_matches_klt_tpu(frames, monkeypatch):
    from klt_tpu.runtime.pipeline import track_sequence as jseq
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    fl = select(frames[0], 32)
    ref = jseq(jnp.asarray(frames), jnp.asarray(fl.x), jnp.asarray(fl.y),
               jnp.asarray(fl.val), jcfg)
    ours = track_sequence(torch.from_numpy(frames),
                          *features_from_numpy(fl.x, fl.y, fl.val), cfg)
    assert ours[0].shape == (5, 32)
    assert_same_tracks([o.numpy() for o in ours], ref)
    # the tracks follow the known motion of the synthetic frames
    ok = ours[2][-1].numpy() == kt.TRACKED
    assert ok.mean() >= 0.9
    tx, ty = shift(5)
    err = np.maximum(np.abs(ours[0][-1].numpy()[ok] - fl.x[ok] - tx),
                     np.abs(ours[1][-1].numpy()[ok] - fl.y[ok] - ty))
    assert np.median(err) < 0.5


def test_tracker_matches_klt_tpu(frames, monkeypatch):
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    kw = {"sequential_mode": True, "mindist": 8}
    ours_t = kt.KLTracker(kt.TrackingConfig(**kw))
    ref_t = klt_tpu.KLTracker(klt_tpu.TrackingConfig(**kw))
    ours = kt.FeatureList.create(48)
    ref = klt_tpu.FeatureList.create(48)
    ours_t.select_good_features(frames[0], ours)
    ref_t.select_good_features(frames[0], ref)
    np.testing.assert_array_equal(ours.val, ref.val)
    for i in range(1, 4):
        ours_t.track_features(frames[i - 1], frames[i], ours)
        ref_t.track_features(frames[i - 1], frames[i], ref)
        assert_same_tracks((ours.x, ours.y, ours.val),
                           (ref.x, ref.y, ref.val))
    assert ours.count_remaining() > 40


def test_tracker_equals_track_sequence_and_pair_steps(frames):
    cfg = kt.TrackingConfig(sequential_mode=True)
    fl = select(frames[0], 40)
    start = fl.copy()
    tr = kt.KLTracker(cfg)
    table = kt.FeatureTable.create(len(frames), 40)
    table.store_list(fl, 0)
    for i in range(1, len(frames)):
        tr.track_features(frames[i - 1], frames[i], fl)
        table.store_list(fl, i)
    feats = features_from_numpy(start.x, start.y, start.val)
    xs, ys, vs = track_sequence(torch.from_numpy(frames), *feats, cfg)
    np.testing.assert_array_equal(xs.numpy(), table.x[:, 1:].T)
    np.testing.assert_array_equal(vs.numpy(), table.val[:, 1:].T)
    state = prepare_pyramids(torch.from_numpy(frames[0]), cfg)
    for i in range(1, len(frames)):
        feats, state = track_pair_carry(state, torch.from_numpy(frames[i]),
                                        feats, cfg)
    assert torch.equal(feats[1], ys[-1])


def test_tracker_refuses_affine_config_and_has_no_replacement(frames):
    tr = kt.KLTracker(kt.TrackingConfig(affine_consistency_check=2))
    fl = select(frames[0], 8)
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        tr.track_features(frames[0], frames[1], fl)
    assert not hasattr(kt.KLTracker, "replace_lost_features")


def test_tracker_rejects_a_frame_of_another_size(frames):
    tr = kt.KLTracker(kt.TrackingConfig(sequential_mode=True))
    fl = select(frames[0], 8)
    tr.track_features(frames[0], frames[1], fl)
    with pytest.raises(ValueError, match="differs"):
        tr.track_features(frames[1], frames[2][:, :300], fl)


def test_port_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import klt_tpu_torch as kt\n"
        "from klt_tpu_torch.runtime.pipeline import track_sequence\n"
        "from chip_smoke import synthetic_frames\n"
        "kt.set_verbosity(0)\n"
        "fr = synthetic_frames(3)\n"
        "cfg = kt.TrackingConfig(sequential_mode=True)\n"
        "fl = kt.FeatureList.create(20)\n"
        "tr = kt.KLTracker(cfg)\n"
        "tr.select_good_features(fr[0], fl)\n"
        "tr.track_features(fr[0], fr[1], fl)\n"
        "xs, ys, vs = track_sequence(torch.from_numpy(fr),\n"
        "    *[torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)], cfg)\n"
        "assert not any(m == 'klt_tpu' or m.startswith(('klt_tpu.', 'jax.'))\n"
        "               for m in sys.modules)\n"
        "print('tracked', int((vs[-1] == 0).sum()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 10


def test_port_sources_import_neither_jax_nor_klt_tpu():
    pat = re.compile(r"^\s*(import|from)\s+\.*(jax|klt_tpu)\b", re.M)
    pkg = os.path.join(ROOT, "klt_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device (as here): non-zero exit and no result line.  In a
    directory holding chip_smoke.py alone it fails as well."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = os.path.join(ROOT, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(src, "rb").read())
    for script, cwd in ((src, ROOT), (str(lone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
