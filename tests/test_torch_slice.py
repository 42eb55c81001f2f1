"""The port's main path held against klt_tpu end to end: track_sequence
and KLTracker select+track on synthetic sequences with known motion; the
port without jax; chip_smoke.py without a card."""

import ast
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

# px; XLA sums a window in another order than the port, whose order is the
# LK kernels' warp's (ops/lk.py::_window_sum); measured: 3.05e-5 px
POS_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(6)


def select(img, n, cfg_kw=None):
    fl = kt.FeatureList.create(n)
    kt.KLTracker(kt.TrackingConfig(**(cfg_kw or {})),
                 device="cpu").select_good_features(
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
    ours_t = kt.KLTracker(kt.TrackingConfig(**kw), device="cpu")
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
    tr = kt.KLTracker(cfg, device="cpu")
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
    """With the affine check asked for the tracker tracks (saving a
    reference patch for every tracked feature), and replacement resets the
    patches of the slots it fills.  (The test keeps the name it had when
    the port refused such a configuration.)"""
    tr = kt.KLTracker(kt.TrackingConfig(affine_consistency_check=2),
                      device="cpu")
    fl = select(frames[0], 8)
    tr.track_features(frames[0], frames[1], fl)
    assert (fl.val == kt.TRACKED).all()
    assert tr._affine.valid.all() and tr._affine.patches.abs().max() > 0
    fl.val[:2] = kt.OOB
    tr.replace_lost_features(frames[1], fl)
    assert (fl.val[:2] > 0).all()
    assert tr._affine.valid.tolist() == [False] * 2 + [True] * 6
    tr.track_features(frames[1], frames[2], fl)
    assert (fl.val == kt.TRACKED).all() and tr._affine.valid.all()


def test_tracker_rejects_a_frame_of_another_size(frames):
    tr = kt.KLTracker(kt.TrackingConfig(sequential_mode=True), device="cpu")
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
        "from klt_tpu_torch.runtime.pipeline import (track_sequence,\n"
        "    track_sequence_replace)\n"
        "from chip_smoke import synthetic_frames\n"
        "kt.set_verbosity(0)\n"
        "fr = synthetic_frames(3)\n"
        "cfg = kt.TrackingConfig(sequential_mode=True)\n"
        "fl = kt.FeatureList.create(20)\n"
        "tr = kt.KLTracker(cfg, device='cpu')\n"
        "tr.select_good_features(fr[0], fl)\n"
        "tr.track_features(fr[0], fr[1], fl)\n"
        "tr.replace_lost_features(fr[1], fl)\n"
        "xs, ys, vs = track_sequence(torch.from_numpy(fr),\n"
        "    *[torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)], cfg)\n"
        "track_sequence_replace(torch.from_numpy(fr),\n"
        "    *[torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)], cfg)\n"
        "bx, by, bv = kt.track_sequences_batched(\n"
        "    torch.from_numpy(fr[None]),\n"
        "    *[torch.from_numpy(a[None]) for a in (fl.x, fl.y, fl.val)],\n"
        "    cfg)\n"
        "assert torch.equal(bx[:, 0], xs) and torch.equal(bv[:, 0], vs)\n"
        "kt.track_sequence_replace_exact(torch.from_numpy(fr),\n"
        "    *[torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)], cfg)\n"
        "fp = kt.FeatureList.create(20)\n"
        "kt.KLTracker(cfg, device='cpu', prefilter=True)\\\n"
        "    .select_good_features(fr[0], fp)\n"
        "assert (fp.val == fl.val).all() or fp.count_remaining() > 10\n"
        "from klt_tpu_torch import slam, interop\n"
        "from klt_tpu_torch.slam import frontend, geometry, pose_graph\n"
        "from klt_tpu_torch.io import dataset\n"
        "from klt_tpu_torch.examples import slam_pipeline\n"
        "rng = np.random.RandomState(0)\n"
        "lm = rng.uniform([-2, -2, 4], [2, 2, 8], (30, 3)).astype('f4')\n"
        "cam = np.repeat(np.arange(3, dtype='i4'), 30)\n"
        "lmi = np.tile(np.arange(30, dtype='i4'), 3)\n"
        "pc = lm[lmi] + np.array([[0.1, 0, 0]], 'f4') * cam[:, None]\n"
        "uv = (300 * pc[:, :2] / pc[:, 2:] + 160).astype('f4')\n"
        "R, t, c = frontend.keyframe_pose_graph_init(lmi, cam, uv[:, 0],\n"
        "    uv[:, 1], 3, 300.0, 300.0, 160.0, 160.0, device='cpu')\n"
        "prob = slam.BAProblem(torch.from_numpy(R), torch.from_numpy(t),\n"
        "    torch.from_numpy(lm + 0.01), torch.from_numpy(cam),\n"
        "    torch.from_numpy(lmi), torch.from_numpy(uv),\n"
        "    torch.ones(90), 300.0, 300.0, 160.0, 160.0)\n"
        "out = slam.bundle_adjust_gated(prob, rounds=2, iterations=3)\n"
        "assert torch.isfinite(out[3]).all() and out[4].shape == (90,)\n"
        "assert not any(m == 'klt_tpu' or m.startswith(('klt_tpu.', 'jax.'))\n"
        "               for m in sys.modules)\n"
        "print('tracked', int((vs[-1] == 0).sum()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 10


# names that klt_tpu's packages export and the port never will, each with
# its reason; empty: every exported name has its counterpart
NEVER_PORTED = {}


def _packages_with_all():
    import importlib
    import pkgutil
    names = [""] + sorted(m.name for m in pkgutil.iter_modules(
        klt_tpu.__path__) if m.ispkg)
    for name in names:
        ref = importlib.import_module("klt_tpu" + (f".{name}" if name else ""))
        if hasattr(ref, "__all__"):
            yield name, ref


def test_port_exports_every_name_klt_tpu_does():
    """For klt_tpu and each of its subpackages with an __all__, the
    port's package of the same name exports every name, less
    NEVER_PORTED."""
    import importlib
    seen = []
    for name, ref in _packages_with_all():
        port = importlib.import_module(
            "klt_tpu_torch" + (f".{name}" if name else ""))
        missing = set(ref.__all__) - set(port.__all__) - set(NEVER_PORTED)
        assert not missing, (name or "klt_tpu_torch", sorted(missing))
        for n in port.__all__:
            assert hasattr(port, n), (name, n)
        seen.append(name)
    assert {"", "io", "ops", "parallel", "runtime", "slam",
            "utils"} <= set(seen)


def test_port_sources_import_neither_jax_nor_klt_tpu():
    pat = re.compile(r"^\s*(import|from)\s+\.*(jax|klt_tpu)\b", re.M)
    pkg = os.path.join(ROOT, "klt_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def _port_files(*suffixes):
    pkg = os.path.join(ROOT, "klt_tpu_torch")
    return [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
            if f.endswith(suffixes)] + (
        [os.path.join(ROOT, "chip_smoke.py")] if ".py" in suffixes else [])


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant):
            yield node.body[0].value


def test_port_opens_and_compiles_no_file_of_klt_tpu():
    """No string of the port's code is a path into klt_tpu/ (or its first
    component, as in os.path.join("klt_tpu", ...)): only docstrings and
    the kernels' `replaces=` metadata cite the reference.  No C or CUDA
    source of the port includes a file of klt_tpu/."""
    py = _port_files(".py")
    assert len(py) > 15
    for path in py:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        cited = {id(c) for c in _docstrings(tree)}
        for node in ast.walk(tree):
            if isinstance(node, ast.keyword) and node.arg == "replaces":
                cited.add(id(node.value))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and id(node) not in cited:
                s = node.value.replace("\\", "/")
                assert s != "klt_tpu" and "klt_tpu/" not in s.replace(
                    "klt_tpu_torch/", ""), (path, node.lineno, s)
    native = _port_files(".c", ".cu", ".h", ".cuh")
    assert len(native) >= 6
    names = {os.path.relpath(p, os.path.join(ROOT, "klt_tpu_torch"))
             for p in native}
    assert {"native/lk_exact_ref.c", "csrc/exact.cu",
            "csrc/lk_exact_lane.h"} <= names
    inc = re.compile(r'^\s*#\s*include\s*[<"]([^>"]*)[>"]', re.M)
    for path in native:
        with open(path) as f:
            for name in inc.findall(f.read()):
                assert "klt_tpu/" not in name, (path, name)


def test_native_source_is_a_copy_of_klt_tpus():
    """The port builds its own kltnative.c; a later edit to either copy
    shows here."""
    from klt_tpu_torch import native
    assert os.path.dirname(native._SRC) == os.path.dirname(native.__file__)
    with open(native._SRC, "rb") as a, \
            open(os.path.join(ROOT, "klt_tpu", "native", "kltnative.c"),
                 "rb") as b:
        assert a.read() == b.read()
    assert os.path.commonpath([native._LIB, os.path.join(
        ROOT, "build", "klt_tpu_torch")]) == os.path.join(
        ROOT, "build", "klt_tpu_torch")


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
