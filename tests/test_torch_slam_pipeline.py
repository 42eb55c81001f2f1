"""The tracking-to-mapping flow of klt_tpu's bench (bench_slam_e2e) and
examples/slam_pipeline.py, held end to end against klt_tpu on the CPU at
a small size: 20 frames of a 96x128 crop of chip_smoke.synthetic_frames
(two regions going flat), 60 features; track_sequence_replace (the port's plain versions, klt_tpu's
XLA path) -> feature table -> chains -> keyframes ->
keyframe_pose_graph_init -> bundle_adjust_gated (the hand-off of
klt_tpu_torch/examples/slam_pipeline.py, klt_tpu's bench's)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
from chip_smoke import synthetic_frames
from klt_tpu.runtime.pipeline import track_sequence_replace as jreplace
from klt_tpu.slam import bundle_adjust_gated as jgated
from klt_tpu.slam import select_keyframes as jkeyframes
from klt_tpu.slam import tracks_from_table as jtracks
from klt_tpu.slam.ba import BAProblem as JBAProblem
from klt_tpu.slam.frontend import keyframe_pose_graph_init as jinit
import klt_tpu_torch as kt
from klt_tpu_torch.interop import config_from_fields, features_from_numpy
from klt_tpu_torch.runtime.pipeline import track_sequence_replace
from klt_tpu_torch.examples.slam_pipeline import (keyframe_observations,
                                                  unit_depth_landmarks)
from klt_tpu_torch.slam import BAProblem, bundle_adjust_gated
from klt_tpu_torch.slam.ba import _residual_norms
from klt_tpu_torch.slam.frontend import keyframe_pose_graph_init

POS_TOL = 1e-3     # px, as tests/test_torch_slice.py
# the back end fed tracks that differ by up to POS_TOL px (measured:
# 2.3e-5): poses within POSE_TOL (measured: 3.6e-6), the gated BA's cost
# curve within COST_TOL relative (measured: 3.2e-5)
POSE_TOL = 1e-4
COST_TOL = 1e-3
N_FRAMES, N_FEAT = 20, 60
GATED = dict(rounds=3, iterations=8, robust_delta=2.0, gate_px=2.0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads for this module's small tensors: pytest-xdist
    runs several workers on the cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def intrinsics(shape):
    h, w = shape
    return 0.9 * w, 0.9 * w, w / 2.0, h / 2.0


@pytest.fixture(scope="module")
def flows():
    """Both packages' flows, each from its own table."""
    import os
    frames = synthetic_frames(N_FRAMES)[:, 70:166, 100:228].copy()
    # two regions go flat (frames 5 and 12 on): their features are lost
    # and replaced elsewhere, which opens keyframes
    frames[5:, 8:48, 8:60] = 128
    frames[12:, 50:90, 64:120] = 128
    cfg = kt.TrackingConfig(sequential_mode=True)
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True)
    assert config_from_fields(dataclasses.asdict(jcfg)) == cfg
    fl = kt.FeatureList.create(N_FEAT)
    kt.KLTracker(cfg, device="cpu").select_good_features(frames[0], fl)
    out = {}
    saved = os.environ.get("KLT_TPU_NO_PALLAS")
    os.environ["KLT_TPU_NO_PALLAS"] = "1"
    try:
        jout = jreplace(jnp.asarray(frames), jnp.asarray(fl.x),
                        jnp.asarray(fl.y), jnp.asarray(fl.val), jcfg)
    finally:
        if saved is None:
            os.environ.pop("KLT_TPU_NO_PALLAS")
        else:
            os.environ["KLT_TPU_NO_PALLAS"] = saved
    tout = track_sequence_replace(torch.from_numpy(frames),
                                  *features_from_numpy(fl.x, fl.y, fl.val),
                                  cfg)
    consts = intrinsics(frames.shape[1:])
    for name, run in (("ours", [o.numpy() for o in tout]),
                      ("ref", [np.asarray(o) for o in jout])):
        table = kt.FeatureTable.create(N_FRAMES, N_FEAT)
        table.store_list(fl, 0)
        table.x[:, 1:], table.y[:, 1:], table.val[:, 1:] = \
            (a.T for a in run)
        kfs, lm_idx, cam, u, v = keyframe_observations(table)
        out[name] = {"table": table, "kfs": kfs, "lm_idx": lm_idx,
                     "cam": cam, "u": u, "v": v,
                     "lm0": unit_depth_landmarks(lm_idx, u, v, *consts)}
    for name, init, mk, gated in (
            ("ours", lambda *a: keyframe_pose_graph_init(*a, device="cpu"),
             lambda **k: BAProblem(**{n: torch.from_numpy(np.asarray(a))
                                      if isinstance(a, np.ndarray) else a
                                      for n, a in k.items()}),
             bundle_adjust_gated),
            ("ref", jinit,
             lambda **k: JBAProblem(**{n: jnp.asarray(a)
                                       if isinstance(a, np.ndarray) else a
                                       for n, a in k.items()}),
             jgated)):
        o = out[name]
        n_pose = len(o["kfs"])
        R0, t0, pg_costs = init(o["lm_idx"], o["cam"], o["u"], o["v"],
                                n_pose, *consts)
        prob = mk(R=R0, t=t0, landmarks=o["lm0"], cam_idx=o["cam"],
                  lm_idx=o["lm_idx"],
                  uv=np.stack([o["u"], o["v"]], -1).astype(np.float32),
                  weight=np.ones(len(o["cam"]), np.float32),
                  fx=consts[0], fy=consts[1], cx=consts[2], cy=consts[3])
        R, t, lm, costs, active = gated(prob, **GATED)
        o.update(R0=R0, t0=t0, pg_costs=np.asarray(pg_costs), prob=prob,
                 R=np.asarray(R), t=np.asarray(t), lm=np.asarray(lm),
                 costs=np.asarray(costs), active=np.asarray(active))
    return out


def test_flow_matches_klt_tpu(flows):
    """One test for the whole flow (pytest-xdist may run a module's tests
    in several workers, each computing the module's fixtures): the
    tables, then keyframes and observation lists, then the back end."""
    a, b = flows["ours"]["table"], flows["ref"]["table"]
    np.testing.assert_array_equal(a.val, b.val)
    np.testing.assert_allclose(a.x, b.x, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(a.y, b.y, rtol=0, atol=POS_TOL)
    assert (a.val[:, 1:] > 0).sum() >= 10  # replacement ran

    a, b = flows["ours"], flows["ref"]
    j = jtracks(b["table"].x, b["table"].y, b["table"].val, min_length=3)
    assert len(j[0]) > 0
    np.testing.assert_array_equal(
        a["kfs"], jkeyframes(b["table"].val, overlap_thresh=0.8))
    assert len(a["kfs"]) >= 3
    for k in ("kfs", "lm_idx", "cam"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("u", "v"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=POS_TOL)

    for k in ("R0", "t0", "R", "t"):
        err = np.abs(a[k] - b[k]).max()
        assert err <= POSE_TOL, (k, err)
    rel = np.abs(a["costs"] / b["costs"] - 1).max()
    assert rel <= COST_TOL, rel
    assert (a["active"] == b["active"]).mean() >= 0.99
    assert a["costs"][-1] < a["costs"][0]
    # bench.py's reading: the inlier RMS over the active set
    rn = _residual_norms(torch.from_numpy(a["R"]), torch.from_numpy(a["t"]),
                         torch.from_numpy(a["lm"]), a["prob"]).numpy()
    inl = a["active"] & (rn <= 2.0)
    assert inl.mean() >= 0.9 and np.sqrt(np.mean(rn[inl] ** 2)) < 0.5


def test_dataset_and_pgm_batch_loader_equal_klt_tpus(tmp_path, monkeypatch):
    """PGM frames written with io/pnm.write_pgm: find_dataset,
    ImageSequence (numeric order), load_sequence and the threaded
    load_pgm_batch behind load_sequence_array give klt_tpu's frames; a
    file of another size raises naming it."""
    import klt_tpu.io.dataset as jds
    import klt_tpu.native as jnative
    from klt_tpu_torch import native
    from klt_tpu_torch.io import dataset
    from klt_tpu_torch.io.pnm import write_pgm
    seq = tmp_path / "images_test"
    seq.mkdir()
    frames = synthetic_frames(12)[:, :40, :56]
    for i, f in enumerate(frames):
        write_pgm(str(seq / f"img{i}.pgm"), f)
    monkeypatch.setenv("KLT_DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jds, "_DEFAULT_ROOTS", (str(tmp_path),))
    assert dataset.find_dataset("images_test") == jds.find_dataset(
        "images_test") == str(seq)
    assert dataset.find_dataset("images_none") is None
    ours, ref = dataset.ImageSequence(str(seq)), jds.ImageSequence(str(seq))
    assert ours.indices == ref.indices == list(range(12))
    assert (ours.nrows, ours.ncols) == (40, 56)
    np.testing.assert_array_equal(np.stack(dataset.load_sequence(
        "images_test", 5)), np.stack(jds.load_sequence("images_test", 5)))
    arr = dataset.load_sequence_array("images_test")
    np.testing.assert_array_equal(arr, frames)
    np.testing.assert_array_equal(arr, jds.load_sequence_array(
        "images_test"))
    paths = ours.paths()
    np.testing.assert_array_equal(
        native.load_pgm_batch(paths[::-1], 40, 56, n_threads=3),
        jnative.load_pgm_batch(paths[::-1], 40, 56, n_threads=3))
    write_pgm(str(seq / "img7.pgm"), frames[7][:, :50])
    with pytest.raises(OSError, match="img7.pgm"):
        native.load_pgm_batch(paths, 40, 56)


@pytest.mark.parametrize("host", [False, True])
def test_slam_pipeline_example_runs_on_the_cpu(host, capsys):
    """python -m klt_tpu_torch.examples.slam_pipeline with no dataset
    found: synthetic frames, the front end (chunked device run or the
    host KLTracker loop), chains, keyframes, pose graph and BA; the
    summary line's reprojection error falls."""
    import json
    from klt_tpu_torch.examples import slam_pipeline
    argv = ["images_none", "80", "12", "--device", "cpu", "--chunk", "5"]
    assert slam_pipeline.main(argv + (["--host"] if host else [])) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dataset"] == "synthetic" and out["n_keyframes"] >= 3
    assert out["reproj_rms_px_after"] < out["reproj_rms_px_before"]
    assert out["ba_solver"] == "schur-dense"


def test_slam_pipeline_example_needs_the_card_by_default():
    from klt_tpu_torch.examples import slam_pipeline
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slam_pipeline.main(["images_none", "20", "3"])
