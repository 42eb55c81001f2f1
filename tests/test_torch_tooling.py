"""The port's tooling (klt_tpu_torch/utils/{checks,debug,profiling}.py,
io/dataset.py's download, examples/track_sequence.py, graft_entry.py)
held against klt_tpu's on the CPU, at 64x80 frames."""

import gzip
import importlib.util
import io
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import synthetic_frames
from klt_tpu_torch.io.features_io import read_feature_table
from klt_tpu_torch.io.pnm import write_pgm
from klt_tpu_torch.utils import checks, debug, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# px, as tests/test_torch_slice.py: XLA sums a window in another order
POS_TOL = 1e-3


def _warned(fn) -> list[str]:
    """The messages of the warnings fn() gives (after jax's callbacks
    have run)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
        jax.effects_barrier()
    return [str(w.message) for w in caught
            if "debug check" in str(w.message)]


def _raised(fn) -> str | None:
    try:
        fn()
    except AssertionError as e:
        return str(e)
    return None


COORDS = {"inside": ([0.0, 79.0, 40.5], [0.0, 63.0, 10.0]),
          "left": ([-0.5, 3.0, 4.0], [5.0, 5.0, 5.0]),
          "right": ([79.25], [5.0]), "below": ([3.0, 2.0], [1.0, 63.5])}


@pytest.mark.parametrize("debug_env", [None, "0", "1"])
def test_checks_warn_as_klt_tpus(monkeypatch, debug_env):
    from klt_tpu.utils import checks as jchecks
    if debug_env is None:
        monkeypatch.delenv("KLT_TPU_DEBUG", raising=False)
    else:
        monkeypatch.setenv("KLT_TPU_DEBUG", debug_env)
    on = debug_env == "1"
    assert checks.debug_enabled() == jchecks.debug_enabled() == on
    for name, (x, y) in COORDS.items():
        ref = _warned(lambda: jchecks.check_in_bounds(
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), 80,
            64, name))
        got = _warned(lambda: checks.check_in_bounds(
            torch.tensor(x), torch.tensor(y), 80, 64, name))
        assert got == ref, name
        assert len(got) == (on and name != "inside")
    for arr in ([1.0, 2.0], [1.0, float("nan")], [float("inf")]):
        ref = _warned(lambda: jchecks.check_finite(jnp.asarray(arr), "v"))
        assert _warned(lambda: checks.check_finite(torch.tensor(arr),
                                                   "v")) == ref
    # klt_tpu's shape check raises (chex); the port's warns, same text
    a, b = np.zeros((3, 4)), np.zeros((3, 5))
    for other in (a, b):
        ref = _raised(lambda: jchecks.check_same_shape(jnp.asarray(a),
                                                       jnp.asarray(other),
                                                       "frame pair"))
        got = _warned(lambda: checks.check_same_shape(
            torch.from_numpy(a), torch.from_numpy(other), "frame pair"))
        assert (ref is None) == (got == [])
        if ref is not None:
            assert "frame pair mismatch" in ref and \
                "frame pair mismatch" in got[0]


def test_tracking_checks_its_inputs_in_debug_mode(monkeypatch):
    """One feature outside the frame: one warning in debug mode, none
    without, and the same table."""
    frames = torch.from_numpy(synthetic_frames(3)[:, 80:144, 120:200])
    x = torch.tensor([40.0, -5.0, 30.0])
    y = torch.tensor([30.0, 20.0, 70.0])
    val = torch.tensor([0, 0, -1], dtype=torch.int32)
    cfg = kt.TrackingConfig()
    from klt_tpu_torch.runtime.pipeline import track_sequence
    out = {}
    for env in ("0", "1"):
        monkeypatch.setenv("KLT_TPU_DEBUG", env)
        msgs = _warned(lambda: out.setdefault(env, track_sequence(
            frames, x, y, val, cfg)))
        assert msgs == ([] if env == "0" else
                        ["debug check failed: input feature positions out "
                         "of bounds"])
    for a, b in zip(out["0"], out["1"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cfg_kw", [{}, {"affine_consistency_check": 2,
                                         "n_pyramid_levels": 4,
                                         "subsampling": 2,
                                         "min_determinant": 0.0125}])
def test_print_tracking_config_text_is_klt_tpus(cfg_kw):
    from klt_tpu.utils.debug import print_tracking_config as jprint
    ref, got = io.StringIO(), io.StringIO()
    jprint(klt_tpu.TrackingConfig(**cfg_kw), ref)
    debug.print_tracking_config(kt.TrackingConfig(**cfg_kw), got)
    assert got.getvalue() == ref.getvalue()
    assert "affineConsistencyCheck" in got.getvalue()


def test_write_internal_images_bytes_are_klt_tpus(tmp_path):
    from klt_tpu.utils.debug import write_internal_images as jwrite
    rng = np.random.RandomState(3)
    shapes = ((16, 20), (8, 10))
    pyr = [rng.uniform(0, 255, s).astype(np.float32) for s in shapes]
    gx = [rng.normal(0, 9, s).astype(np.float32) for s in shapes]
    gy = [np.full(s, 2.5, np.float32) for s in shapes]   # flat: mx == mn
    ref = jwrite(pyr, gx, gy, str(tmp_path / "ref"), "7")
    got = debug.write_internal_images(pyr, gx, gy, str(tmp_path / "port"),
                                      "7")
    tens = debug.write_internal_images(
        [torch.from_numpy(a) for a in pyr], [torch.from_numpy(a) for a in gx],
        [torch.from_numpy(a) for a in gy], str(tmp_path / "tens"), "7")
    assert len(ref) == len(got) == len(tens) == 6
    for r, g, t in zip(ref, got, tens):
        assert os.path.basename(g).replace("port", "ref") == \
            os.path.basename(r)
        with open(r, "rb") as f:
            want = f.read()
        for p in (g, t):
            with open(p, "rb") as f:
                assert f.read() == want, p


def _trace_file(tmp_path, events) -> str:
    """A Chrome trace as torch.profiler writes it (gzip), with these
    events."""
    d = tmp_path / "trace"
    d.mkdir()
    path = d / "host_1.1.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(d)


def _ev(cat, name, ts, dur, tid=7, pid=0):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def test_op_breakdown_self_times_by_hand(tmp_path):
    events = [
        _ev("kernel", "k_before", 0, 50),              # before the window
        _ev("kernel", "spin_kernel(long)", 100, 10),   # opens it
        _ev("kernel", "lk", 200, 100),                 # holds a copy
        _ev("gpu_memcpy", "Memcpy DtoD", 220, 30),     # nested in lk
        _ev("kernel", "lk", 400, 60),
        _ev("kernel", "pyr", 410, 20, tid=8),          # another stream
        _ev("cpu_op", "aten::add", 150, 500, tid=1),   # host: not read
        _ev("gpu_memset", "Memset", 600, 5),
        _ev("kernel", "spin_kernel(long)", 900, 10),   # closes it
        _ev("kernel", "k_after", 1000, 70),
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    rows = profiling.op_breakdown(_trace_file(tmp_path, events), runs=2)
    # lk: 100 - 30 (its nested copy) + 60 = 130 over 2 runs
    assert rows == [(65.0, 1.0, "kernel", "lk"),
                    (15.0, 0.5, "gpu_memcpy", "Memcpy DtoD"),
                    (10.0, 0.5, "kernel", "pyr"),
                    (2.5, 0.5, "gpu_memset", "Memset")]
    buf = io.StringIO()
    sys_stdout, sys.stdout = sys.stdout, buf
    try:
        profiling.print_breakdown(str(tmp_path / "trace"), runs=2, top=1)
    finally:
        sys.stdout = sys_stdout
    assert buf.getvalue().split() == ["65.0", "us", "n=", "1.0", "kernel",
                                      "lk"]


def test_op_breakdown_reads_no_trace_without_markers(tmp_path):
    d = _trace_file(tmp_path, [_ev("kernel", "lk", 0, 5),
                               _ev("kernel", "spin_kernel(long)", 9, 1)])
    with pytest.raises(ValueError, match="1 of the 2 marker"):
        profiling.op_breakdown(d)
    with pytest.raises(FileNotFoundError):
        profiling.op_breakdown(str(tmp_path / "none"))


def test_trace_on_the_cpu_writes_a_host_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    with pytest.raises(ValueError, match="no device event"):
        profiling.op_breakdown(str(tmp_path / "t"))


def test_download_dataset_without_the_network(tmp_path):
    from klt_tpu_torch.io import dataset
    with pytest.raises(KeyError, match="unknown dataset"):
        dataset.download_dataset("images_nowhere", str(tmp_path))
    (tmp_path / "images_traffic").mkdir()
    assert dataset.download_dataset("images_traffic", str(tmp_path)) == \
        os.path.join(str(tmp_path), "images_traffic")
    from klt_tpu.io.dataset import DATASET_URLS
    assert dataset.DATASET_URLS == DATASET_URLS


# ------------------------------------------------------------------ #
# the examples and the graft entry                                     #
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """8 frames of 64x80 (a crop of chip_smoke.py's synthetic frames
    with a flat patch from frame 3, so features are lost) as
    images_tiny/imgN.pgm."""
    root = tmp_path_factory.mktemp("data")
    d = root / "images_tiny"
    d.mkdir()
    frames = synthetic_frames(8)[:, 80:144, 120:200].copy()
    frames[3:, 20:40, 30:60] = 128
    for i, f in enumerate(frames):
        write_pgm(str(d / f"img{i}.pgm"), f)
    return str(root)


def _klt_tpu_example(monkeypatch, data_root, argv):
    from klt_tpu.io import dataset as jdataset
    monkeypatch.setattr(jdataset, "_DEFAULT_ROOTS", (data_root,))
    spec = importlib.util.spec_from_file_location(
        "klt_tpu_track_sequence_example",
        os.path.join(ROOT, "examples", "track_sequence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["track_sequence.py"] + argv)
    mod.main()


@pytest.mark.parametrize("mode", [[], ["--replace"]], ids=str)
def test_track_sequence_example_matches_klt_tpus(monkeypatch, tmp_path,
                                                 data_root, mode):
    from klt_tpu_torch.examples import track_sequence
    monkeypatch.setenv("KLT_DATA_ROOT", data_root)
    args = ["images_tiny", "20", "8"] + mode
    _klt_tpu_example(monkeypatch, data_root,
                     args + ["--out", str(tmp_path / "ref")])
    assert track_sequence.main(args + ["--out", str(tmp_path / "port"),
                                       "--device", "cpu",
                                       "--overlays"]) == 0
    ref = read_feature_table(str(tmp_path / "ref" / "features.ft"))
    got = read_feature_table(str(tmp_path / "port" / "features.ft"))
    np.testing.assert_array_equal(got.val, ref.val)
    np.testing.assert_allclose(got.x, ref.x, atol=POS_TOL)
    np.testing.assert_allclose(got.y, ref.y, atol=POS_TOL)
    assert (got.val == 0).sum() > 20 and (got.val < 0).any()
    txt = read_feature_table(str(tmp_path / "port" / "features.txt"))
    np.testing.assert_array_equal(txt.val, got.val)
    assert os.path.exists(tmp_path / "port" / "feat7.ppm")


def test_track_sequence_example_affine_and_exit(monkeypatch, tmp_path,
                                                data_root):
    """--affine 2 runs and kills or keeps its features; no dataset: exit
    with klt_tpu's message."""
    from klt_tpu_torch.examples import track_sequence
    monkeypatch.setenv("KLT_DATA_ROOT", data_root)
    out = tmp_path / "aff"
    assert track_sequence.main(["images_tiny", "20", "8", "--affine", "2",
                                "--out", str(out), "--device", "cpu"]) == 0
    ft = read_feature_table(str(out / "features.ft"))
    assert ft.val.shape == (20, 8) and np.isfinite(ft.x).all()
    with pytest.raises(SystemExit, match="dataset 'nowhere' not found"):
        track_sequence.main(["nowhere", "--device", "cpu"])


def test_graft_entry_matches_klt_tpus():
    import __graft_entry__ as jentry
    from klt_tpu_torch import graft_entry
    jfn, jargs = jentry.entry()
    ref = [np.asarray(o) for o in jax.jit(jfn)(*jargs)]
    fn, args = graft_entry.entry(device="cpu")
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    got = [o.numpy() for o in fn(*args)]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0], atol=POS_TOL)
    np.testing.assert_allclose(got[1], ref[1], atol=POS_TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()


def test_dryrun_multichip_in_a_world_of_one():
    from klt_tpu_torch import graft_entry
    assert not dist.is_initialized()
    try:
        graft_entry.dryrun_multichip(1, device="cpu")
        assert dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="needs a world of 2"):
            graft_entry.dryrun_multichip(2, device="cpu")
    finally:
        dist.destroy_process_group()
