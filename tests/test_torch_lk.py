"""The port's coarse-to-fine LK (plain torch version of kernel B) held
against klt_tpu on identical pyramid stacks: its XLA path
(KLT_TPU_NO_PALLAS=1) and its Pallas LK kernel in interpret mode.  Kernel
B itself is held against the plain version on a card in
test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
from klt_tpu_torch.config import (TRACKED, SMALL_DET, MAX_ITERATIONS, OOB)
from klt_tpu_torch.interop import (config_from_fields, features_from_numpy,
                                   stacks_from_numpy)
from klt_tpu_torch.ops.lk import (track_features_pyramid,
                                  track_features_pyramid_stacks, track_level)
from chip_smoke import bilinear_warp
from conftest import load_f32

# px; XLA sums a window in another order than the port, whose order is the
# LK kernels' warp's (ops/lk.py::_window_sum); measured: 3.05e-5 px
POS_TOL = 1e-3
N_FEAT = 32


def crop(img, shift=(0.0, 0.0)):
    """64x80 crop of the fixture scene, translated by shift = (tx, ty)."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    moved = bilinear_warp(img, xx - shift[0], yy - shift[1])
    return np.clip(np.rint(moved[80:144, 120:200]), 0, 255).astype(np.uint8)


def make_case(name):
    """(cfg kwargs, frame 1, frame 2, x, y, val, status the case must hit)."""
    scene = load_f32("smoothed_img0.f32", (240, 320)).astype(np.float64)
    rng = np.random.RandomState(11)
    kw, expect = {}, TRACKED
    img1, img2 = crop(scene), crop(scene, (1.3, -0.7))
    x = rng.uniform(12, 68, N_FEAT)
    y = rng.uniform(12, 52, N_FEAT)
    if name == "lighting":
        kw = {"lighting_insensitive": True}
        img2 = np.clip(1.2 * img2.astype(np.float64) + 10, 0,
                       255).astype(np.uint8)
    elif name == "oob":
        img2 = crop(scene, (6.0, 0.5))
        x[:8] = rng.uniform(64, 72, 8)  # pushed past the right edge
        expect = OOB
    elif name == "small_det":
        img1[:, :36] = 128  # flat patch: a singular gradient matrix
        img2[:, :36] = 128
        x[:8] = rng.uniform(8, 24, 8)
        expect = SMALL_DET
    elif name == "max_iterations":
        kw = {"max_iterations": 2, "min_displacement": 1e-4}
        expect = MAX_ITERATIONS
    val = np.full(N_FEAT, 100, np.int32)
    val[-2:] = [-1, -4]  # lost features pass through
    return (kw, img1, img2, x.astype(np.float32), y.astype(np.float32), val,
            expect)


CASES = ["default", "lighting", "oob", "small_det", "max_iterations"]


def numpy_stacks(img, jcfg, monkeypatch):
    from klt_tpu.ops.pyramid import build_pyramid_stacks
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    out = [np.asarray(s) for s in
           jax.jit(lambda im: build_pyramid_stacks(im, jcfg))(
               jnp.asarray(img))]
    monkeypatch.delenv("KLT_TPU_NO_PALLAS")
    return out


def run_both(name, monkeypatch, mode):
    """Track one frame pair with klt_tpu (mode: 'xla' or 'interpret') and
    with the port's plain path, from identical numpy stacks."""
    from klt_tpu.ops.lk import track_features_pyramid_stacks as jtrack
    kw, img1, img2, x, y, val, expect = make_case(name)
    jcfg = klt_tpu.TrackingConfig(**kw)
    st1 = numpy_stacks(img1, jcfg, monkeypatch)
    st2 = numpy_stacks(img2, jcfg, monkeypatch)
    if mode == "xla":
        monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    else:
        from klt_tpu.pallas import lk as pk, lk2
        monkeypatch.setenv("KLT_TPU_PALLAS_INTERPRET", "1")
        pk._inner_call.cache_clear()
        lk2._inner_call.cache_clear()
    ref = jax.jit(lambda a, b, *f: jtrack(list(a), list(b), *f, jcfg))(
        [jnp.asarray(s) for s in st1], [jnp.asarray(s) for s in st2],
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(val))
    if mode != "xla":
        pk._inner_call.cache_clear()
        lk2._inner_call.cache_clear()
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    ours = track_features_pyramid_stacks(stacks_from_numpy(st1),
                                         stacks_from_numpy(st2),
                                         *features_from_numpy(x, y, val), cfg)
    return [np.asarray(r) for r in ref], [o.numpy() for o in ours], expect


def assert_same_tracks(ours, ref, expect):
    np.testing.assert_array_equal(ours[2], ref[2])  # statuses exact
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=POS_TOL)
    assert (ours[2] == expect).any(), f"case never reached status {expect}"


@pytest.mark.parametrize("name", CASES)
def test_matches_xla_path(name, monkeypatch):
    ref, ours, expect = run_both(name, monkeypatch, "xla")
    assert_same_tracks(ours, ref, expect)


@pytest.mark.parametrize("name", CASES)
def test_matches_pallas_kernel_interpret(name, monkeypatch):
    ref, ours, expect = run_both(name, monkeypatch, "interpret")
    assert_same_tracks(ours, ref, expect)


def test_separate_maps_entry_equals_stacks_entry(monkeypatch):
    kw, img1, img2, x, y, val, _ = make_case("default")
    jcfg = klt_tpu.TrackingConfig(**kw)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    st1 = stacks_from_numpy(numpy_stacks(img1, jcfg, monkeypatch))
    st2 = stacks_from_numpy(numpy_stacks(img2, jcfg, monkeypatch))
    feats = features_from_numpy(x, y, val)
    a = track_features_pyramid_stacks(st1, st2, *feats, cfg)
    b = track_features_pyramid(*[[s[c] for s in st] for st in (st1, st2)
                                 for c in range(3)], *feats, cfg)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_level_smaller_than_window_is_oob():
    from klt_tpu.ops.lk import track_level as jlevel
    jcfg = klt_tpu.TrackingConfig()
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    rng = np.random.RandomState(0)
    st = rng.rand(3, 6, 7).astype(np.float32)
    x = np.array([3.0, 3.5, 2.0], np.float32)
    act = np.array([True, False, True])
    ref = jlevel(jnp.asarray(st), jnp.asarray(st), jnp.asarray(x),
                 jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                 jnp.asarray(act), jcfg)
    t = torch.from_numpy(st)
    tx = torch.from_numpy(x)
    ours = track_level(t, t, tx, tx, tx, tx, torch.from_numpy(act), cfg)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert ours[2].tolist() == [OOB, TRACKED, OOB]


def test_cuda_wrapper_refuses_cpu_tensors():
    from klt_tpu_torch.cuda.lk_level import lk_level_cuda
    cfg = config_from_fields(dataclasses.asdict(klt_tpu.TrackingConfig()))
    st = torch.zeros(3, 20, 20)
    x = torch.full((4,), 10.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk_level_cuda(st, st, x, x, x, x, x > 0, cfg)


def test_window_sampling_matches_klt_tpu():
    from klt_tpu.ops.interp import (bilinear_sample as jsample,
                                    sample_stack_windows as jwindows)
    from klt_tpu_torch.ops.interp import (bilinear_sample,
                                          sample_stack_windows)
    rng = np.random.RandomState(4)
    st = rng.rand(3, 30, 40).astype(np.float32) * 255
    x = rng.uniform(0, 39.5, 50).astype(np.float32)
    y = rng.uniform(0, 29.5, 50).astype(np.float32)
    ref = np.asarray(jsample(jnp.asarray(st[0]), jnp.asarray(x),
                             jnp.asarray(y)))
    ours = bilinear_sample(torch.from_numpy(st[0]), torch.from_numpy(x),
                           torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-4)
    # windows reaching past the right/bottom edges: starts clamp like
    # klt_tpu's dynamic_slice.  A negative start is clamped to 0 here, where
    # dynamic_slice first wraps it from the end; the tracker only samples
    # there at positions it then classifies OOB, so such centres are left
    # out of the comparison.
    ref = np.asarray(jwindows(jnp.asarray(st), jnp.asarray(x),
                              jnp.asarray(y), 7, 5))
    ours = sample_stack_windows(torch.from_numpy(st), torch.from_numpy(x),
                                torch.from_numpy(y), 7, 5).numpy()
    assert ours.shape == ref.shape == (3, 50, 35)
    keep = (x.astype(np.int32) >= 3) & (y.astype(np.int32) >= 2)
    assert 0 < keep.sum() < 50
    np.testing.assert_allclose(ours[:, keep], ref[:, keep], rtol=1e-6,
                               atol=1e-4)


def test_plain_sqrt_is_correctly_rounded():
    """The plain versions take square roots from ops/ieee.py: the IEEE
    operation, which the kernels and the C reference compute.  torch.sqrt
    on the CPU can land an ulp off (a vectorised approximation): that made
    the plain lighting-insensitive LK and the plain corner response on the
    CPU differ from the kernels on the card.  numpy's float32 sqrt is the
    IEEE operation and serves as the oracle."""
    from klt_tpu_torch.ops.ieee import sqrt_rn
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(0, 4, 200_000),
                        10.0 ** rng.uniform(-30, 30, 200_000),
                        rng.uniform(1e6, 1e9, 200_000)]).astype(np.float32)
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.sqrt(x).view(np.uint32))


def documented_window_sum(cells):
    """f32 sum of a window's row-major cells in the order csrc/lk_level.cu
    and ops/lk.py document, written out in numpy scalars: pad with +0.0 to
    a multiple of 32 cells; partial t starts from cell t and adds cells
    t + 32, t + 64, ...; the 32 partials fold 32 -> 16 -> ... -> 1,
    partial i + half added to partial i."""
    n = len(cells)
    cell = lambda c: cells[c] if c < n else np.float32(0.0)
    part = []
    for t in range(32):
        acc = cell(t)
        for k in range(1, -(-n // 32)):
            acc = np.float32(acc + cell(t + 32 * k))
        part.append(acc)
    half = 16
    while half:
        part = [np.float32(part[i] + part[i + half]) for i in range(half)]
        half //= 2
    return part[0]


@pytest.mark.parametrize("side", [3, 7, 15])
def test_window_sum_follows_the_documented_order(side):
    from klt_tpu_torch.ops.lk import _window_sum
    rng = np.random.RandomState(side)
    # magnitudes from 1e-3 to 1e5, both signs: every order rounds its own way
    v = (rng.normal(size=(40, side * side)) *
         10.0 ** rng.uniform(-3, 5, (40, side * side))).astype(np.float32)
    v[0] = -0.0  # a window of negative zeros meets the +0.0 padding
    got = _window_sum(torch.from_numpy(v)).numpy()
    want = np.array([documented_window_sum(row) for row in v], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    stacked = _window_sum(torch.from_numpy(np.stack([v, 2 * v]))).numpy()
    np.testing.assert_array_equal(stacked[0].view(np.uint32),
                                  want.view(np.uint32))
    # the order matters: summing cell by cell lands elsewhere on some rows
    serial = v[:, 0].copy()
    for k in range(1, v.shape[1]):
        serial = serial + v[:, k]
    assert (serial != want).any()


@pytest.mark.parametrize("side", [3, 15])
def test_other_window_sizes_match_xla_path(side, monkeypatch):
    """3x3 (9 cells, under one warp) and 15x15 (225 cells, 8 per thread)
    windows against klt_tpu's XLA path."""
    from klt_tpu.ops.lk import track_features_pyramid_stacks as jtrack
    _, img1, img2, x, y, val, _ = make_case("default")
    jcfg = klt_tpu.TrackingConfig(window_width=side, window_height=side,
                                  search_range=side)  # 2 levels, halved
    st1 = numpy_stacks(img1, jcfg, monkeypatch)
    st2 = numpy_stacks(img2, jcfg, monkeypatch)
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    ref = jax.jit(lambda a, b, *f: jtrack(list(a), list(b), *f, jcfg))(
        [jnp.asarray(s) for s in st1], [jnp.asarray(s) for s in st2],
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(val))
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    ours = track_features_pyramid_stacks(stacks_from_numpy(st1),
                                         stacks_from_numpy(st2),
                                         *features_from_numpy(x, y, val), cfg)
    ours = [o.numpy() for o in ours]
    ref = [np.asarray(r) for r in ref]
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=POS_TOL)
    # the 15x15 window's border leaves few of the 64x80 crop's features
    assert (ours[2] == TRACKED).sum() >= 3


def test_level_loop_is_the_cpu_path_and_reports_its_work(monkeypatch):
    """On the CPU track_features_pyramid_stacks is the torch level loop,
    the plain version of the LK pyramid kernels; with `stats` the loop
    reports each level's lanes and iterations."""
    from klt_tpu_torch.ops.lk import track_features_pyramid_levels
    kw, img1, img2, x, y, val, _ = make_case("oob")
    jcfg = klt_tpu.TrackingConfig(**kw)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    st1 = stacks_from_numpy(numpy_stacks(img1, jcfg, monkeypatch))
    st2 = stacks_from_numpy(numpy_stacks(img2, jcfg, monkeypatch))
    feats = features_from_numpy(x, y, val)
    stats = []
    a = track_features_pyramid_stacks(st1, st2, *feats, cfg)
    b = track_features_pyramid_levels(st1, st2, *feats, cfg, stats=stats)
    c = track_features_pyramid_stacks(st1, st2, *feats, cfg, plain=True)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v) and torch.equal(u, w)
    assert [s[0] for s in stats] == [1, 0]  # coarsest level first
    coarse, fine = stats[0][1], stats[1][1]
    assert coarse.sum() == (val >= 0).sum()
    assert fine.sum() < coarse.sum()  # lanes OOB at level 1 left the loop
    assert (stats[1][2][fine] >= 1).all() and (stats[1][2][~fine] == 0).all()


def pyramid_wrapper_args(fault, batched=False):
    """Inputs of an LK pyramid wrapper with one fault."""
    lead = (2,) if batched else ()
    kw = {}
    shapes = [(3, 40, 48), (3, 10, 12)]
    if fault == "levels":
        kw = {"n_pyramid_levels": 9, "subsampling": 2}
        shapes = [(3, 8, 8)] * 9
    cfg = config_from_fields(dataclasses.asdict(klt_tpu.TrackingConfig(**kw)))
    st1 = [torch.zeros(lead + s) for s in shapes]
    st2 = [torch.zeros(lead + s) for s in shapes]
    if fault == "shapes":
        st2[1] = torch.zeros(lead + (3, 10, 13))
    if fault == "strides":
        st1[0] = torch.zeros(lead + (3, 48, 40)).transpose(-1, -2)
        assert st1[0].shape == st2[0].shape
    x = torch.full(lead + (4,), 10.0)
    val = torch.zeros(lead + (4,), dtype=torch.int32)
    if fault == "sequences":
        x = torch.full((3, 4), 10.0)
    if fault == "dtype":
        val = val.long()
    return st1, st2, x, x.clone(), val, cfg


@pytest.mark.parametrize("fault,message", [
    ("cpu", "CUDA tensors"), ("shapes", "level 1 stacks must both be"),
    ("strides", "contiguous"), ("levels", "at most 8"),
    ("dtype", "val must be")])
def test_pyramid_wrapper_refuses(fault, message):
    from klt_tpu_torch.cuda.lk_level import lk_pyramid_cuda
    with pytest.raises(ValueError, match=message):
        lk_pyramid_cuda(*pyramid_wrapper_args(fault))
