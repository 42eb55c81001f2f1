"""The port's batched multi-sequence tier (parallel/batched_lk.py,
parallel/batch.py; kernel C's plain version `lk_level_batched_plain`) held
against klt_tpu's batched tier and against the port's own single-sequence
path.

The B = 3 sequences differ: each is a 64x80 crop of the fixture scene at
its own origin, moving by its own sub-pixel step per frame, with features
selected on its own frame 0 (so live counts differ) and the feature axis
padded with val = -1.  64x80 is the smallest size whose coarsest level
(16x20 at subsampling 4) keeps klt_tpu on its kernel path.  klt_tpu runs
three ways: its XLA path (KLT_TPU_NO_PALLAS=1), its Pallas kernel B
(pallas/lk2.py) in interpret mode, and its Pallas kernel C (pallas/lk.py,
KLT_TPU_LK_V1=1) in interpret mode.  Statuses must be exact on every lane
and frame; positions may differ by POS_TOL, since XLA:CPU rounds the
pyramid's convolution chains by context.  Kernel C itself is held against
the plain version on a card in test_torch_cuda.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import bilinear_warp
from conftest import load_f32
from klt_tpu_torch.config import MAX_ITERATIONS, OOB, SMALL_DET, TRACKED
from klt_tpu_torch.interop import (config_from_fields, features_from_numpy,
                                   stacks_from_numpy)
from klt_tpu_torch.ops.lk import (lk_level_batched_plain, lk_level_plain,
                                  track_features_pyramid_stacks, track_level)
from klt_tpu_torch.ops.pyramid import build_pyramid_stacks_plain
from klt_tpu_torch.cuda import graph
from klt_tpu_torch.runtime import pipeline
from klt_tpu_torch.parallel import (make_batch_step, make_fused_pair_step,
                                    pad_features_for_mesh, track_batch,
                                    track_features_pyramid_batched,
                                    track_sequences_batched)
from klt_tpu_torch.runtime.pipeline import track_sequence

POS_TOL = 1e-3  # px, as tests/test_torch_lk.py
B, T, H, W = 3, 4, 64, 80
ORIGINS = ((80, 120), (30, 40), (140, 210))  # (row, col) of each crop
STEPS = ((1.3, -0.7), (-0.8, 0.9), (0.6, 1.1))  # (tx, ty) px per frame
N_SELECT = (24, 18, 12)  # features selected per sequence
N_FEAT = 24  # the padded feature axis
CFGS = {"default": {}, "lighting": {"lighting_insensitive": True}}


def crop(b, shift, gain=1.0, bias=0.0):
    """Sequence b's 64x80 crop of the fixture scene translated by shift,
    as u8."""
    scene = load_f32("smoothed_img0.f32", (240, 320)).astype(np.float64)
    r0, c0 = ORIGINS[b]
    yy, xx = np.mgrid[r0:r0 + H, c0:c0 + W].astype(np.float64)
    moved = bilinear_warp(scene, xx - shift[0], yy - shift[1])
    return np.clip(np.rint(gain * moved + bias), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _sequences(lighting: bool):
    frames = np.empty((B, T, H, W), np.uint8)
    for b in range(B):
        for k in range(T):
            tx, ty = STEPS[b]
            # the lighting run also brightens every frame
            gain, bias = (1.0 + 0.08 * k, 4.0 * k) if lighting else (1, 0)
            frames[b, k] = crop(b, (k * tx, k * ty), gain, bias)
    x = np.zeros((B, N_FEAT), np.float32)
    y = np.zeros((B, N_FEAT), np.float32)
    val = np.full((B, N_FEAT), -1, np.int32)
    for b, n in enumerate(N_SELECT):
        fl = kt.FeatureList.create(n)
        kt.KLTracker(kt.TrackingConfig(mindist=3),
                     device="cpu").select_good_features(
            frames[b, 0], fl)
        x[b, :n], y[b, :n], val[b, :n] = fl.x, fl.y, fl.val
    return frames, x, y, val


def sequences(name="default"):
    """(frames u8 [B, T, H, W], x, y f32 [B, N], val i32 [B, N]), fresh
    copies."""
    return [a.copy() for a in _sequences(name == "lighting")]


def configs(name):
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True, **CFGS[name])
    return jcfg, config_from_fields(dataclasses.asdict(jcfg))


def assert_same_tracks(ours, ref):
    """Statuses exact on every frame and lane, positions within
    POS_TOL."""
    ours = [np.asarray(o) for o in ours]
    ref = [np.asarray(r) for r in ref]
    assert ours[2].shape == ref[2].shape
    np.testing.assert_array_equal(ours[2], ref[2])
    for a, r in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, r, rtol=0, atol=POS_TOL)


def assert_equal_all(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.fixture()
def pallas_caches():
    """klt_tpu's Pallas calls are lru_cached with the interpret flag baked
    in: clear them before and after a run that sets the flag."""
    from klt_tpu.pallas import lk as pk, lk2, pyramid as pp
    fns = (pk._inner_call, lk2._inner_call, pp._fused_call,
           pp._fused_call_batched)
    for fn in fns:
        fn.cache_clear()
    yield {"lk": pk._inner_call, "lk2": lk2._inner_call}
    for fn in fns:
        fn.cache_clear()


def set_mode(monkeypatch, mode):
    """klt_tpu's path: 'xla', 'lk2' (kernel B interpreted) or 'lk'
    (kernel C interpreted).  Trace-time knobs: set before the call."""
    for var in ("KLT_TPU_NO_PALLAS", "KLT_TPU_PALLAS_INTERPRET",
                "KLT_TPU_LK_V1"):
        monkeypatch.delenv(var, raising=False)
    if mode == "xla":
        monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    else:
        monkeypatch.setenv("KLT_TPU_PALLAS_INTERPRET", "1")
    if mode == "lk":
        monkeypatch.setenv("KLT_TPU_LK_V1", "1")


# ------------------------------------------------------------------ #
# kernel C's plain version                                            #
# ------------------------------------------------------------------ #

def level_case(name):
    """(cfg, frame-1 and frame-2 [B, 3, H_l, W_l] level stacks, x, y
    [B, 32], active [B, 32], status the case must reach): the five cases
    of tests/test_torch_lk.py on the three sequences."""
    kw, expect = {}, TRACKED
    if name == "lighting":
        kw = {"lighting_insensitive": True}
    elif name == "max_iterations":
        kw, expect = {"max_iterations": 2, "min_displacement": 1e-4}, \
            MAX_ITERATIONS
    elif name == "oob":
        expect = OOB
    elif name == "small_det":
        expect = SMALL_DET
    cfg = kt.TrackingConfig(**kw)
    rng = np.random.RandomState(11)
    x = rng.uniform(12, 68, (B, 32))
    y = rng.uniform(12, 52, (B, 32))
    pairs = []
    for b in range(B):
        img1, img2 = crop(b, (0, 0)), crop(b, STEPS[b])
        if name == "lighting":
            img2 = crop(b, STEPS[b], 1.2, 10)
        elif name == "oob":
            img2 = crop(b, (6.0, 0.5))
            x[b, :8] = rng.uniform(64, 72, 8)  # pushed past the right edge
        elif name == "small_det":
            img1[:, :36] = 128  # flat patch: a singular gradient matrix
            img2[:, :36] = 128
            x[b, :8] = rng.uniform(8, 24, 8)
        pairs.append([build_pyramid_stacks_plain(torch.from_numpy(im), cfg)
                      for im in (img1, img2)])
    stacks = [[torch.stack([p[i][r] for p in pairs])
               for r in range(cfg.n_pyramid_levels)] for i in range(2)]
    active = torch.from_numpy(rng.rand(B, 32) > 0.15)
    return (cfg, stacks, torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(y.astype(np.float32)), active, expect)


@pytest.mark.parametrize("name", ["default", "lighting", "oob", "small_det",
                                  "max_iterations"])
def test_batched_level_plain_equals_single_per_sequence(name):
    cfg, (st1, st2), x, y, active, expect = level_case(name)
    statuses = set()
    for r in range(cfg.n_pyramid_levels):
        s = float(cfg.subsampling ** r)
        x1, y1 = x / s, y / s
        args = (x1, y1, x1 + 0.4, y1 - 0.3, active, cfg, r == 0)
        got = lk_level_batched_plain(st1[r], st2[r], *args)
        lvl = track_level(st1[r], st2[r], *args[:-1], want_residue=r == 0)
        for b in range(B):
            one = [a[b] for a in args[:5]] + list(args[5:])
            assert_equal_all([g[b] for g in got],
                             lk_level_plain(st1[r][b], st2[r][b], *one))
            assert_equal_all([g[b] for g in lvl],
                             track_level(st1[r][b], st2[r][b], *one[:-1],
                                         want_residue=r == 0))
        statuses |= set(lvl[2][active].tolist())
    assert expect in statuses, f"case never reached status {expect}"


# ------------------------------------------------------------------ #
# the batched tier against klt_tpu                                    #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("cfg_name", sorted(CFGS))
@pytest.mark.parametrize("mode", ["xla", "lk2", "lk"])
def test_track_sequences_batched_matches_klt_tpu(mode, cfg_name, monkeypatch,
                                                 pallas_caches):
    from klt_tpu.parallel.batched_lk import track_sequences_batched as jtsb
    frames, x, y, val = sequences(cfg_name)
    jcfg, cfg = configs(cfg_name)
    set_mode(monkeypatch, mode)
    ref = jtsb(jnp.asarray(frames), jnp.asarray(x), jnp.asarray(y),
               jnp.asarray(val), jcfg)
    ref = [np.asarray(r) for r in ref]
    if mode != "xla":  # kernel C (lk) or B (lk2) really ran
        assert pallas_caches[mode].cache_info().currsize > 0
    ours = track_sequences_batched(torch.from_numpy(frames),
                                   *features_from_numpy(x, y, val), cfg)
    assert ours[0].shape == (T - 1, B, N_FEAT)
    assert_same_tracks(ours, ref)
    live = val >= 0
    assert len(set(live.sum(axis=1).tolist())) == B  # live counts differ
    # the 64x80 crops keep only a 32x16 interior inside the border, so
    # many features end OOB; every lane keeps some TRACKED
    assert ((ours[2][-1] == TRACKED).sum(dim=1) >= 3).all()


def test_track_sequence_matches_klt_tpu_kernel_c(monkeypatch, pallas_caches):
    """Kernel C on klt_tpu's single-sequence path (KLT_TPU_LK_V1=1)."""
    from klt_tpu.runtime.pipeline import track_sequence as jseq
    frames, x, y, val = sequences()
    jcfg, cfg = configs("default")
    set_mode(monkeypatch, "lk")
    for b in range(B):
        ref = jseq(jnp.asarray(frames[b]), jnp.asarray(x[b]),
                   jnp.asarray(y[b]), jnp.asarray(val[b]), jcfg)
        ours = track_sequence(torch.from_numpy(frames[b]),
                              *features_from_numpy(x[b], y[b], val[b]), cfg)
        assert_same_tracks(ours, ref)
    assert pallas_caches["lk"].cache_info().currsize > 0


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_batched_lanes_equal_track_sequence(cfg_name, monkeypatch):
    """Every lane equals track_sequence on its sequence bit for bit;
    precomp (frame 0 alone, then each chunk of the graphed step loop in
    builds of two frame indices here) equals the default bit for bit;
    padded lanes pass through."""
    frames, x, y, val = sequences(cfg_name)
    _, cfg = configs(cfg_name)
    f = torch.from_numpy(frames)
    feats = features_from_numpy(x, y, val)
    builds = []
    plain_build = pipeline.build_pyramid_stacks_batched_plain

    def counted(imgs, c):
        builds.append(imgs.shape[0])
        return plain_build(imgs, c)

    # the step loop of the batched tier is runtime/pipeline.py's
    for name in ("build_pyramid_stacks_batched",
                 "build_pyramid_stacks_batched_plain"):
        monkeypatch.setattr(pipeline, name, counted)
    monkeypatch.setattr(pipeline, "PRECOMP_FRAMES", 2 * B)
    got = track_sequences_batched(f, *feats, cfg)
    assert builds == [B] * T  # one batched build per frame index
    builds.clear()
    pre = track_sequences_batched(f, *feats, cfg, precomp=True)
    assert builds == [B] + [B * min(n - k, 2) for n in
                            graph.chunk_lengths(T - 1, graph.K)
                            for k in range(0, n, 2)]
    assert_equal_all(pre, got)
    assert_equal_all(track_sequences_batched(f, *feats, cfg, plain=True),
                     got)
    for b in range(B):
        one = track_sequence(f[b], *[a[b] for a in feats], cfg)
        assert_equal_all([g[:, b] for g in got], one)
    pad = val < 0
    for t in range(T - 1):
        assert (got[2][t].numpy()[pad] == -1).all()
        assert (got[0][t].numpy()[pad] == 0).all()


# ------------------------------------------------------------------ #
# klt_tpu's batch entry points                                        #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("entry", ["fused_pair_step", "batch_step",
                                   "track_batch"])
def test_batch_entry_points_match_klt_tpu(entry, monkeypatch):
    """klt_tpu off the TPU: its per-sequence vmap path."""
    from klt_tpu.parallel import batch as jb, batched_lk as jbl
    frames, x, y, val = sequences()
    jcfg, cfg = configs("default")
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    feats = features_from_numpy(x, y, val)
    jfeats = [jnp.asarray(a) for a in (x, y, val)]
    if entry == "track_batch":
        ref = jb.track_batch(jnp.asarray(frames), *jfeats, jcfg)
        ours = track_batch(torch.from_numpy(frames), *feats, cfg)
    else:
        jstep = (jbl.make_fused_pair_step(jcfg) if entry == "fused_pair_step"
                 else jb.make_batch_step(jcfg))
        step = (make_fused_pair_step(cfg) if entry == "fused_pair_step"
                else make_batch_step(cfg))
        ref = jstep(jnp.asarray(frames[:, 0]), jnp.asarray(frames[:, 1]),
                    *jfeats)
        ours = step(torch.from_numpy(frames[:, 0]),
                    torch.from_numpy(frames[:, 1]), *feats)
    assert_same_tracks(ours, ref)


def test_pad_features_for_mesh_matches_klt_tpu():
    from klt_tpu.parallel.batch import pad_features_for_mesh as jpad
    _, x, y, val = sequences()
    for multiple in (5, 8, 24):
        ref = jpad(x, y, val, multiple)
        got = pad_features_for_mesh(x, y, val, multiple)
        assert got[3] == ref[3] == N_FEAT
        for a, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
            assert np.asarray(a).dtype == np.asarray(r).dtype


def test_batched_cuda_wrapper_refuses_cpu_tensors():
    from klt_tpu_torch.cuda.lk_level import lk_level_batched_cuda
    cfg = kt.TrackingConfig()
    st = torch.zeros(2, 3, 20, 20)
    x = torch.full((2, 4), 10.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk_level_batched_cuda(st, st, x, x, x, x, x > 0, cfg)


# ------------------------------------------------------------------ #
# the record of where kernel C runs; batched state across interop     #
# ------------------------------------------------------------------ #

def test_lk2_supported_for_every_window():
    """klt_tpu takes kernel C (pallas/lk.py) where kernel B's flattened
    layout is not wrap-safe (`lk2.supported` False) or under
    KLT_TPU_LK_V1=1.  3k^2 - max_shift = 3kh + 2k + w + 1 exceeds
    max_read = 3kh + 2k + w by one for every window and patch side, so
    `supported` is never False: C runs only under KLT_TPU_LK_V1=1, and
    the port's counterpart of C is the batched tier's level kernel."""
    from klt_tpu.ops.lk import _kernel_patch_size
    from klt_tpu.pallas import lk2
    for w in range(3, 32, 2):
        for h in range(3, 32, 2):
            jcfg = klt_tpu.TrackingConfig(window_width=w, window_height=h)
            k0 = _kernel_patch_size(480, 640, jcfg)
            assert k0 == max(16, max(w, h) + 3)
            for k in range(k0, k0 + 8):
                assert lk2.supported(jcfg, k), (w, h, k)


def test_interop_carries_batched_state(monkeypatch):
    """klt_tpu's batched pyramid [B, 3, H_l, W_l] and its padded [B, N]
    features cross over as they are; the port's batched tracking on them
    equals its single-sequence tracking lane by lane, and klt_tpu's
    per-sequence tracking on the same stacks within POS_TOL."""
    import jax
    from klt_tpu.ops.lk import track_features_pyramid_stacks as jtrack
    from klt_tpu.ops.pyramid import build_pyramid_stacks_batched as jbuild
    from klt_tpu.parallel.batch import pad_features_for_mesh as jpad
    frames, x, y, val = sequences()
    jcfg, cfg = configs("default")
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jst = [[np.asarray(s) for s in jbuild(jnp.asarray(frames[:, k]), jcfg)]
           for k in (0, 1)]
    jx, jy, jv, n = jpad(x[:, :20], y[:, :20], val[:, :20], 8)
    assert n == 20 and jx.shape == (B, 24) and (jv[:, 20:] == -1).all()
    st1, st2 = (stacks_from_numpy(s) for s in jst)
    feats = features_from_numpy(jx, jy, jv)
    assert [tuple(s.shape) for s in st1] == [(B, 3, H, W), (B, 3, 16, 20)]
    assert all(np.array_equal(s.numpy(), j) for s, j in zip(st1, jst[0]))
    assert feats[0].shape == (B, 24) and feats[2].dtype == torch.int32
    got = track_features_pyramid_batched(st1, st2, *feats, cfg)
    for b in range(B):
        one = track_features_pyramid_stacks([s[b] for s in st1],
                                            [s[b] for s in st2],
                                            *[a[b] for a in feats], cfg)
        assert_equal_all([g[b] for g in got], one)
    ref = jax.vmap(lambda a, c, *f: jtrack(list(a), list(c), *f, jcfg))(
        [jnp.asarray(s) for s in jst[0]], [jnp.asarray(s) for s in jst[1]],
        jnp.asarray(jx), jnp.asarray(jy), jnp.asarray(jv))
    assert_same_tracks(got, ref)


@pytest.mark.parametrize("fault,message", [
    ("cpu", "CUDA tensors"), ("shapes", "level 1 stacks must both be"),
    ("strides", "contiguous"), ("levels", "at most 8"),
    ("sequences", "do not fit")])
def test_batched_pyramid_wrapper_refuses(fault, message):
    from klt_tpu_torch.cuda.lk_level import lk_pyramid_batched_cuda
    from test_torch_lk import pyramid_wrapper_args
    with pytest.raises(ValueError, match=message):
        lk_pyramid_batched_cuda(*pyramid_wrapper_args(fault, batched=True))
