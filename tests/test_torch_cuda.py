"""Kernels A, B, C, D, E, F, R (and its tie entry), G and H2 (both
entries) held against their plain torch versions on a CUDA card.

Every test here needs the card and skips without one.  The file imports
neither jax nor klt_tpu nor conftest, so on a machine with a card and no
jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every kernel accumulates in its plain version's f32 order and is built
with -fmad=false, so every comparison asks for bit equality.
"""

import os

import numpy as np
import pytest
import torch

import klt_tpu_torch as kt
from chip_smoke import (affine_cases, affine_frames, batched_affine_frames,
                        batched_frames, eager_chunks, exact_cases,
                        exact_lk_cases, exact_replace_cases, noise_frames,
                        pyramid_cases, replace_cases, response_cases,
                        synthetic_frames, tie_frames)
from klt_tpu_torch.ops.affine import (AffineState, affine_consistency_step,
                                      save_patches_plain, track_affine,
                                      track_affine_plain, verification_inputs)
from klt_tpu_torch.ops.lk import (lk_level, lk_level_batched_plain,
                                  lk_level_plain,
                                  track_features_pyramid_levels,
                                  track_features_pyramid_stacks)
from klt_tpu_torch.ops.pyramid import (build_pyramid_stacks,
                                       build_pyramid_stacks_plain)
from klt_tpu_torch.ops.pyramid import (build_pyramid_stacks_batched,
                                       build_pyramid_stacks_batched_plain)
from klt_tpu_torch.ops.replace import replace_lost_, replace_lost_plain_
from klt_tpu_torch.ops.selection import corner_response, corner_response_plain
from klt_tpu_torch.parallel import (track_sequences_affine_batched,
                                    track_sequences_batched)
from klt_tpu_torch.runtime.pipeline import (track_sequence,
                                            track_sequence_affine,
                                            track_sequence_replace,
                                            track_sequence_stream)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "smoothed_img0.f32")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py` on the GPU")
    return torch.device("cuda")


def scene(h=240, w=320) -> np.ndarray:
    img = np.fromfile(FIXTURE, np.float32).reshape(240, 320)[:h, :w]
    return np.ascontiguousarray(np.clip(np.rint(img), 0, 255)
                                .astype(np.uint8))


def assert_equal_all(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("hw,kw", [
    ((240, 320), {}), ((64, 80), {}), ((33, 47), {}),
    ((240, 320), {"search_range": 5}), ((33, 47), {"search_range": 5}),
    ((240, 320), {"search_range": 60, "window_width": 9}),
    ((64, 80), {"search_range": 30, "smooth_sigma_fact": 0.5})])
def test_pyramid_kernel_equals_plain(hw, kw, dev):
    from klt_tpu_torch import cuda
    cfg = kt.TrackingConfig(**kw)
    img = torch.from_numpy(scene(*hw)).to(dev)
    before = cuda.PYRAMID.launches
    got = build_pyramid_stacks(img, cfg)
    assert cuda.PYRAMID.launches == before + 1
    assert_equal_all(got, build_pyramid_stacks_plain(img, cfg))
    assert_equal_all(build_pyramid_stacks(img.float(), cfg), got)
    cpu = build_pyramid_stacks_plain(img.cpu(), cfg)
    assert_equal_all([g.cpu() for g in got], cpu)


def test_pyramid_kernel_rejects_bad_inputs(dev):
    from klt_tpu_torch.cuda.pyramid import build_pyramid_stacks_cuda
    cfg = kt.TrackingConfig()
    img = torch.from_numpy(scene()).to(dev)
    with pytest.raises(ValueError, match="dtype"):
        build_pyramid_stacks_cuda(img.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        build_pyramid_stacks_cuda(img.t(), cfg)
    with pytest.raises(ValueError, match="empty pyramid level"):
        build_pyramid_stacks_cuda(img[:3, :3].contiguous(), cfg)


PYRAMID_CONFIGS = pyramid_cases()


@pytest.mark.parametrize("case", range(len(PYRAMID_CONFIGS)),
                         ids=[c[0] for c in PYRAMID_CONFIGS])
def test_pyramid_kernels_tiled_and_global_equal_plain(case, dev):
    """Kernels A and E on the configurations that size the tiles
    differently, and on the one whose decimation fits no tile: the bits
    of the plain version (on the card and on the CPU), E image by image
    equal to A, u8 and f32 frames alike."""
    from klt_tpu_torch import cuda
    name, kw, hw = PYRAMID_CONFIGS[case]
    cfg = kt.TrackingConfig(**kw)
    taps = len(kt.kernels.gaussian_kernels(cfg.pyramid_sigma)[0])
    needs = cuda.load_library().klt_pyramid_needs_scratch(
        cfg.n_pyramid_levels, cfg.subsampling, taps)
    assert bool(needs) == ("no tile" in name)
    imgs = torch.from_numpy(noise_frames(3, hw, 21)).to(dev)
    got = build_pyramid_stacks_batched(imgs, cfg)
    plain = build_pyramid_stacks_batched_plain(imgs, cfg)
    cpu = build_pyramid_stacks_batched_plain(imgs.cpu(), cfg)
    for g, p, c in zip(got, plain, cpu):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), c.view(torch.int32))
    for i in range(3):
        assert_equal_all([g[i] for g in got],
                         build_pyramid_stacks(imgs[i], cfg))
    assert_equal_all(build_pyramid_stacks_batched(imgs.float(), cfg), got)


def level_case(name, dev):
    """Level stacks of a frame pair and features for kernel B."""
    kw = {"lighting_insensitive": True} if name == "lighting" else {}
    if name == "max_iterations":
        kw = {"max_iterations": 2, "min_displacement": 1e-4}
    if name == "window_9x5":
        kw = {"window_width": 9, "window_height": 5}
    if name.startswith("window_sq"):  # 3x3: under a warp; 15x15: 8 cells a
        side = int(name[9:])          # thread; 17x17: the unbounded loop
        kw = {"window_width": side, "window_height": side,
              "search_range": side}
    if name == "one_level":
        kw = {"search_range": 3}
    cfg = kt.TrackingConfig(**kw)
    frames = synthetic_frames(2)
    if name == "small_det":
        frames[:, :, :100] = 128
    if name == "oob":
        frames[1] = np.roll(frames[1], 9, axis=1)
    st = [build_pyramid_stacks_plain(torch.from_numpy(f).to(dev), cfg)
          for f in frames]
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.uniform(1, 318, 256).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(1, 238, 256).astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.rand(256) > 0.1).to(dev)
    return cfg, st, x, y, active


LEVEL_CASES = ["default", "lighting", "oob", "small_det", "max_iterations",
               "window_9x5", "window_sq3", "window_sq15", "window_sq17"]


@pytest.mark.parametrize("name", LEVEL_CASES)
def test_lk_kernel_equals_plain(name, dev):
    from klt_tpu_torch import cuda
    cfg, st, x, y, active = level_case(name, dev)
    statuses = set()
    for r in range(cfg.n_pyramid_levels):
        s = float(cfg.subsampling ** r)
        args = (st[0][r], st[1][r], x / s, y / s, x / s + 0.6, y / s - 0.4,
                active, cfg, r == 0)
        before = cuda.LK_LEVEL.launches
        got = lk_level(*args)
        assert cuda.LK_LEVEL.launches == before + 1
        assert_equal_all(got, lk_level_plain(*args))
        statuses |= set(got[2][active].tolist())
    assert len(statuses) > 1  # random positions reach more than TRACKED


def test_lk_kernel_rejects_bad_inputs(dev):
    from klt_tpu_torch.cuda.lk_level import lk_level_cuda
    cfg, st, x, y, active = level_case("default", dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk_level_cuda(st[0][0], st[1][0], x.cpu(), y, x, y, active, cfg)
    with pytest.raises(ValueError, match="features"):
        lk_level_cuda(st[0][0], st[1][0], x[:5].contiguous(), y, x, y,
                      active, cfg)
    tiny = st[0][0][:, :6, :6].contiguous()
    with pytest.raises(ValueError, match="smaller than"):
        lk_level_cuda(tiny, tiny, x, y, x, y, active, cfg)


@pytest.mark.parametrize("kw", [{}, {"lighting_insensitive": True}])
def test_track_sequence_kernels_equal_plain(kw, dev):
    """The whole main path: kernels on the card equal the plain versions on
    the card and on the CPU, with one pyramid launch per frame and one LK
    launch per frame pair."""
    from klt_tpu_torch import cuda
    cfg = kt.TrackingConfig(sequential_mode=True, **kw)
    frames = synthetic_frames(5)
    fl = kt.FeatureList.create(150)
    kt.KLTracker(cfg).select_good_features(frames[0], fl)
    feats = [torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)]
    f = torch.from_numpy(frames)
    cuda.reset_launch_counts()
    got = track_sequence(f.to(dev), *[a.to(dev) for a in feats], cfg)
    assert cuda.PYRAMID.launches == 5
    assert (cuda.LK_PYRAMID.launches, cuda.LK_LEVEL.launches) == (4, 0)
    plain = track_sequence(f.to(dev), *[a.to(dev) for a in feats], cfg,
                           plain=True)
    assert_equal_all(got, plain)
    assert_equal_all([g.cpu() for g in got], track_sequence(f, *feats, cfg))
    assert (got[2][-1] == kt.TRACKED).float().mean() > 0.9


def test_tracker_on_card_equals_cpu(dev):
    frames = synthetic_frames(4)
    out = []
    for device in (dev, "cpu"):
        tr = kt.KLTracker(kt.TrackingConfig(sequential_mode=True), device)
        fl = kt.FeatureList.create(100)
        tr.select_good_features(frames[0], fl)
        for i in range(1, 4):
            tr.track_features(frames[i - 1], frames[i], fl)
        out.append(fl)
    for a, b in zip((out[0].x, out[0].y, out[0].val),
                    (out[1].x, out[1].y, out[1].val)):
        np.testing.assert_array_equal(a, b)


def replace_frames(n, scale=1):
    """Synthetic frames with a flat patch from frame 3 on, so that
    features are lost and replaced."""
    fr = synthetic_frames(n, scale=scale)
    fr[3:, 60 * scale:120 * scale, 100 * scale:180 * scale] = 128
    return fr


@pytest.mark.parametrize("scale,window", [
    (1, (7, 7)), (2, (7, 7)), (1, (9, 5)), (1, (3, 11))])
def test_corner_response_kernel_equals_plain(scale, window, dev):
    from klt_tpu_torch import cuda
    cfg = kt.TrackingConfig()
    img = torch.from_numpy(replace_frames(4, scale)[3]).to(dev)
    _, gx, gy = build_pyramid_stacks(img, cfg)[0]
    before = cuda.CORNER_RESPONSE.launches
    got = corner_response(gx, gy, *window)
    assert cuda.CORNER_RESPONSE.launches == before + 1
    ref = corner_response_plain(gx, gy, *window)
    assert_equal_all([got, got.to(torch.int32)],
                     [ref, ref.to(torch.int32)])
    cpu = corner_response_plain(gx.cpu(), gy.cpu(), *window)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("hw", [(33, 47), (2, 3), (240, 320)])
def test_corner_response_kernel_odd_sizes(hw, dev):
    rng = np.random.RandomState(hw[0])
    gx, gy = (torch.from_numpy(rng.normal(0, 30, hw).astype(np.float32))
              .to(dev) for _ in range(2))
    assert torch.equal(corner_response(gx, gy, 7, 7),
                       corner_response_plain(gx, gy, 7, 7))


RESPONSE_CASES = response_cases()


@pytest.mark.parametrize("case", range(len(RESPONSE_CASES)),
                         ids=[c[0] for c in RESPONSE_CASES])
def test_corner_response_entries_equal_plain(case, dev):
    """The tiled entry (flat and tall tiles, unrolled and looped windows,
    maps smaller than a tile, the clamp) and the global-memory entry for a
    window no tile holds: one call each, the plain version's bits."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda.corner_response import library_tile_rows
    from klt_tpu_torch.ops.selection import response_tile_rows
    name, gx, gy, win = RESPONSE_CASES[case]
    gx, gy = torch.from_numpy(gx).to(dev), torch.from_numpy(gy).to(dev)
    cuda.reset_launch_counts()
    got = corner_response(gx, gy, *win)
    untiled = "no tile" in name
    assert (library_tile_rows(*win) == 0) == untiled
    # the plain model's rule is the library's, on a map of many tiles
    assert response_tile_rows(*win, 1 << 12, 1 << 12) == \
        library_tile_rows(*win)
    assert (cuda.CORNER_RESPONSE.launches,
            cuda.CORNER_RESPONSE_GLOBAL.launches) == (1 - untiled, untiled)
    ref = corner_response_plain(gx, gy, *win)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.cpu(),
                       corner_response_plain(gx.cpu(), gy.cpu(), *win))


AFFINE_CASES = affine_cases()


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", range(len(AFFINE_CASES)),
                         ids=[c[0] for c in AFFINE_CASES])
def test_affine_kernel_equals_plain_on_made_states(case, mode, dev):
    """Kernel F on flat patches (a zero pivot), corners that leave the
    image, foreign patches, inactive lanes and three window sizes: one
    launch, the bits of the plain version on the card and on the CPU."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda.affine import track_affine_cuda
    name, kw, patches, stack2, x1, y1, x2, y2, maps, active = \
        AFFINE_CASES[case]
    cfg = kt.TrackingConfig(affine_consistency_check=mode, **kw)
    t = torch.from_numpy
    cpu = (t(patches), t(stack2), t(x1), t(y1), t(x2), t(y2),
           tuple(t(m) for m in maps), t(active))
    args = tuple(tuple(m.to(dev) for m in a) if isinstance(a, tuple)
                 else a.to(dev) for a in cpu)
    before = cuda.AFFINE_TRACK.launches
    got = track_affine_cuda(*args, cfg)
    assert cuda.AFFINE_TRACK.launches == before + 1
    flat = lambda out: [out[0], out[1], *out[2], out[3], out[4]]
    assert_equal_all(flat(got), flat(track_affine_plain(*args, cfg)))
    assert_equal_all([g.cpu() for g in flat(got)],
                     flat(track_affine_plain(*cpu, cfg)))
    assert_equal_all(flat(got)[:7], flat(track_affine(*args, cfg) + (0,))[:7])


def stack_batch(stack2, rng):
    """[3, 3, H, W]: the stack, its mirror image and a noisier copy, so
    that a lane's result depends on the sequence it reads."""
    noisy = stack2 + rng.standard_normal(stack2.shape).astype(np.float32)
    return np.ascontiguousarray(np.stack([stack2, stack2[:, ::-1, ::-1],
                                          noisy]))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", range(len(AFFINE_CASES)),
                         ids=[c[0] for c in AFFINE_CASES])
def test_affine_kernel_on_a_stack_batch_equals_plain(case, mode, dev):
    """Kernel F on the stacks of 3 sequences, the case's lanes once for
    each (lane l reads sequence l // N): one launch, the bits of the plain
    version on the card and on the CPU, and of the kernel on each
    sequence alone."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda.affine import track_affine_cuda
    name, kw, patches, stack2, x1, y1, x2, y2, maps, active = \
        AFFINE_CASES[case]
    cfg = kt.TrackingConfig(affine_consistency_check=mode, **kw)
    t = torch.from_numpy
    rep3 = lambda a: np.concatenate([a] * 3, axis=-1 if a.ndim == 1 else 1)
    cpu = (t(np.ascontiguousarray(rep3(patches))),
           t(stack_batch(stack2, np.random.RandomState(case))),
           *(t(rep3(a)) for a in (x1, y1, x2, y2)),
           tuple(t(rep3(m)) for m in maps), t(rep3(active)))
    args = tuple(tuple(m.to(dev) for m in a) if isinstance(a, tuple)
                 else a.to(dev) for a in cpu)
    before = cuda.AFFINE_TRACK.launches
    got = track_affine_cuda(*args, cfg)
    assert cuda.AFFINE_TRACK.launches == before + 1
    flat = lambda out: [out[0], out[1], *out[2], out[3], out[4]]
    assert_equal_all(flat(got), flat(track_affine_plain(*args, cfg)))
    assert_equal_all([g.cpu() for g in flat(got)],
                     flat(track_affine_plain(*cpu, cfg)))
    n = len(x1)
    for b in range(3):
        lanes = slice(b * n, (b + 1) * n)
        one = track_affine_cuda(
            args[0][:, lanes].contiguous(), args[1][b],
            *(a[lanes] for a in args[2:6]),
            tuple(m[lanes] for m in args[6]), args[7][lanes], cfg)
        assert_equal_all([g[lanes] for g in flat(got)], flat(one))
    if active.any():
        seqs = got[3].view(3, n)
        assert not (torch.equal(seqs[0], seqs[1]) and
                    torch.equal(seqs[0], seqs[2]) and
                    torch.equal(got[0].view(3, n)[0], got[0].view(3, n)[2]))


def test_affine_step_entry_saves_patches_with_clamped_starts(dev):
    """Lanes tracked for the first time, two of them at positions whose
    patch would leave the image: the step entry's one launch writes the
    patches of save_patches_plain and leaves the others as they were."""
    from klt_tpu_torch import cuda
    name, kw, patches, stack2, x1, y1, x2, y2, maps, active = AFFINE_CASES[0]
    cfg = kt.TrackingConfig(affine_consistency_check=2)
    t = lambda a: torch.from_numpy(a).to(dev)
    n = len(x1)
    rng = np.random.RandomState(4)
    state = AffineState.create(n, cfg, dev)
    state.patches = t(patches).clone()
    state.valid = t(rng.rand(n) < 0.5)
    vn = torch.where(t(rng.rand(n) < 0.8), kt.TRACKED, kt.OOB).to(torch.int32)
    init = (vn == kt.TRACKED) & ~state.valid
    x_old, y_old = t(x2 + 3.0), t(y2 - 2.0)
    first = init.nonzero()[:2, 0]
    x_old[first], y_old[first] = -1.0, 500.0
    want = save_patches_plain(state.patches, t(stack2), x_old, y_old, init)
    before = cuda.AFFINE_STEP.launches
    affine_consistency_step(state, t(stack2), t(stack2), x_old, y_old, vn,
                            t(x2), t(y2), vn, cfg)
    assert cuda.AFFINE_STEP.launches == before + 1
    assert init.sum() >= 3
    assert torch.equal(state.patches, want)
    assert not torch.equal(state.patches, t(patches))


def test_affine_kernel_rejects_bad_inputs(dev):
    from klt_tpu_torch.cuda.affine import track_affine_cuda
    name, kw, patches, stack2, x1, y1, x2, y2, maps, active = AFFINE_CASES[0]
    t = lambda a: torch.from_numpy(a).to(dev)
    good = [t(patches), t(stack2), t(x1), t(y1), t(x2), t(y2),
            tuple(t(m) for m in maps), t(active)]
    cfg = kt.TrackingConfig(affine_consistency_check=2)
    for i, bad in ((0, good[0].cpu()), (0, good[0][:, :5]),
                   (1, good[1].double()), (2, good[2][:-1]),
                   (7, good[7].to(torch.uint8))):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            track_affine_cuda(*args, cfg)
    with pytest.raises(ValueError, match="cells"):
        track_affine_cuda(*good, kt.TrackingConfig(
            affine_consistency_check=2, affine_window_width=17,
            affine_window_height=17))
    with pytest.raises(ValueError, match="0, 1 or 2"):
        track_affine_cuda(*good, kt.TrackingConfig())


@pytest.mark.parametrize("mode,kw", [(0, {}), (1, {}), (2, {}),
                                     (2, {"lighting_insensitive": True})])
def test_track_sequence_affine_kernels_equal_plain(mode, kw, dev):
    """The affine path: kernels on the card equal the plain versions on
    the card and on the CPU, with and without precomp; one launch of
    kernel F a step; the check kills features."""
    from klt_tpu_torch import cuda
    cfg = kt.TrackingConfig(sequential_mode=True,
                            affine_consistency_check=mode, **kw)
    frames = affine_frames(8, rate=0.1)
    fl = kt.FeatureList.create(150)
    kt.KLTracker(cfg).select_good_features(frames[0], fl)
    feats = [torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)]
    f = torch.from_numpy(frames)
    featd = [a.to(dev) for a in feats]
    cuda.reset_launch_counts()
    got = track_sequence_affine(f.to(dev), *featd, cfg)
    assert (cuda.AFFINE_STEP.launches, cuda.AFFINE_TRACK.launches,
            cuda.LK_PYRAMID.launches, cuda.PYRAMID.launches) == (7, 0, 7, 8)
    assert_equal_all(got, track_sequence_affine(f.to(dev), *featd, cfg,
                                                plain=True))
    assert_equal_all(got, track_sequence_affine(f.to(dev), *featd, cfg,
                                                precomp=True))
    assert_equal_all([g.cpu() for g in got],
                     track_sequence_affine(f, *feats, cfg))
    free = track_sequence(f.to(dev), *featd, cfg)
    killed = (free[2][-1] == kt.TRACKED) & (got[2][-1] < 0)
    assert killed.sum() >= 3


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_affine_step_entry_equals_plain_step(mode, dev):
    """Kernel F's step entry (one launch, the state updated in place)
    against its plain version on the card: features and state bit-equal
    after every step, also after patches were forgotten midway (lanes that
    save again); the track entry on the step's verification inputs gives
    the plain verification's bits."""
    from klt_tpu_torch import cuda
    cfg = kt.TrackingConfig(sequential_mode=True,
                            affine_consistency_check=mode)
    frames = torch.from_numpy(affine_frames(8, rate=0.1)).to(dev)
    fl = kt.FeatureList.create(150)
    kt.KLTracker(cfg).select_good_features(frames[0].cpu().numpy(), fl)
    x, y, val = (torch.from_numpy(a).to(dev) for a in (fl.x, fl.y, fl.val))
    states = [AffineState.create(150, cfg, dev) for _ in range(2)]
    fields = ("valid", "patches", "x", "y", "axx", "ayx", "axy", "ayy")
    st1 = build_pyramid_stacks(frames[0], cfg)
    killed = 0
    for t in range(1, 8):
        st2 = build_pyramid_stacks(frames[t], cfg)
        xn, yn, vn = track_features_pyramid_stacks(st1, st2, x, y, val, cfg)
        if t == 4:
            for s in states:
                s.invalidate(np.arange(0, 150, 7))
        args = verification_inputs(states[0], st1[0], x, y, xn, yn, vn, cfg)
        args = (args[0], st2[0]) + args[1:]
        before = (cuda.AFFINE_STEP.launches, cuda.AFFINE_TRACK.launches)
        flat = lambda out: [out[0], out[1], *out[2], out[3]]
        assert_equal_all(flat(track_affine(*args, cfg)),
                         flat(track_affine_plain(*args, cfg)))
        outs = [affine_consistency_step(states[0], st1[0], st2[0], x, y, val,
                                        xn, yn, vn, cfg),
                affine_consistency_step(states[1], st1[0], st2[0], x, y, val,
                                        xn, yn, vn, cfg, plain=True)]
        assert (cuda.AFFINE_STEP.launches - before[0],
                cuda.AFFINE_TRACK.launches - before[1]) == (1, 1)
        assert_equal_all(outs[0], outs[1])
        assert_equal_all([getattr(states[0], k) for k in fields],
                         [getattr(states[1], k) for k in fields])
        killed += int(((vn == kt.TRACKED) & (outs[0][2] < 0)).sum())
        x, y, val = outs[0]
        st1 = st2
    assert killed >= 3 and states[0].valid.sum() > 50


def test_affine_step_entry_rejects_bad_inputs(dev):
    from klt_tpu_torch.cuda.affine import affine_step_cuda_
    cfg = kt.TrackingConfig(affine_consistency_check=2)
    stack = torch.zeros((3, 40, 50), device=dev)
    lanes = lambda: [torch.zeros(6, device=dev) for _ in range(4)] + \
        [torch.zeros(6, dtype=torch.int32, device=dev)]
    good = AffineState.create(6, cfg, dev)
    assert affine_step_cuda_(good, stack, stack, *lanes(), cfg)[2].shape == \
        (6,)
    with pytest.raises(ValueError):
        affine_step_cuda_(AffineState.create(5, cfg, dev), stack, stack,
                          *lanes(), cfg)
    with pytest.raises(ValueError):
        affine_step_cuda_(good, stack.cpu(), stack, *lanes(), cfg)
    with pytest.raises(ValueError):
        affine_step_cuda_(good, stack[:, :10], stack[:, :10], *lanes(), cfg)
    with pytest.raises(ValueError):
        affine_step_cuda_(AffineState.create(6, cfg, "cpu"), stack, stack,
                          *lanes(), cfg)
    with pytest.raises(ValueError, match="0, 1 or 2"):
        affine_step_cuda_(good, stack, stack, *lanes(), kt.TrackingConfig())


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_track_sequences_affine_batched_kernels_equal_plain(mode, dev):
    """B = 3 different sequences with the check: kernels on the card equal
    the plain versions on the card and on the CPU, precomp, and lane by
    lane track_sequence_affine; a step is one launch each of E, C's
    pyramid entry and F's step entry, and nothing else."""
    from klt_tpu_torch import cuda
    cfg = kt.TrackingConfig(sequential_mode=True,
                            affine_consistency_check=mode)
    frames = batched_affine_frames(3, 7, rate=0.1)
    b, t_len = frames.shape[:2]
    lists = [kt.FeatureList.create(150) for _ in range(b)]
    for i, fl in enumerate(lists):
        kt.KLTracker(cfg).select_good_features(frames[i, 0], fl)
    feats = [np.stack([getattr(fl, k) for fl in lists])
             for k in ("x", "y", "val")]
    f = torch.from_numpy(frames)
    cpu = [torch.from_numpy(a) for a in feats]
    fd, featd = f.to(dev), [a.to(dev) for a in cpu]
    cuda.reset_launch_counts()
    got = track_sequences_affine_batched(fd, *featd, cfg)
    counts = {k.symbol: k.launches for k in cuda.KERNELS}
    assert counts == {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID_BATCHED.symbol: t_len,
        cuda.LK_PYRAMID_BATCHED.symbol: t_len - 1,
        cuda.AFFINE_STEP.symbol: t_len - 1}
    assert_equal_all(got, track_sequences_affine_batched(fd, *featd, cfg,
                                                         precomp=True))
    assert_equal_all(got, track_sequences_affine_batched(fd, *featd, cfg,
                                                         plain=True))
    assert_equal_all([g.cpu() for g in got],
                     track_sequences_affine_batched(f, *cpu, cfg))
    killed = 0
    for i in range(b):
        one = track_sequence_affine(fd[i], *[a[i] for a in featd], cfg)
        assert_equal_all([g[:, i] for g in got], one)
        free = track_sequence(fd[i], *[a[i] for a in featd], cfg)
        killed += int(((free[2][-1] == kt.TRACKED) &
                       (got[2][-1, i] < 0)).sum())
    assert killed >= 3


def test_affine_entries_reject_a_stack_batch_that_does_not_divide(dev):
    from klt_tpu_torch.cuda.affine import affine_step_cuda_, track_affine_cuda
    name, kw, patches, stack2, x1, y1, x2, y2, maps, active = AFFINE_CASES[0]
    t = lambda a: torch.from_numpy(a).to(dev)
    cfg = kt.TrackingConfig(affine_consistency_check=2)
    three = t(stack_batch(stack2, np.random.RandomState(0)))
    assert len(x1) % 3 != 0
    with pytest.raises(ValueError, match="dividing"):
        track_affine_cuda(t(patches), three, t(x1), t(y1), t(x2), t(y2),
                          tuple(t(m) for m in maps), t(active), cfg)
    lanes = [t(a) for a in (x2, y2, x2, y2)] + \
        [torch.zeros(len(x1), dtype=torch.int32, device=dev)]
    with pytest.raises(ValueError, match="dividing"):
        affine_step_cuda_(AffineState.create(len(x1), cfg, dev), three,
                          three, *lanes, cfg)
    with pytest.raises(ValueError):
        affine_step_cuda_(AffineState.create(len(x1), cfg, dev), three,
                          three[:1], *lanes, cfg)


def test_tracker_with_the_check_on_card_equals_cpu(dev):
    frames = affine_frames(7, rate=0.1)
    cfg = kt.TrackingConfig(sequential_mode=True, affine_consistency_check=2)
    out = []
    for device in (None, "cpu"):
        tr = kt.KLTracker(cfg, device)
        assert tr.device.type == ("cuda" if device is None else "cpu")
        fl = kt.FeatureList.create(150)
        tr.select_good_features(frames[0], fl)
        for i in range(1, 7):
            tr.track_features(frames[i - 1], frames[i], fl)
            tr.replace_lost_features(frames[i], fl)
        out.append((fl, tr._affine))
    for a, b in zip((out[0][0].x, out[0][0].y, out[0][0].val),
                    (out[1][0].x, out[1][0].y, out[1][0].val)):
        np.testing.assert_array_equal(a, b)
    assert out[0][1].valid.is_cuda
    assert torch.equal(out[0][1].valid.cpu(), out[1][1].valid)
    assert torch.equal(out[0][1].patches.cpu()[:, out[1][1].valid],
                       out[1][1].patches[:, out[1][1].valid])


def test_stream_takes_numpy_features_to_the_card(dev):
    cfg, f, feats = replace_inputs(dev, n_frames=6)
    whole = track_sequence(f.to(dev), *[a.to(dev) for a in feats], cfg)
    (t, x, y, val), = track_sequence_stream(
        iter(f.numpy()), *[a.numpy() for a in feats], cfg)
    assert t == 5
    np.testing.assert_array_equal(x, whole[0][-1].cpu().numpy())
    np.testing.assert_array_equal(val, whole[2][-1].cpu().numpy())


@pytest.mark.parametrize("b,hw,kw", [
    (1, (240, 320), {}), (10, (240, 320), {}), (5, (33, 47), {}),
    (3, (480, 640), {}), (4, (64, 80), {"search_range": 30,
                                        "smooth_sigma_fact": 0.5})])
def test_batched_pyramid_kernel_equals_kernel_a(b, hw, kw, dev):
    from klt_tpu_torch import cuda
    cfg = kt.TrackingConfig(**kw)
    scale = 2 if hw[0] > 240 else 1
    imgs = torch.from_numpy(np.ascontiguousarray(
        replace_frames(b, scale)[:, :hw[0], :hw[1]])).to(dev)
    before = cuda.PYRAMID_BATCHED.launches
    got = build_pyramid_stacks_batched(imgs, cfg)
    assert cuda.PYRAMID_BATCHED.launches == before + 1
    assert [tuple(g.shape[:2]) for g in got] == [(b, 3)] * len(got)
    for i in range(b):
        assert_equal_all([g[i] for g in got], build_pyramid_stacks(imgs[i],
                                                                   cfg))
    assert_equal_all(got, build_pyramid_stacks_batched_plain(imgs, cfg))
    assert_equal_all(build_pyramid_stacks_batched(imgs.float(), cfg), got)


def lost_case(kw, scale, dev):
    """A tracked state with lost slots and the new frame's response."""
    cfg = kt.TrackingConfig(sequential_mode=True, **kw)
    frames = replace_frames(4, scale)
    fl = kt.FeatureList.create(150 if scale == 1 else 500)
    tr = kt.KLTracker(cfg, dev)
    tr.select_good_features(frames[2], fl)
    tr.track_features(frames[2], frames[3], fl)
    _, gx, gy = tr._pyr_last[0]
    resp = corner_response(gx, gy, cfg.window_width, cfg.window_height)
    return cfg, resp, fl


@pytest.mark.parametrize("scale,kw", [
    (1, {}), (2, {}), (1, {"mindist": 1}),
    (1, {"mindist": 5, "n_skipped_pixels": 1}),
    (2, {"min_eigenvalue": 500}), (1, {"mindist": 40})])
def test_replace_kernel_equals_plain(scale, kw, dev):
    from klt_tpu_torch import cuda
    cfg, resp, fl = lost_case(kw, scale, dev)
    assert (fl.val < 0).any()
    outs = []
    for where, fn in ((dev, replace_lost_), (dev, replace_lost_plain_),
                      ("cpu", replace_lost_plain_)):
        x, y, val = (torch.from_numpy(a.copy()).to(where)
                     for a in (fl.x, fl.y, fl.val))
        before = cuda.REPLACE_LOST.launches
        fn(resp.to(where), x, y, val, cfg)
        assert cuda.REPLACE_LOST.launches == before + (fn is replace_lost_)
        outs.append([x.cpu(), y.cpu(), val.cpu()])
    assert_equal_all(outs[0], outs[1])
    assert_equal_all(outs[0], outs[2])
    val = outs[0][2].numpy()
    assert ((fl.val < 0) & (val > 0)).any()
    if kw.get("mindist") == 40:  # candidates run out
        assert ((fl.val < 0) & (val == kt.NOT_FOUND)).any()
    assert not ((val < 0) & (val != kt.NOT_FOUND)).any()


REPLACE_STATES = replace_cases()


@pytest.mark.parametrize("case", range(len(REPLACE_STATES)),
                         ids=[c[0] for c in REPLACE_STATES])
def test_replace_kernel_adversarial_states_equal_plain(case, dev):
    """Equal maxima in different tiles and rows, squares across tile
    corners and map borders, all slots lost, candidates that run out,
    mindist 1 and above a tile, a step grid, maps that are no multiple of
    a tile or smaller than one, no slot lost, no slot: x, y, val equal to
    the plain version's on the card and on the CPU."""
    name, kw, resp, x, y, val = REPLACE_STATES[case]
    cfg = kt.TrackingConfig(**kw)
    outs = []
    for where, fn in ((dev, replace_lost_), (dev, replace_lost_plain_),
                      ("cpu", replace_lost_plain_)):
        state = [torch.from_numpy(a.copy()).to(where) for a in (x, y, val)]
        fn(torch.from_numpy(resp).to(where), *state, cfg)
        outs.append([a.cpu() for a in state])
    assert_equal_all(outs[0], outs[1])
    assert_equal_all(outs[0], outs[2])
    out = outs[0][2].numpy()
    if name.startswith("no slot"):
        np.testing.assert_array_equal(out, val)
    else:
        assert ((val < 0) & (out > 0)).any()
    assert not ((out < 0) & (out != kt.NOT_FOUND)).any()


def test_replace_kernel_calls_share_a_ticket_per_stream(dev):
    """Calls one after the other on one stream, and on a second stream,
    each find the ticket as the last one left it."""
    _, kw, resp, x, y, val = REPLACE_STATES[0]
    cfg = kt.TrackingConfig(**kw)
    respd = torch.from_numpy(resp).to(dev)
    want = [torch.from_numpy(a.copy()).to(dev) for a in (x, y, val)]
    replace_lost_plain_(respd, *want, cfg)
    side = torch.cuda.Stream(dev)
    for stream in (torch.cuda.current_stream(dev), side):
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(3):
                state = [torch.from_numpy(a.copy()).to(dev)
                         for a in (x, y, val)]
                replace_lost_(respd, *state, cfg)
                stream.synchronize()
                assert_equal_all(state, want)


def test_replace_kernel_rejects_maps_it_does_not_take(dev):
    """More tiles than the greedy block's shared memory holds, or more rows
    than a packed position does: the wrapper raises."""
    from klt_tpu_torch.cuda.replace import replace_lost_cuda_
    cfg = kt.TrackingConfig()
    state = [torch.zeros(4, device=dev), torch.zeros(4, device=dev),
             torch.full((4,), -1, dtype=torch.int32, device=dev)]
    for hw in ((5200, 5200), (40000, 8)):
        with pytest.raises(ValueError, match="kernel R takes"):
            replace_lost_cuda_(torch.empty(hw, device=dev), *state, cfg)


def test_replace_kernel_with_no_lost_slot_changes_nothing(dev):
    cfg, resp, fl = lost_case({}, 1, dev)
    live = fl.val >= 0
    state = [torch.from_numpy(np.where(live, a, b).astype(a.dtype)).to(dev)
             for a, b in ((fl.x, 50.0), (fl.y, 60.0), (fl.val, 7))]
    before = [a.clone() for a in state]
    replace_lost_(resp, *state, cfg)
    assert_equal_all(state, before)


def replace_inputs(dev, n_frames=8, scale=1, n=150):
    cfg = kt.TrackingConfig(sequential_mode=True)
    frames = replace_frames(n_frames, scale)
    fl = kt.FeatureList.create(n)
    kt.KLTracker(cfg).select_good_features(frames[0], fl)
    feats = [torch.from_numpy(a) for a in (fl.x, fl.y, fl.val)]
    return cfg, torch.from_numpy(frames), feats


def test_track_sequence_replace_kernels_equal_plain(dev):
    """Kernels on the card, plain on the card and plain on the CPU, with
    and without precomp: bit-equal tables; one launch of A, of D and of R
    per frame and of B's pyramid entry per frame pair (with precomp E once
    a chunk of the graphed loop)."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda import graph
    cfg, f, feats = replace_inputs(dev)
    fd, featd = f.to(dev), [a.to(dev) for a in feats]
    cuda.reset_launch_counts()
    got = track_sequence_replace(fd, *featd, cfg)
    assert (cuda.PYRAMID.launches, cuda.CORNER_RESPONSE.launches,
            cuda.REPLACE_LOST.launches, cuda.LK_PYRAMID.launches,
            cuda.LK_LEVEL.launches) == (8, 7, 7, 7, 0)
    cuda.reset_launch_counts()
    pre = track_sequence_replace(fd, *featd, cfg, precomp=True)
    assert (cuda.PYRAMID.launches, cuda.PYRAMID_BATCHED.launches) == \
        (1, len(graph.chunk_lengths(len(f) - 1, graph.K)))
    assert_equal_all(pre, got)
    assert_equal_all(got, track_sequence_replace(fd, *featd, cfg,
                                                 plain=True))
    assert_equal_all([g.cpu() for g in got],
                     track_sequence_replace(f, *feats, cfg))
    assert (got[2][2:] > 0).any()  # replaced after the patch appeared


def test_replace_loop_never_syncs(dev):
    cfg, f, feats = replace_inputs(dev)
    fd, featd = f.to(dev), [a.to(dev) for a in feats]
    # build, warm up and capture every graph (a capture synchronises once)
    for pre in (False, True):
        for _ in range(2):
            track_sequence_replace(fd, *featd, cfg, precomp=pre)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pre in (False, True):
            track_sequence_replace(fd, *featd, cfg, precomp=pre)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_tracker_replace_on_card_equals_cpu(dev):
    frames = replace_frames(6)
    out = []
    for device in (dev, "cpu"):
        tr = kt.KLTracker(kt.TrackingConfig(sequential_mode=True), device)
        fl = kt.FeatureList.create(150)
        tr.select_good_features(frames[0], fl)
        for i in range(1, 6):
            tr.track_features(frames[i - 1], frames[i], fl)
            tr.replace_lost_features(frames[i], fl)
        out.append(fl)
    for a, b in zip((out[0].x, out[0].y, out[0].val),
                    (out[1].x, out[1].y, out[1].val)):
        np.testing.assert_array_equal(a, b)


def test_device_response_selection_on_card_equals_cpu(dev, monkeypatch):
    monkeypatch.setenv("KLT_TPU_EXACT_SELECT", "0")
    frames = replace_frames(1)
    for kw in ({}, {"smooth_before_selecting": False}):
        out = []
        for device in (dev, "cpu"):
            fl = kt.FeatureList.create(300)
            kt.KLTracker(kt.TrackingConfig(**kw), device) \
                .select_good_features(frames[0], fl)
            out.append(fl)
        np.testing.assert_array_equal(out[0].x, out[1].x)
        np.testing.assert_array_equal(out[0].val, out[1].val)


def test_stream_on_card_equals_track_sequence(dev):
    cfg, f, feats = replace_inputs(dev, n_frames=11)
    featd = [a.to(dev) for a in feats]
    whole = track_sequence(f.to(dev), *featd, cfg)
    for pre in (False, True):
        snaps = list(track_sequence_stream(iter(f.numpy()), *featd, cfg,
                                           chunk=4, precomp=pre))
        assert [s[0] for s in snaps] == [4, 8, 10]
        for t, *state in snaps:
            for a, w in zip(state, whole):
                np.testing.assert_array_equal(a, w[t - 1].cpu().numpy())


def batched_level_case(name, dev):
    """Level stacks [B, 3, H_l, W_l] of B different frame pairs and
    features [B, F] for kernel C: the cases of `level_case` on 3
    sequences, and 32 sequences of 150 features (the batched flagship's
    size)."""
    b, n = (32, 150) if name == "b32" else (3, 256)
    cfg, _, _, _, _ = level_case("default" if name == "b32" else name, dev)
    frames = batched_frames(b, 2)
    if name == "small_det":
        frames[:, :, :, :100] = 128
    if name == "oob":
        frames[:, 1] = np.roll(frames[:, 1], 9, axis=2)
    imgs = torch.from_numpy(frames.reshape(2 * b, *frames.shape[2:])).to(dev)
    st = build_pyramid_stacks_batched(imgs, cfg)
    st1, st2 = [s.view(b, 2, *s.shape[1:])[:, 0].contiguous() for s in st], \
        [s.view(b, 2, *s.shape[1:])[:, 1].contiguous() for s in st]
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.uniform(1, 318, (b, n)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(1, 238, (b, n)).astype(np.float32))
    active = torch.from_numpy(rng.rand(b, n) > 0.1)
    return cfg, st1, st2, x.to(dev), y.to(dev), active.to(dev)


@pytest.mark.parametrize("name", LEVEL_CASES + ["b32"])
def test_batched_lk_kernel_equals_plain_and_kernel_b(name, dev):
    """Kernel C equals its plain version bit for bit, and its lane b
    equals kernel B on sequence b."""
    from klt_tpu_torch import cuda
    cfg, st1, st2, x, y, active = batched_level_case(name, dev)
    statuses = set()
    for r in range(cfg.n_pyramid_levels):
        s = float(cfg.subsampling ** r)
        args = (x / s, y / s, x / s + 0.6, y / s - 0.4, active, cfg, r == 0)
        before = (cuda.LK_LEVEL_BATCHED.launches, cuda.LK_LEVEL.launches)
        got = lk_level(st1[r], st2[r], *args)
        assert (cuda.LK_LEVEL_BATCHED.launches, cuda.LK_LEVEL.launches) == \
            (before[0] + 1, before[1])
        assert_equal_all(got, lk_level_batched_plain(st1[r], st2[r], *args))
        for b in range(x.shape[0]):
            one = [a[b].contiguous() for a in args[:5]] + list(args[5:])
            assert_equal_all([g[b] for g in got],
                             lk_level(st1[r][b], st2[r][b], *one))
        statuses |= set(got[2][active].tolist())
    assert len(statuses) > 1


def test_batched_lk_kernel_rejects_bad_inputs(dev):
    from klt_tpu_torch.cuda.lk_level import lk_level_batched_cuda
    cfg, st1, st2, x, y, active = batched_level_case("default", dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk_level_batched_cuda(st1[0], st2[0], x.cpu(), y, x, y, active, cfg)
    with pytest.raises(ValueError, match="features"):
        lk_level_batched_cuda(st1[0], st2[0], x, y[:, :5].contiguous(), x, y,
                              active, cfg)
    with pytest.raises(ValueError, match="sequences"):
        lk_level_batched_cuda(st1[0], st2[0], x[:2].contiguous(), y, x, y,
                              active, cfg)
    with pytest.raises(ValueError, match="stacks"):
        lk_level_batched_cuda(st1[0], st2[1], x, y, x, y, active, cfg)
    tiny = st1[0][:, :, :6, :6].contiguous()
    with pytest.raises(ValueError, match="smaller than"):
        lk_level_batched_cuda(tiny, tiny, x, y, x, y, active, cfg)


@pytest.mark.parametrize("kw", [{}, {"lighting_insensitive": True}])
def test_track_sequences_batched_kernels_equal_plain(kw, dev):
    """B = 5 different sequences: kernels on the card equal the plain
    versions on the card and on the CPU and, lane by lane,
    track_sequence; one kernel E launch per frame (with precomp one for
    the first frame, then one a chunk of the graphed loop) and one launch
    of kernel C's pyramid entry per step, no kernel A or B launch and no
    level entry."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda import graph
    cfg = kt.TrackingConfig(sequential_mode=True, **kw)
    frames = batched_frames(5, 5)
    b, t = frames.shape[:2]
    x, y, val = (np.full((b, 160), v, dt) for v, dt in
                 ((0.0, np.float32), (0.0, np.float32), (-1, np.int32)))
    for i in range(b):
        fl = kt.FeatureList.create(150 - 10 * i)
        kt.KLTracker(cfg).select_good_features(frames[i, 0], fl)
        x[i, :len(fl.x)], y[i, :len(fl.x)], val[i, :len(fl.x)] = \
            fl.x, fl.y, fl.val
    f = torch.from_numpy(frames)
    feats = [torch.from_numpy(a) for a in (x, y, val)]
    fd, featd = f.to(dev), [a.to(dev) for a in feats]
    cuda.reset_launch_counts()
    got = track_sequences_batched(fd, *featd, cfg)
    counts = {k.symbol: k.launches for k in cuda.KERNELS}
    assert counts == {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.PYRAMID_BATCHED.symbol: t,
        cuda.LK_PYRAMID_BATCHED.symbol: t - 1}
    cuda.reset_launch_counts()
    pre = track_sequences_batched(fd, *featd, cfg, precomp=True)
    assert cuda.PYRAMID_BATCHED.launches == \
        1 + len(graph.chunk_lengths(t - 1, graph.K))
    assert_equal_all(pre, got)
    assert_equal_all(got, track_sequences_batched(fd, *featd, cfg,
                                                  plain=True))
    assert_equal_all([g.cpu() for g in got],
                     track_sequences_batched(f, *feats, cfg))
    for i in range(b):
        one = track_sequence(fd[i], *[a[i] for a in featd], cfg)
        assert_equal_all([g[:, i] for g in got], one)
    live = val >= 0
    assert (got[2][-1].cpu().numpy()[live] == kt.TRACKED).mean() > 0.9


PYRAMID_CASES = LEVEL_CASES + ["one_level"]


def pyramid_features(shape, rng):
    """Features for a whole frame pair: most inside the 320x240 frame, a
    few at its border and outside it, a few lost (val < 0)."""
    x = rng.uniform(1, 318, shape).astype(np.float32)
    y = rng.uniform(1, 238, shape).astype(np.float32)
    val = np.where(rng.rand(*shape) > 0.1, 0, -1 - rng.randint(0, 5, shape))
    edge = rng.rand(*shape) < 0.15  # along the border margin
    x[edge] = rng.choice([8.0, 24.2, 295.8, 311.5, 330.0], int(edge.sum()))
    return [torch.from_numpy(a) for a in (x, y, val.astype(np.int32))]


@pytest.mark.parametrize("name", PYRAMID_CASES)
def test_lk_pyramid_kernel_equals_level_loop(name, dev):
    """Kernel B's pyramid entry (one launch per frame pair) equals the
    torch level loop with the plain levels, on the card and on the CPU,
    and with the level entries."""
    from klt_tpu_torch import cuda
    cfg, st, _, _, _ = level_case(name, dev)
    feats = pyramid_features((256,), np.random.RandomState(8))
    featd = [a.to(dev) for a in feats]
    cuda.reset_launch_counts()
    got = track_features_pyramid_stacks(st[0], st[1], *featd, cfg)
    assert (cuda.LK_PYRAMID.launches, cuda.LK_LEVEL.launches) == (1, 0)
    assert_equal_all(got, track_features_pyramid_stacks(
        st[0], st[1], *featd, cfg, plain=True))
    assert cuda.LK_LEVEL.launches == 0
    assert_equal_all(got, track_features_pyramid_levels(st[0], st[1], *featd,
                                                        cfg))
    assert cuda.LK_LEVEL.launches == cfg.n_pyramid_levels
    cpu = track_features_pyramid_stacks([s.cpu() for s in st[0]],
                                        [s.cpu() for s in st[1]], *feats, cfg)
    assert_equal_all([g.cpu() for g in got], cpu)
    lost = feats[2] < 0
    for g, a in zip(got, feats):  # lost features pass through
        assert torch.equal(g.cpu()[lost], a[lost])
    assert len(set(got[2].cpu()[~lost].tolist())) > 1
    assert name == "one_level" or cfg.n_pyramid_levels > 1


def test_lk_pyramid_kernel_level_smaller_than_window(dev):
    """A coarse level that cannot hold the window: every live lane is OOB
    there, at that level's scale, without sampling."""
    cfg = kt.TrackingConfig(search_range=60)
    assert cfg.n_pyramid_levels == 3
    frames = synthetic_frames(2)[:, :120, :160]
    st = [build_pyramid_stacks(torch.from_numpy(
        np.ascontiguousarray(f)).to(dev), cfg) for f in frames]
    assert st[0][2].shape[-2] < cfg.window_height + 1
    feats = [a.to(dev) for a in pyramid_features(
        (64,), np.random.RandomState(9))]
    got = track_features_pyramid_stacks(st[0], st[1], *feats, cfg)
    assert_equal_all(got, track_features_pyramid_stacks(
        st[0], st[1], *feats, cfg, plain=True))
    assert (got[2][feats[2] >= 0] == kt.OOB).all()


@pytest.mark.parametrize("name", PYRAMID_CASES + ["b32"])
def test_batched_lk_pyramid_kernel_equals_level_loop_and_kernel_b(name, dev):
    """Kernel C's pyramid entry equals the torch level loop with the plain
    levels bit for bit, its lane b equals kernel B's pyramid entry on
    sequence b, and it takes stacks that are slices of larger ones."""
    from klt_tpu_torch import cuda
    cfg, st1, st2, _, _, _ = batched_level_case(name, dev)
    b = st1[0].shape[0]
    n = 150 if name == "b32" else 256
    feats = pyramid_features((b, n), np.random.RandomState(10))
    featd = [a.to(dev) for a in feats]
    cuda.reset_launch_counts()
    got = track_features_pyramid_stacks(st1, st2, *featd, cfg)
    counts = {k.symbol: k.launches for k in cuda.KERNELS}
    assert counts == {k.symbol: 0 for k in cuda.KERNELS} | {
        cuda.LK_PYRAMID_BATCHED.symbol: 1}
    assert_equal_all(got, track_features_pyramid_stacks(
        st1, st2, *featd, cfg, plain=True))
    assert_equal_all(got, track_features_pyramid_levels(st1, st2, *featd,
                                                        cfg))
    for i in range(b):
        one = track_features_pyramid_stacks(
            [s[i] for s in st1], [s[i] for s in st2],
            *[a[i] for a in featd], cfg)
        assert_equal_all([g[i] for g in got], one)
    both = [torch.cat([u, v]) for u, v in zip(st1, st2)]
    assert_equal_all(got, track_features_pyramid_stacks(
        [s[:b] for s in both], [s[b:] for s in both], *featd, cfg))
    if b == 3:
        cpu = track_features_pyramid_stacks(
            [s.cpu() for s in st1], [s.cpu() for s in st2], *feats, cfg)
        assert_equal_all([g.cpu() for g in got], cpu)


def test_lk_pyramid_kernels_reject_bad_inputs(dev):
    from klt_tpu_torch.cuda.lk_level import (lk_pyramid_batched_cuda,
                                             lk_pyramid_cuda)
    cfg, st, _, _, _ = level_case("default", dev)
    x, y, val = (a.to(dev) for a in pyramid_features(
        (16,), np.random.RandomState(1)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk_pyramid_cuda(st[0], st[1], x.cpu(), y, val, cfg)
    with pytest.raises(ValueError, match="n_pyramid_levels"):
        lk_pyramid_cuda(st[0][:1], st[1], x, y, val, cfg)
    with pytest.raises(ValueError, match="val must be"):
        lk_pyramid_cuda(st[0], st[1], x, y, val.long(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        lk_pyramid_cuda([st[0][0].transpose(1, 2).contiguous()
                         .transpose(1, 2), st[0][1]], st[1], x, y, val, cfg)
    with pytest.raises(ValueError, match="do not fit"):
        lk_pyramid_batched_cuda([s[None] for s in st[0]],
                                [s[None] for s in st[1]], x, y, val, cfg)
    deep = kt.TrackingConfig(n_pyramid_levels=9, subsampling=2)
    with pytest.raises(ValueError, match="at most 8"):
        lk_pyramid_cuda([st[0][0]] * 9, [st[1][0]] * 9, x, y, val, deep)
    empty = [a[:0] for a in (x, y, val)]
    out = lk_pyramid_cuda(st[0], st[1], *empty, cfg)
    assert [tuple(o.shape) for o in out] == [(0,)] * 3
    assert out[2].dtype == torch.int32


# ------------------------------------------------------------------ #
# the bit-exact tier: kernel A as its pyramid, H2, G, R's tie entry   #
# ------------------------------------------------------------------ #

def assert_bits_equal_all(got, ref):
    """Equal shapes, dtypes and bits (-0.0 and +0.0 differ)."""
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a.cpu(), b.cpu())


EXACT_CASES = exact_cases()


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", range(len(EXACT_CASES)),
                         ids=[c[0] for c in EXACT_CASES])
def test_exact_pyramid_and_response_kernels_equal_plain(case, smooth, dev):
    """Kernel A as the exact tier takes it (every level, and level 0
    alone without the pre-smoothing) and H2 on its level-0 gradients (the
    entry the wrapper picks, and the global-memory entry), against their
    plain versions on the card and on the CPU, bit for bit."""
    from klt_tpu_torch.cuda.exact import exact_response_global_cuda
    from klt_tpu_torch.ops.pyramid import (build_pyramid_stacks,
                                           build_pyramid_stacks_plain)
    from klt_tpu_torch.ops.replace_exact import (exact_response_from_grads,
                                                 exact_response_plain)
    _, kw, frame = EXACT_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    n = cfg.n_pyramid_levels if smooth else 1
    img = torch.from_numpy(frame).to(dev)
    got = build_pyramid_stacks(img, cfg, n, smooth)
    assert_bits_equal_all(got, build_pyramid_stacks_plain(img, cfg, n, smooth))
    assert_bits_equal_all(got, build_pyramid_stacks_plain(img.cpu(), cfg, n,
                                                          smooth))
    resp = exact_response_from_grads(got[0][1], got[0][2], cfg)
    win = (cfg.window_width, cfg.window_height)
    ref = exact_response_plain(got[0][1], got[0][2], *win)
    assert_bits_equal_all([resp], [ref])
    assert_bits_equal_all(
        [exact_response_global_cuda(got[0][1], got[0][2], *win)], [ref])


@pytest.mark.parametrize("case", range(len(RESPONSE_CASES)),
                         ids=[c[0] for c in RESPONSE_CASES])
def test_exact_response_entries_equal_plain(case, dev):
    """Kernel H2's tiled entry (every window of response_cases fits its
    tile) and its global-memory entry, one call each, the plain version's
    bits on the card and on the CPU; the plain model's tile rule is the
    library's."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda.exact import (exact_response_cuda,
                                          exact_response_global_cuda,
                                          library_exact_tile_rows)
    from klt_tpu_torch.ops.replace_exact import (exact_response_plain,
                                                 exact_response_tile)
    _, gx, gy, win = RESPONSE_CASES[case]
    gx, gy = torch.from_numpy(gx).to(dev), torch.from_numpy(gy).to(dev)
    for w in (win, (121, 121), (115, 115), (117, 117)):
        assert exact_response_tile(*w) == library_exact_tile_rows(*w)
    cuda.reset_launch_counts()
    got = exact_response_cuda(gx, gy, *win)
    assert (cuda.EXACT_RESPONSE.launches,
            cuda.EXACT_RESPONSE_GLOBAL.launches) == (1, 0)
    ref = exact_response_plain(gx, gy, *win)
    assert_bits_equal_all([got], [ref])
    assert_bits_equal_all([exact_response_global_cuda(gx, gy, *win)], [ref])
    assert_bits_equal_all([got], [exact_response_plain(gx.cpu(), gy.cpu(),
                                                       *win)])


def test_exact_response_takes_the_global_entry_for_a_wide_window(dev):
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda.exact import exact_response_cuda
    from klt_tpu_torch.ops.replace_exact import exact_response_plain
    rng = np.random.RandomState(41)
    gx, gy = (torch.from_numpy(rng.normal(0, 30, (150, 170)).astype(
        np.float32)).to(dev) for _ in range(2))
    cuda.reset_launch_counts()
    got = exact_response_cuda(gx, gy, 121, 121)
    assert (cuda.EXACT_RESPONSE.launches,
            cuda.EXACT_RESPONSE_GLOBAL.launches) == (0, 1)
    assert_bits_equal_all([got], [exact_response_plain(gx, gy, 121, 121)])


LK_EXACT_CASES = exact_lk_cases()


@pytest.mark.parametrize("case", range(len(LK_EXACT_CASES)),
                         ids=[c[0] for c in LK_EXACT_CASES])
def test_exact_track_kernel_equals_plain(case, dev):
    from klt_tpu_torch.ops.lk_exact import (build_pyramids_exact,
                                            track_features_exact)
    _, kw, f1, f2, x, y, val = LK_EXACT_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    p1 = build_pyramids_exact(torch.from_numpy(f1).to(dev), cfg)
    p2 = build_pyramids_exact(torch.from_numpy(f2).to(dev), cfg)
    feats = [torch.from_numpy(a).to(dev) for a in (x, y, val)]
    got = track_features_exact(p1, p2, *feats, cfg)
    assert_bits_equal_all(got, track_features_exact(p1, p2, *feats, cfg,
                                                    plain=True))
    assert_bits_equal_all(got, track_features_exact(
        [s.cpu() for s in p1], [s.cpu() for s in p2],
        *[f.cpu() for f in feats], cfg))


TIE_STATES = replace_cases() + exact_replace_cases()


@pytest.mark.parametrize("case", range(len(TIE_STATES)),
                         ids=[c[0] for c in TIE_STATES])
def test_replace_tie_entry_equals_plain(case, dev):
    from klt_tpu_torch.ops.replace_exact import replace_lost_exact_
    _, kw, resp, x, y, val = TIE_STATES[case]
    cfg = kt.TrackingConfig(**kw)
    outs = []
    for plain in (False, True):
        state = [torch.from_numpy(a.copy()).to(dev) for a in (x, y, val)]
        tie = torch.full((1,), 7, dtype=torch.int32, device=dev)
        replace_lost_exact_(torch.from_numpy(resp).to(dev), *state, cfg, tie,
                            plain=plain)
        outs.append(state + [tie])
    assert_bits_equal_all(*outs)


def exact_sequence_inputs(n_frames=8, n=150):
    cfg = kt.TrackingConfig(sequential_mode=True)
    frames = tie_frames(synthetic_frames(n_frames), 5)
    fl = kt.FeatureList.create(n)
    kt.KLTracker(cfg).select_good_features(frames[0], fl)
    return cfg, frames, (fl.x, fl.y, fl.val)


@pytest.mark.parametrize("tier", ["exact", "fast"])
def test_track_sequence_replace_exact_kernels_equal_plain(tier, dev,
                                                          monkeypatch):
    """Kernels on the card, plain on the card and plain on the CPU:
    bit-equal tables.  With kernels no plain version runs (each raises
    here), and every step computed is one launch each of A, H2 and R's
    tie entry and of G (exact tier) or B (fast tier), plus A once for the
    first frame and H2 once more for each frame repaired on the host."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.ops import lk_exact, pyramid, replace_exact
    from klt_tpu_torch.runtime import pipeline
    cfg, frames, feats = exact_sequence_inputs()
    repaired = []
    orig = pipeline._repair_replacement_host
    monkeypatch.setattr(pipeline, "_repair_replacement_host",
                        lambda *a: repaired.append(1) or orig(*a))

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the kernel path")

    with monkeypatch.context() as m:
        for mod, name in ((lk_exact, "track_features_exact_plain"),
                          (pyramid, "build_pyramid_stacks_plain"),
                          (replace_exact, "exact_response_plain"),
                          (replace_exact, "replace_lost_plain_")):
            m.setattr(mod, name, refuse)
        cuda.reset_launch_counts()
        got = kt.track_sequence_replace_exact(frames, *feats, cfg, tier=tier)
        torch.cuda.synchronize()
    c = {k.symbol: k.launches for k in cuda.KERNELS}
    steps = c["klt_replace_lost_tie"]
    rep = len(repaired)
    assert rep >= 1 and steps >= len(frames) - 1
    assert c["klt_exact_track" if tier == "exact" else "klt_lk_pyramid"] == \
        steps
    assert c["klt_build_pyramid"] == 1 + steps
    assert c["klt_exact_response"] == steps + rep
    assert got[0].device.type == "cuda"
    plain_card = kt.track_sequence_replace_exact(frames, *feats, cfg,
                                                 tier=tier, plain=True)
    plain_cpu = kt.track_sequence_replace_exact(frames, *feats, cfg,
                                                tier=tier, device="cpu")
    assert_bits_equal_all(got, plain_card)
    assert_bits_equal_all(got, plain_cpu)


def test_exact_wrappers_refuse_cpu_tensors(dev):
    from klt_tpu_torch.cuda.exact import exact_response_cuda, track_exact_cuda
    from klt_tpu_torch.cuda.pyramid import build_pyramid_stacks_cuda
    from klt_tpu_torch.cuda.replace import replace_lost_tie_cuda_
    cfg = kt.TrackingConfig()
    img = torch.zeros(60, 80, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        build_pyramid_stacks_cuda(img, cfg, 1, smooth=False)
    st = build_pyramid_stacks_cuda(img.to(dev), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        exact_response_cuda(st[0][1].cpu(), st[0][2].cpu(), 7, 7)
    x = torch.full((4,), 30.0)
    val = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        track_exact_cuda(st, st, x, x, val, cfg)
    tie = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        replace_lost_tie_cuda_(st[0][1].cpu(), x, x, val, cfg, tie)
    with pytest.raises(ValueError, match="tie must be"):
        replace_lost_tie_cuda_(st[0][1], x.to(dev), x.to(dev), val.to(dev),
                               cfg, tie.cpu())


# ------------------------------------------------------------------ #
# the selection prefilter and the SLAM back end (plain torch on both    #
# sides: the card's results against the CPU's)                          #
# ------------------------------------------------------------------ #

def test_prefilter_on_card_equals_cpu(dev):
    """cell_topk of a response on the card is the CPU's to the bit, and
    KLTracker(prefilter=True) on the card (the cut made from the card's
    response) selects and replaces what the CPU tracker and the full list
    do."""
    from klt_tpu_torch.ops.selection import cell_topk
    frames = replace_frames(6)
    cfg = kt.TrackingConfig(sequential_mode=True)
    st = build_pyramid_stacks_plain(torch.from_numpy(frames[1]), cfg)
    resp = corner_response_plain(st[0][1], st[0][2], 7, 7)
    for cell, k, step in ((10, 4, 1), (7, 1, 1), (3, 8, 2)):
        card = cell_topk(resp.to(dev), cell, k, 24, 24, step)
        cpu = cell_topk(resp, cell, k, 24, 24, step)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
    out = []
    for device, pre in ((dev, True), ("cpu", True), (dev, False)):
        tr = kt.KLTracker(cfg, device, prefilter=pre)
        fl = kt.FeatureList.create(150)
        tr.select_good_features(frames[0], fl)
        for i in range(1, 6):
            tr.track_features(frames[i - 1], frames[i], fl)
            tr.replace_lost_features(frames[i], fl)
        out.append(fl)
    for fl in out[1:]:
        for f in ("x", "y", "val"):
            np.testing.assert_array_equal(getattr(out[0], f), getattr(fl, f))


def slam_problem(seed, n_pose=6, n_lm=200, noise=0.3):
    """A BA problem (every landmark seen by every pose, 0.3 px of noise,
    poses and landmarks perturbed) as numpy fields."""
    from klt_tpu_torch.slam.geometry import project, so3_exp
    rng = np.random.RandomState(seed)
    lm = rng.uniform([-2, -2, 4], [2, 2, 8], (n_lm, 3)).astype(np.float32)
    w = rng.randn(n_pose, 3).astype(np.float32) * 0.02
    R = so3_exp(torch.from_numpy(w)).numpy()
    t = np.stack([[0.1 * p, 0, 0] for p in range(n_pose)]).astype(np.float32)
    cam = np.repeat(np.arange(n_pose, dtype=np.int32), n_lm)
    lmi = np.tile(np.arange(n_lm, dtype=np.int32), n_pose)
    pc = np.einsum("mij,mj->mi", R[cam], lm[lmi]) + t[cam]
    uv = project(torch.from_numpy(pc.astype(np.float32)), 300.0, 300.0,
                 160.0, 120.0).numpy()
    uv = (uv + noise * rng.randn(*uv.shape)).astype(np.float32)
    t0 = t + 0.02 * rng.randn(n_pose, 3).astype(np.float32)
    t0[0] = t[0]
    return dict(R=R, t=t0.astype(np.float32),
                landmarks=(lm + 0.05 * rng.randn(n_lm, 3)).astype(
                    np.float32), cam_idx=cam, lm_idx=lmi, uv=uv,
                weight=np.ones(len(cam), np.float32), fx=300.0, fy=300.0,
                cx=160.0, cy=120.0)


def slam_graph(seed, n=12):
    from klt_tpu_torch.slam.geometry import so3_exp
    rng = np.random.RandomState(seed)
    R = so3_exp(torch.from_numpy(rng.randn(n, 3).astype(np.float32) *
                                 0.1)).numpy()
    t = rng.randn(n, 3).astype(np.float32)
    ei = np.r_[np.arange(n - 1), 0, 3].astype(np.int32)
    ej = np.r_[np.arange(1, n), n - 1, 9].astype(np.int32)
    Rz = np.einsum("eij,ekj->eik", R[ei], R[ej])
    tz = t[ei] - np.einsum("eij,ej->ei", Rz, t[ej]) + \
        0.01 * rng.randn(len(ei), 3)
    dR = so3_exp(torch.from_numpy(rng.randn(n, 3).astype(np.float32) *
                                  0.05)).numpy()
    R0 = np.einsum("pij,pjk->pik", dR, R)
    R0[0] = R[0]
    return dict(R=R0.astype(np.float32), t=t, ei=ei, ej=ej,
                Rz=Rz.astype(np.float32), tz=tz.astype(np.float32),
                weight=np.ones(len(ei), np.float32))


def assert_steps_close(card, cpu, old, tol=1e-4):
    """The card's new state within tol of the CPU's, relative to the
    step's size (both plain torch; the matrix products and solves round
    differently)."""
    for a, b, o in zip(card, cpu, old):
        a, b, o = a.cpu().numpy(), b.numpy(), o.numpy()
        assert np.abs(a - b).max() <= tol * np.abs(b - o).max()


def bits(out):
    return [o.view(torch.int32) if o.dtype == torch.float32 else o
            for o in out]


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ba_step_on_card_equals_cpu_and_repeats(solver, dev):
    from klt_tpu_torch.interop import ba_problem_from_numpy
    from klt_tpu_torch.slam import ba
    f = slam_problem(1)
    res = []
    for device in (dev, dev, "cpu"):
        P = ba_problem_from_numpy(f, device)
        plan = ba._plan_of(P, joint=solver == "dense")
        lam = torch.tensor(10.0, device=device)
        state = (P.R[None], P.t[None], P.landmarks[None])
        if solver == "dense":
            out = ba._gn_step(*state, plan, P.uv, P.weight, P.consts, lam,
                              True)
        else:
            out = ba._gn_step_cg(*state, plan, P.uv, P.weight, P.consts,
                                 lam, True, 250, 1e-5)
        res.append([o.cpu() for o in out])
    for a, b in zip(bits(res[0]), bits(res[1])):
        assert torch.equal(a, b)  # two runs on the card: the same bits
    P = ba_problem_from_numpy(f)
    assert_steps_close(res[0][:3], res[2][:3],
                       (P.R[None], P.t[None], P.landmarks[None]))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_step_on_card_equals_cpu_and_repeats(solver, dev):
    from klt_tpu_torch.interop import pose_graph_from_numpy
    from klt_tpu_torch.slam import pose_graph
    f = slam_graph(2)
    res = []
    for device in (dev, dev, "cpu"):
        G = pose_graph_from_numpy(f, device)
        plan = pose_graph._Plan(G, G.R.shape[0], dense=solver == "dense")
        lam = torch.tensor(1e-3, device=device)
        if solver == "dense":
            out = pose_graph._gn_step(G.R, G.t, G, plan, lam, True)
        else:
            out = pose_graph._gn_step_cg(G.R, G.t, G, plan, lam, True, 200,
                                         1e-6)
        res.append([o.cpu() for o in out])
    for a, b in zip(bits(res[0]), bits(res[1])):
        assert torch.equal(a, b)
    G = pose_graph_from_numpy(f)
    assert_steps_close(res[0], res[2], (G.R, G.t))


def test_pair_solve_on_card_equals_cpu_and_repeats(dev):
    """The keyframe pair solve (the hand-batched two-pose LM of
    slam/frontend.py) on the card: twice the same bits, and the CPU's
    poses within 1e-5."""
    from klt_tpu_torch.slam import frontend
    f = slam_problem(3, n_pose=5, n_lm=120, noise=0.2)
    lm_idx, cam, uv = f["lm_idx"], f["cam_idx"], f["uv"]
    res = []
    for device in (dev, dev, "cpu"):
        pg = frontend.build_keyframe_pose_graph(lm_idx, cam, uv[:, 0],
                                                uv[:, 1], 5, 300.0, 300.0,
                                                160.0, 120.0, device=device)
        res.append([pg.R.cpu(), pg.t.cpu(), pg.Rz.cpu(), pg.tz.cpu()])
    for a, b in zip(bits(res[0]), bits(res[1])):
        assert torch.equal(a, b)
    for a, b in zip(res[0], res[2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def solver_cases(dev):
    """Each solver entry point and its eager body on small problems on
    the card: name -> (graphed, eager, LM iterations, refit steps)."""
    from chip_smoke import spiked_ba_fields
    from klt_tpu_torch.interop import (ba_problem_from_numpy,
                                       pose_graph_from_numpy)
    from klt_tpu_torch.slam import ba, pose_graph
    P = ba_problem_from_numpy(slam_problem(1), dev)
    S = ba_problem_from_numpy(spiked_ba_fields(n_pose=6, n_lm=120)[0], dev)
    G = pose_graph_from_numpy(slam_graph(2), dev)
    gated = dict(rounds=3, iterations=5, damping=1e-2, robust_delta=2.0,
                 gate_px=3.0, cg_iters=60)
    pg = pose_graph.optimize_pose_graph
    pg_eager = pose_graph._optimize_pose_graph_eager
    return {
        "bundle_adjust": (
            lambda: ba.bundle_adjust(P, iterations=5, damping=1e-4),
            lambda: ba._bundle_adjust_eager(P, 5, 1e-4), 5, 0),
        "bundle_adjust_cg": (
            lambda: ba.bundle_adjust_cg(P, iterations=5, damping=1e-4,
                                        cg_iters=30),
            lambda: ba._bundle_adjust_eager(P, 5, 1e-4, cg=(30, 1e-5)), 5,
            0),
        "bundle_adjust_cg huber": (
            lambda: ba.bundle_adjust_cg(P, iterations=5, damping=1e-4,
                                        cg_iters=30, robust_delta=2.0),
            lambda: ba._bundle_adjust_eager(P, 5, 1e-4, robust_delta=2.0,
                                            cg=(30, 1e-5)), 5, 0),
        "bundle_adjust_gated": (
            lambda: ba.bundle_adjust_gated(S, **gated),
            lambda: ba._bundle_adjust_gated_eager(S, **gated), 15, 6),
        "optimize_pose_graph dense": (
            lambda: pg(G, iterations=6),
            lambda: pg_eager(G, iterations=6), 6, 0),
        "optimize_pose_graph cg": (
            lambda: pg(G, iterations=6, solver="cg", cg_iters=40),
            lambda: pg_eager(G, iterations=6, solver="cg", cg_iters=40), 6,
            0),
    }


@pytest.mark.parametrize("case", [
    "bundle_adjust", "bundle_adjust_cg", "bundle_adjust_cg huber",
    "bundle_adjust_gated", "optimize_pose_graph dense",
    "optimize_pose_graph cg"])
def test_solver_programs_equal_eager_body(case, dev):
    """A solver's programs on the card, every step run (warm-up and
    capture) under the sync debug mode's "error": bit-equal to its eager
    body, each LM iteration after the first (each refit step after the
    first) a replay, and nothing returned in a static buffer."""
    from chip_smoke import check_replays, made_solves, strict_programs
    graphed, eager, its, refits = solver_cases(dev)[case]
    with made_solves() as made, strict_programs():
        got = graphed()
    torch.cuda.synchronize()
    ref = eager()
    assert len(made) == 1
    solve = made[0]
    kept = [a.clone() for a in got if isinstance(a, torch.Tensor)]
    graphed()   # a later solve changes nothing the first returned
    for a, b in zip([a for a in got if isinstance(a, torch.Tensor)], kept):
        assert torch.equal(bits([a])[0], bits([b])[0])
    for a, b in zip(got, ref):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert torch.equal(bits([a])[0], bits([b])[0])
    check_replays(case, solve, its, refits)


def test_pair_solve_program_equals_eager_body(dev, monkeypatch):
    """build_keyframe_pose_graph's pair solves: one program, its LM
    iterations after the first replays, bit-equal to the eager body and
    the pose graph they build too."""
    from chip_smoke import check_replays, made_solves, strict_programs
    from klt_tpu_torch.slam import frontend
    f = slam_problem(3, n_pose=5, n_lm=120, noise=0.2)
    args = (f["lm_idx"], f["cam_idx"], f["uv"][:, 0], f["uv"][:, 1], 5,
            300.0, 300.0, 160.0, 120.0)
    with made_solves() as made, strict_programs():
        got = frontend.build_keyframe_pose_graph(*args, device=dev)
    monkeypatch.setattr(frontend, "_pair_solve", frontend._pair_solve_eager)
    ref = frontend.build_keyframe_pose_graph(*args, device=dev)
    for k in ("R", "t", "ei", "ej", "Rz", "tz", "weight"):
        assert torch.equal(bits([getattr(got, k)])[0],
                           bits([getattr(ref, k)])[0])
    assert len(made) == 1
    check_replays("pair solves", made[0], 8)


def test_solver_capture_error_raises(dev, monkeypatch):
    """A step that reads the host runs in the solve's first LM iteration
    (eager) and fails its capture in the second, which raises: nothing
    falls back to the eager body; the card goes on."""
    from klt_tpu_torch.interop import pose_graph_from_numpy
    from klt_tpu_torch.slam import pose_graph
    G = pose_graph_from_numpy(slam_graph(2), dev)
    orig = pose_graph._edge_cost

    def reads_host(R, t, pg):
        c = orig(R, t, pg)
        float(c)
        return c
    monkeypatch.setattr(pose_graph, "_edge_cost", reads_host)
    with pytest.raises(RuntimeError):
        pose_graph.optimize_pose_graph(G, iterations=3, solver="cg",
                                       cg_iters=16)
    torch.cuda.synchronize()
    monkeypatch.setattr(pose_graph, "_edge_cost", orig)
    out = pose_graph.optimize_pose_graph(G, iterations=3, solver="cg",
                                         cg_iters=16)
    assert bool(torch.isfinite(out[2]).all())


# ------------------------------------------------------------------ #
# the tooling and multi-device on the card                             #
# ------------------------------------------------------------------ #

def test_world_of_one_nccl_mesh_equals_no_mesh(dev):
    """Every mesh entry point over a world of one on NCCL (make_mesh
    starts it) bit-equal to mesh=None, on the card."""
    import torch.distributed as dist
    from klt_tpu_torch.parallel import make_mesh
    from klt_tpu_torch.parallel.worker import (bits_equal, solver_runs,
                                               tracking_runs)
    assert not dist.is_initialized()
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl"
        runs = tracking_runs(mesh, None, 16, dev) + \
            tracking_runs(make_mesh({"data": 1, "feat": 1}), "feat", 16,
                          dev) + solver_runs(mesh, dev)
        assert len(runs) == 9
        for name, got, ref in runs:
            assert all(bits_equal(g, r) for g, r in zip(got, ref)), name
    finally:
        dist.destroy_process_group()


def test_checks_launch_nothing_when_off(dev, monkeypatch):
    """With KLT_TPU_DEBUG unset a check makes no device launch and no host
    sync; with it set, one sync (the flag's read) and one warning."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    from klt_tpu_torch.utils import checks
    x = torch.tensor([3.0, -1.0], device=dev)
    y = torch.tensor([3.0, 4.0], device=dev)
    torch.cuda.synchronize()

    def run():
        checks.check_in_bounds(x, y, 80, 64, "lanes")
        checks.check_finite(x, "x")
        checks.check_same_shape(x, y, "pair")

    monkeypatch.delenv("KLT_TPU_DEBUG", raising=False)
    with warnings.catch_warnings(record=True):   # the mode's first use
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    msgs = [str(w.message) for w in caught]
    assert not [m for m in msgs if "synchroniz" in m or "debug check" in m], \
        msgs
    assert not [e for e in prof.events() if "CUDA" in str(e.device_type) or
                "LaunchKernel" in e.name]
    monkeypatch.setenv("KLT_TPU_DEBUG", "1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    msgs = [str(w.message) for w in caught]
    assert sum("debug check failed: lanes" in m for m in msgs) == 1
    assert sum("synchroniz" in m for m in msgs) >= 1


def test_write_internal_images_from_card_tensors(dev, tmp_path):
    """The PGMs of kernel A's stacks on the card are the plain CPU
    stacks' bytes."""
    from klt_tpu_torch.utils.debug import write_internal_images
    img = scene()
    cfg = kt.TrackingConfig()
    out = {}
    for name, st in (("card", build_pyramid_stacks(
            torch.from_numpy(img).to(dev), cfg)),
            ("cpu", build_pyramid_stacks_plain(torch.from_numpy(img), cfg))):
        paths = write_internal_images([s[0] for s in st], [s[1] for s in st],
                                      [s[2] for s in st],
                                      str(tmp_path / name))
        out[name] = [open(p, "rb").read() for p in paths]
    assert len(out["card"]) == 3 * cfg.n_pyramid_levels
    assert out["card"] == out["cpu"]


# ------------------------------------------------------------------ #
# whole-sequence programs: the entries' CUDA graphs (cuda/graph.py)    #
# ------------------------------------------------------------------ #

GRAPH_ENTRIES = ["track", "replace", "affine", "precomp", "batched",
                 "batched_affine", "stream", "exact", "fast"]


def eagerly(fn):
    """fn with every chunk of its programs run eagerly
    (chip_smoke.eager_chunks: Program.run's warm_up=True)."""
    def run(*args):
        with eager_chunks():
            return fn(*args)
    return run


def graph_cell(entry, dev):
    """(graphed run, the same run with its chunks run eagerly) of a small
    cell of `entry`, each returning its table: 2K + 2 frames (full chunks
    and a tail of one), the stream in chunks of 8, the exact tier in
    chunks of 4 over tie_frames, whose repair resumes inside a chunk."""
    from klt_tpu_torch.cuda import graph
    n_frames = 2 * graph.K + 2
    if entry in ("exact", "fast"):
        cfg, frames, feats = exact_sequence_inputs(12)
        f = torch.from_numpy(frames).to(dev)
        featd = [torch.from_numpy(a).to(dev) for a in feats]
        run = lambda: kt.track_sequence_replace_exact(
            f, *featd, cfg, tier=entry, chunk=4)
        return run, eagerly(run)
    if entry.startswith("batched"):
        mode = 2 if entry == "batched_affine" else -1
        cfg = kt.TrackingConfig(sequential_mode=True,
                                affine_consistency_check=mode)
        frames = (batched_affine_frames(3, n_frames, rate=0.1) if mode == 2
                  else batched_frames(3, n_frames))
        lists = [kt.FeatureList.create(100) for _ in range(3)]
        for i, fl in enumerate(lists):
            kt.KLTracker(cfg).select_good_features(frames[i, 0], fl)
        featd = [torch.from_numpy(np.stack([getattr(fl, k) for fl in lists]))
                 .to(dev) for k in ("x", "y", "val")]
        fd = torch.from_numpy(frames).to(dev)
        seq = (track_sequences_affine_batched if mode == 2
               else track_sequences_batched)
        run = lambda: seq(fd, *featd, cfg)
        return run, eagerly(run)
    mode = 2 if entry == "affine" else -1
    cfg = kt.TrackingConfig(sequential_mode=True,
                            affine_consistency_check=mode)
    frames = (affine_frames(n_frames, rate=0.1) if mode == 2
              else replace_frames(n_frames, 1))
    fl = kt.FeatureList.create(150)
    kt.KLTracker(cfg).select_good_features(frames[0], fl)
    featd = [torch.from_numpy(a).to(dev) for a in (fl.x, fl.y, fl.val)]
    fd = torch.from_numpy(frames).to(dev)
    if entry == "stream":
        def run():
            snaps = list(track_sequence_stream(iter(fd), *featd, cfg,
                                               chunk=8))
            return [torch.from_numpy(np.stack([s[i] for s in snaps]))
                    for i in (1, 2, 3)]
        return run, eagerly(run)
    seq = {"replace": track_sequence_replace,
           "affine": track_sequence_affine}.get(entry, track_sequence)
    run = lambda: seq(fd, *featd, cfg, precomp=entry == "precomp")
    return run, eagerly(run)


@pytest.mark.parametrize("entry", GRAPH_ENTRIES)
def test_graphed_entry_equals_eager(entry, dev):
    """A graphed entry's first call (the warm-up chunk, then captures) and
    its second (replays) are bit-equal to the same call with every chunk
    run eagerly; each call counts the eager run's kernel launches,
    credited per replay (the exact tier: one launch each of A, G or B, H2
    and R's tie entry a computed step; with precomp E once a chunk)."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda import graph
    graphed, eager = graph_cell(entry, dev)
    graph._clear()
    counts, outs, replays = [], [], []
    for fn in (graphed, graphed, eager):
        cuda.reset_launch_counts()
        before = sum(p.replays for _, p in graph.programs())
        outs.append(fn())
        torch.cuda.synchronize()
        replays.append(sum(p.replays for _, p in graph.programs()) - before)
        counts.append({k.symbol: k.launches for k in cuda.KERNELS})
    assert_equal_all(outs[0], outs[2])
    assert_equal_all(outs[1], outs[2])
    assert replays[1] > 0 and replays[2] == 0
    if entry in ("exact", "fast"):
        for c in counts:
            steps = c["klt_replace_lost_tie"]
            assert c["klt_build_pyramid"] == 1 + steps
    else:
        if entry == "precomp":
            assert counts[1]["klt_build_pyramid_batched"] == len(
                graph.chunk_lengths(len(outs[2][0]), graph.K))
        assert counts[0] == counts[1] == counts[2]


def test_graph_capture_error_raises(dev):
    """A chunk function that reads the host runs as the warm-up and then
    cannot be captured: the program raises, and the card goes on."""
    from klt_tpu_torch.cuda import graph
    from klt_tpu_torch.utils.checks import Flags
    flag = torch.zeros(1, device=dev)
    prog = graph.Program(None, lambda n: float(flag.sum()), dev,
                         capture=True)
    assert prog.run(1, Flags()) == 0.0
    with pytest.raises(RuntimeError):
        prog.run(1, Flags())
    assert float((flag + 1).sum()) == 1.0


def test_graph_cache_keeps_its_bound(dev):
    from klt_tpu_torch.cuda import graph
    cfg, f, feats = replace_inputs(dev, n_frames=3, n=20)
    fd, featd = f.to(dev), [a.to(dev) for a in feats]
    graph._clear()
    for n in range(graph.CACHE_KEYS + 3):
        track_sequence(fd, *[a[:n + 1] for a in featd], cfg)
    assert len(graph.programs()) == graph.CACHE_KEYS


TRACKER_CASES = {
    # name: (config fields, frames, replace every frame, calls at which
    # the flow reselects all or stops sequential mode)
    "sequential": ({"sequential_mode": True}, "scene", False, {}),
    "replace": ({"sequential_mode": True}, "scene", True, {}),
    "affine": ({"sequential_mode": True, "affine_consistency_check": 2},
               "affine", True, {4: "select"}),
    "non-sequential": ({}, "scene", True, {}),
    "stop sequential mode": ({"sequential_mode": True}, "scene", True,
                             {3: "stop"}),
}


def tracker_flow(case, n_frames=8):
    """The example3 flow of a TRACKER_CASES case at 320x240 x 150 through
    a KLTracker on the card: (the feature lists after every call, each
    kernel's launches, the tracker's graph replays)."""
    from klt_tpu_torch import cuda
    kw, frames, replace, events = TRACKER_CASES[case]
    frames = replace_frames(n_frames) if frames == "scene" else \
        affine_frames(n_frames, rate=0.1)
    tr = kt.KLTracker(kt.TrackingConfig(**kw))
    fl = kt.FeatureList.create(150)
    tr.select_good_features(frames[0], fl)
    rows = [fl.copy()]
    cuda.reset_launch_counts()
    for i in range(1, n_frames):
        if events.get(i) == "stop":
            tr.stop_sequential_mode()
        tr.track_features(frames[i - 1], frames[i], fl)
        rows.append(fl.copy())
        if events.get(i) == "select":
            tr.select_good_features(frames[i], fl)
            rows.append(fl.copy())
        elif replace:
            tr.replace_lost_features(frames[i], fl)
            rows.append(fl.copy())
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    replays = sum(p.replays for _, progs in tr._steps.values()
                  for p in progs.values())
    return rows, launches, replays


def assert_same_lists(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for k in ("x", "y", "val"):
            np.testing.assert_array_equal(getattr(a, k).view(np.int32),
                                          getattr(b, k).view(np.int32))


@pytest.mark.parametrize("case", list(TRACKER_CASES))
def test_tracker_graphs_equal_the_eager_body(case, dev):
    """KLTracker's step programs on the card: every call after a key's
    first two (warm-up, capture) a replay, the feature lists bit-equal to
    the same flow's with every step run eagerly, the same kernel launches
    (credited per replay)."""
    got, launches, replays = tracker_flow(case)
    with eager_chunks():
        ref, ref_launches, ref_replays = tracker_flow(case)
    assert_same_lists(got, ref)
    assert launches == ref_launches and ref_replays == 0
    assert replays >= {"non-sequential": 6, "stop sequential mode": 3}.get(
        case, 4)


def test_tracker_graphs_of_two_trackers_interleaved(dev):
    """Two trackers stepped call by call in turns equal their runs alone:
    no static buffer, carried slot or affine state is shared."""
    alone = [tracker_flow(c)[0]
             for c in ("replace", "affine")]
    frames = [replace_frames(8), affine_frames(8, rate=0.1)]
    cfgs = [kt.TrackingConfig(**TRACKER_CASES[c][0])
            for c in ("replace", "affine")]
    trs = [kt.KLTracker(c) for c in cfgs]
    fls = [kt.FeatureList.create(150) for _ in trs]
    rows = [[], []]
    for k in range(2):
        trs[k].select_good_features(frames[k][0], fls[k])
        rows[k].append(fls[k].copy())
    for i in range(1, 8):
        for k in range(2):
            trs[k].track_features(frames[k][i - 1], frames[k][i], fls[k])
            rows[k].append(fls[k].copy())
            if k == 1 and i == 4:
                trs[k].select_good_features(frames[k][i], fls[k])
            else:
                trs[k].replace_lost_features(frames[k][i], fls[k])
            rows[k].append(fls[k].copy())
    for got, ref in zip(rows, alone):
        assert_same_lists(got, ref)


def test_tracker_capture_error_raises(dev, monkeypatch):
    """A step that reads the host is captured at the tracker's second
    call, which raises: nothing falls back to the eager body."""
    from klt_tpu_torch.runtime import tracker as tracker_mod
    orig = tracker_mod._track_step

    def reads_host(b, *args):
        orig(b, *args)
        float(b.out.sum())
    monkeypatch.setattr(tracker_mod, "_track_step", reads_host)
    frames = replace_frames(3)
    fl = kt.FeatureList.create(150)
    tr = kt.KLTracker(kt.TrackingConfig())
    tr.select_good_features(frames[0], fl)
    tr.track_features(frames[0], frames[1], fl)
    with pytest.raises(RuntimeError):
        tr.track_features(frames[1], frames[2], fl)


def test_track_pair_carry_graph_equals_eager(dev):
    """track_pair_carry's replays bit-equal to its step run eagerly, with
    its launches; every tensor returned is the caller's: unchanged by
    later calls."""
    from klt_tpu_torch import cuda
    from klt_tpu_torch.cuda import graph
    from klt_tpu_torch.runtime import pipeline
    cfg, f, feats = replace_inputs(dev)
    f, feats = f.to(dev), [a.to(dev) for a in feats]
    graph._clear()
    outs, counts, snaps = {}, {}, {}
    for name, fn in (("graphed", pipeline.track_pair_carry),
                     ("eager", eagerly(pipeline.track_pair_carry))):
        cuda.reset_launch_counts()
        fd, state = feats, pipeline.prepare_pyramids(f[0], cfg)
        outs[name] = []
        for i in range(1, len(f)):
            fd, state = fn(state, f[i], fd, cfg)
            outs[name].append((*fd, *state))
        torch.cuda.synchronize()
        counts[name] = {k.symbol: k.launches for k in cuda.KERNELS}
        snaps[name] = [[a.clone() for a in o] for o in outs[name]]
    for o, s in zip(outs["graphed"], snaps["graphed"]):
        assert_equal_all(o, s)
    for o, e in zip(outs["graphed"], outs["eager"]):
        assert_equal_all(o, e)
    assert counts["graphed"] == counts["eager"]
    (prog,) = [p for k, p in graph.programs() if k[0] == "pair_carry"]
    assert prog.replays == len(f) - 2


# ------------------------------------------------ kernel S (select_sort.cu)

def live_pool(dev, seed=20261018):
    """The live cell's frames (benchmark/traffic/live.json takes the farm
    mix's): u8 [65, 480, 640] numpy, and its TrackingConfig."""
    import json
    from benchmark import frames as frame_gen
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "traffic", "farm.json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "benchmark", "configs",
                           "traffic_vga_500.json")) as f:
        config = json.load(f)
    pool = frame_gen.streams(config["width"], config["height"], mix, seed,
                             dev)[0]
    return pool.cpu().numpy(), kt.TrackingConfig(**config["tracking"])


def live_response(frame, cfg, dev):
    """Kernel D's map of a frame's level-0 gradients, as a sequential
    replacement computes it."""
    lvl0 = build_pyramid_stacks(torch.from_numpy(frame).to(dev), cfg)[0]
    return corner_response(lvl0[1], lvl0[2], cfg.window_width,
                           cfg.window_height)


def card_and_plain_lists(resp, cfg, k0, s_min, rounds):
    """Kernel S's list and partitions of resp, and the plain model's on a
    copy on the CPU: ((rows, state) on the card, the same from the
    model), all on the CPU."""
    from klt_tpu_torch import native
    from klt_tpu_torch.cuda.select_sort import (candidate_list_cuda,
                                                head_partitions_cuda,
                                                scratch_for)
    from klt_tpu_torch.ops.select_sort import (candidate_list_plain,
                                               head_partitions_plain)
    from klt_tpu_torch.ops.selection import candidate_count
    n = candidate_count(cfg, resp.shape[1], resp.shape[0])
    size = 3 + 2 * native.LAZY_PENDING
    rows = torch.full((n, 3), -7, dtype=torch.int32, device=resp.device)
    state = torch.full((size,), -5, dtype=torch.int64, device=resp.device)
    candidate_list_cuda(resp, cfg, rows, state)
    head_partitions_cuda(rows, state, scratch_for(n, resp.device), k0,
                         s_min, rounds)
    p_rows = torch.empty((n, 3), dtype=torch.int32)
    p_state = torch.empty(size, dtype=torch.int64)
    candidate_list_plain(resp.cpu(), cfg, p_rows, p_state)
    head_partitions_plain(p_rows, p_state, k0, s_min, rounds)
    return (rows.cpu(), state.cpu()), (p_rows, p_state)


def assert_same_sort(card, plain):
    (rows, state), (p_rows, p_state) = card, plain
    used = 3 + 2 * int(p_state[1])
    assert torch.equal(state[:used], p_state[:used])
    assert torch.equal(rows, p_rows)


@pytest.mark.parametrize("k0,s_min,rounds", [
    (8192, 4096, 64), (8192, 16384, 64), (2048, 2048, 64),
    (60_000, 4096, 64),
    (8192, 1024, 3), (8192, 100, 64)])
def test_select_sort_kernel_equals_plain_on_live_maps(k0, s_min, rounds,
                                                      dev):
    """S's list and partitions of kernel D's maps of the live pool, the
    whole list and the sort's state, bit-equal to the plain model; with
    the module's K0 and S_MIN the range that holds row K0 - 1 ends inside
    the head that comes back."""
    from klt_tpu_torch.ops import select_sort
    pool, cfg = live_pool(dev)
    for k in (0, 17, 40):
        resp = live_response(pool[k], cfg, dev)
        card, plain = card_and_plain_lists(resp, cfg, k0, s_min, rounds)
        assert_same_sort(card, plain)
        state = plain[1]
        if (k0, s_min) == (select_sort.K0, select_sort.S_MIN):
            n = card[0].shape[0]
            pend = state[3:3 + 2 * int(state[1])].view(-1, 2)
            held = pend[(pend[:, 0] < k0) & (pend[:, 1] > k0 - 1)]
            assert not len(held) or \
                int(held[0, 1]) <= select_sort.prefix_rows(n)


@pytest.mark.parametrize("kind", ["ties", "specials", "equal", "sorted"])
def test_select_sort_kernel_equals_plain_on_made_maps(kind, dev):
    """S on maps made to be hard: a few values and many ties, NaN, +-inf
    and values at and beyond +-2^31, all one value, a map in descending
    order; down to ranges of 64 rows."""
    rng = np.random.default_rng(len(kind))
    h, w = 480, 640
    if kind == "ties":
        m = rng.integers(0, 6, (h, w)).astype(np.float32) + 0.5
    elif kind == "specials":
        m = rng.normal(0.0, 1e4, (h, w)).astype(np.float32)
        pick = rng.random((h, w)) < 0.2
        m[pick] = rng.choice(np.float32(
            [np.nan, np.inf, -np.inf, 2147483648.0, -2147483648.0,
             2147483520.0, 4294967296.0, -0.5, 0.5]), int(pick.sum()))
    elif kind == "equal":
        m = np.full((h, w), 7.25, np.float32)
    else:
        m = np.arange(h * w, 0, -1, dtype=np.float32).reshape(h, w)
    cfg = kt.TrackingConfig()
    card, plain = card_and_plain_lists(torch.from_numpy(m).to(dev), cfg,
                                       4096, 64, 64)
    assert_same_sort(card, plain)


def test_replace_on_card_route_equals_host_chain_over_the_live_pool(
        dev, monkeypatch):
    """`replace_lost_features` on the card route gives the host chain's
    FeatureList, bit for bit, over 2,000 consecutive frames of the live
    pool from features all lost (the first replacement selects all 500 and
    reads past the head: a spill).  The host chain's tracker runs on the
    card too; its kernel D maps are handed over on the CPU."""
    from klt_tpu_torch.runtime import tracker as tracker_mod
    from klt_tpu_torch.utils import profiling
    pool, cfg = live_pool(dev)
    period = pool.shape[0] - 1
    on_host = [False]
    real = tracker_mod.corner_response
    monkeypatch.setattr(tracker_mod, "corner_response", lambda *a: (
        real(*a).cpu() if on_host[0] else real(*a)))
    card, host = (kt.KLTracker(cfg, device=dev) for _ in range(2))
    fl_card, fl_host = (kt.FeatureList.create(500) for _ in range(2))
    before = dict(profiling.counters())
    for i in range(2000):
        k = i % period
        for tr, fl in ((card, fl_card), (host, fl_host)):
            tr.track_features(pool[k], pool[k + 1], fl)
        np.testing.assert_array_equal(fl_card.val, fl_host.val)
        card.replace_lost_features(pool[k + 1], fl_card)
        on_host[0] = True
        host.replace_lost_features(pool[k + 1], fl_host)
        on_host[0] = False
        for a, b in ((fl_card.x, fl_host.x), (fl_card.y, fl_host.y),
                     (fl_card.val, fl_host.val)):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    after = profiling.counters()
    lists = after["select.card_lists"] - before.get("select.card_lists", 0)
    spills = after.get("select.card_spills", 0) - \
        before.get("select.card_spills", 0)
    assert lists >= 1000 and 1 <= spills <= lists // 100
    # the card's buffers are made by the first selection from a map there
    assert [b.card is not None for b in card._lists.values()] == [True]
    assert [b.card is not None for b in host._lists.values()] == [False]


def test_card_route_spill_forced_equals_no_spill(dev, monkeypatch):
    """The card route's internal entry with a head of 64 rows: the walk
    brings the rest back and selects what it selects from the whole head,
    and counts one spill."""
    from klt_tpu_torch.ops import select_sort
    from klt_tpu_torch.utils import profiling
    pool, cfg = live_pool(dev)
    tr = kt.KLTracker(cfg, device=dev)
    fl = kt.FeatureList.create(500)
    for k in range(6):
        tr.track_features(pool[k], pool[k + 1], fl)
        tr.replace_lost_features(pool[k + 1], fl)
    tr.track_features(pool[6], pool[7], fl)
    fl.val[::7] = -1
    resp = live_response(pool[7], cfg, dev)
    bufs = tr._list_buffers(pool[7].shape)
    out = []
    for rows in (None, 64):
        if rows is not None:
            monkeypatch.setattr(select_sort, "prefix_rows", lambda n: rows)
        got = fl.copy()
        spills = profiling.counters().get("select.card_spills", 0)
        lazy = tr._sort_on_card(resp, bufs, got, 640, 480, False)
        out.append((got, lazy.n_final,
                    profiling.counters().get("select.card_spills", 0) -
                    spills))
    (a, na, sa), (b, nb, sb) = out
    for u, v in ((a.x, b.x), (a.y, b.y), (a.val, b.val)):
        np.testing.assert_array_equal(u.view(np.int32), v.view(np.int32))
    assert na == nb and (sa, sb) == (0, 1)
