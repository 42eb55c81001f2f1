"""Kernels A and B held against their plain torch versions on a CUDA card.

Every test here needs the card and skips without one.  The file imports
neither jax nor klt_tpu nor conftest, so on a machine with a card and no
jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Both kernels accumulate in the plain versions' f32 order and are built
with -fmad=false, so every comparison asks for bit equality.
"""

import os

import numpy as np
import pytest
import torch

import klt_tpu_torch as kt
from chip_smoke import synthetic_frames
from klt_tpu_torch.ops.lk import lk_level, lk_level_plain
from klt_tpu_torch.ops.pyramid import (build_pyramid_stacks,
                                       build_pyramid_stacks_plain)
from klt_tpu_torch.runtime.pipeline import track_sequence

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


def level_case(name, dev):
    """Level stacks of a frame pair and features for kernel B."""
    kw = {"lighting_insensitive": True} if name == "lighting" else {}
    if name == "max_iterations":
        kw = {"max_iterations": 2, "min_displacement": 1e-4}
    if name == "window_9x5":
        kw = {"window_width": 9, "window_height": 5}
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


@pytest.mark.parametrize("name", ["default", "lighting", "oob", "small_det",
                                  "max_iterations", "window_9x5"])
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
    launch per level and frame pair."""
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
    assert cuda.LK_LEVEL.launches == 4 * cfg.n_pyramid_levels
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
