"""The port's pyramid (plain torch version of kernel A) held against
klt_tpu's Pallas kernel in interpret mode, its XLA path and the host
exact chain.  Kernel A itself is held against the plain version on a
card in test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
from klt_tpu_torch.interop import config_from_fields
from klt_tpu_torch.ops.pyramid import (build_pyramid_stacks,
                                       build_pyramid_stacks_plain)
from conftest import load_f32

MAP_TOL = 1e-3  # XLA:CPU reassociates conv chains at the ulp level


def fixture_frame() -> np.ndarray:
    img = load_f32("smoothed_img0.f32", (240, 320))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def crop_64x80() -> np.ndarray:
    return np.ascontiguousarray(fixture_frame()[80:144, 120:200])


def jax_stacks(img, cfg):
    from klt_tpu.ops.pyramid import build_pyramid_stacks as jbuild
    return [np.asarray(s) for s in
            jax.jit(lambda im: jbuild(im, cfg))(jnp.asarray(img))]


def assert_stacks_close(ours, ref, tol):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from klt_tpu.pallas import pyramid as pp
    monkeypatch.setenv("KLT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("KLT_TPU_NO_PALLAS", raising=False)
    pp._fused_call.cache_clear()
    yield
    pp._fused_call.cache_clear()


def test_plain_matches_pallas_kernel_interpret(interpret_pallas):
    jcfg = klt_tpu.TrackingConfig()
    img = crop_64x80()
    ref = jax_stacks(img, jcfg)
    ours = build_pyramid_stacks(torch.from_numpy(img),
                                config_from_fields(dataclasses.asdict(jcfg)))
    assert_stacks_close(ours, ref, MAP_TOL)


@pytest.mark.parametrize("frame", ["64x80", "240x320"])
@pytest.mark.parametrize("kw", [{}, {"search_range": 5},
                                {"search_range": 30, "window_width": 9}])
def test_plain_matches_xla_path(frame, kw, monkeypatch):
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg = klt_tpu.TrackingConfig(**kw)
    img = crop_64x80() if frame == "64x80" else fixture_frame()
    ref = jax_stacks(img, jcfg)
    ours = build_pyramid_stacks(torch.from_numpy(img),
                                config_from_fields(dataclasses.asdict(jcfg)))
    assert_stacks_close(ours, ref, MAP_TOL)


def test_plain_bit_equal_to_exact_chain():
    """Level 0 (pre-smoothing, gradients) and level 1 (pyramid smoothing
    and decimation) round exactly like the host exact chain: the plain
    convolution accumulates taps in the same sequential f32 order."""
    from klt_tpu.ops.exact_select import (smoothed_image_exact,
                                          gradients_exact)
    jcfg = klt_tpu.TrackingConfig()
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    img = fixture_frame()
    st = build_pyramid_stacks_plain(torch.from_numpy(img), cfg)
    sm = smoothed_image_exact(img.astype(np.float32), cfg.smooth_sigma)
    s, sh = cfg.subsampling, cfg.subsampling // 2
    lvl1 = smoothed_image_exact(sm, cfg.pyramid_sigma)[sh::s, sh::s]
    lvl1 = np.ascontiguousarray(lvl1[:240 // s, :320 // s])
    for stack, level in zip(st, (sm, lvl1)):
        gx, gy = gradients_exact(level, cfg.grad_sigma)
        for ours, ref in zip(stack, (level, gx, gy)):
            np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                          ref.view(np.uint32))


def test_float_input_equals_uint8_input():
    cfg = config_from_fields(dataclasses.asdict(klt_tpu.TrackingConfig()))
    img = crop_64x80()
    a = build_pyramid_stacks(torch.from_numpy(img), cfg)
    b = build_pyramid_stacks(torch.from_numpy(img.astype(np.float32)), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cuda_wrapper_refuses_cpu_tensors():
    from klt_tpu_torch.cuda.pyramid import build_pyramid_stacks_cuda
    cfg = config_from_fields(dataclasses.asdict(klt_tpu.TrackingConfig()))
    with pytest.raises(ValueError, match="CUDA tensor"):
        build_pyramid_stacks_cuda(torch.from_numpy(crop_64x80()), cfg)


def test_image_pyramids_are_the_stacks_split():
    from klt_tpu_torch.ops.pyramid import build_image_pyramids
    cfg = config_from_fields(dataclasses.asdict(klt_tpu.TrackingConfig()))
    img = torch.from_numpy(crop_64x80())
    stacks = build_pyramid_stacks(img, cfg)
    pyr, gx, gy = build_image_pyramids(img, cfg)
    for s, maps in zip(stacks, zip(pyr, gx, gy)):
        assert torch.equal(s, torch.stack(maps))
