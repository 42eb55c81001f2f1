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
from chip_smoke import noise_frames, pyramid_cases
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


# ------------------------------------------------------------------ #
# the tiled design of kernels A and E (csrc/pyramid.cu), in plain torch #
# ------------------------------------------------------------------ #

TILE_W = 32


def tile_height(nmaps, stride, rh, rv, out_rows, out_cols):
    """csrc/pyramid.cu::plan for one image: 32 output rows a tile if that
    takes at most 48 KB of shared memory (input rows of an odd pitch, then
    33 floats a row and map of the horizontal pass) and gives 264 blocks,
    else 8 rows if 227 KB hold them, else 0 (no tile: the global-memory
    passes)."""
    def nbytes(th):
        ih = stride * (th - 1) + 1 + 2 * rv
        pitch = (stride * (TILE_W - 1) + 1 + 2 * rh) | 1
        return 4 * ih * (pitch + nmaps * (TILE_W + 1))
    tiles_x = -(-out_cols // TILE_W)
    if nbytes(32) <= 48 * 1024 and tiles_x * -(-out_rows // 32) >= 264:
        return 32
    return 8 if nbytes(8) <= 227 * 1024 else 0


def chain(terms, taps):
    """acc = x[0] * t[w-1]; acc = acc + x[m] * t[w-1-m]: the order every
    output of the kernel and of the plain version accumulates in."""
    width = len(taps)
    t = [float(v) for v in np.asarray(taps, np.float32)]
    acc = terms(0) * t[width - 1]
    for m in range(1, width):
        acc = acc + terms(m) * t[width - 1 - m]
    return acc


def tile_program(img, maps, stride, offset, out_rows, out_cols):
    """One tile program as a block runs it: for every tile of TILE_W x th
    outputs, the input crop with its halo (pixels outside the image are
    zeros that feed only zeroed outputs), the horizontal pass at the
    columns the tile's outputs use, the vertical pass at their rows;
    zeroing by global coordinates.  maps: (horizontal taps, vertical taps)
    per output map.  Returns one [out_rows, out_cols] map per entry, or
    None when no tile holds the program."""
    rows, cols = img.shape
    rh = max(len(h) // 2 for h, _ in maps)
    rv = max(len(v) // 2 for _, v in maps)
    th = tile_height(len(maps), stride, rh, rv, out_rows, out_cols)
    if th == 0:
        return None
    ih = stride * (th - 1) + 1 + 2 * rv
    iw = stride * (TILE_W - 1) + 1 + 2 * rh
    outs = [torch.full((out_rows, out_cols), float("nan")) for _ in maps]
    zero = torch.zeros(())
    for i0 in range(0, out_rows, th):
        for j0 in range(0, out_cols, TILE_W):
            gy0 = offset + stride * i0 - rv
            gx0 = offset + stride * j0 - rh
            crop = torch.zeros((ih, iw))
            ys = slice(max(gy0, 0), min(gy0 + ih, rows))
            xs = slice(max(gx0, 0), min(gx0 + iw, cols))
            if ys.start < ys.stop and xs.start < xs.stop:
                crop[ys.start - gy0:ys.stop - gy0,
                     xs.start - gx0:xs.stop - gx0] = img[ys, xs]
            gx = offset + stride * (j0 + torch.arange(TILE_W))
            gy = offset + stride * (i0 + torch.arange(th))
            for out, (ht, vt) in zip(outs, maps):
                r = len(ht) // 2
                at = stride * torch.arange(TILE_W) + rh - r
                mid = chain(lambda m: crop[:, at + m], ht)
                mid = torch.where((gx >= r) & (gx < cols - r), mid, zero)
                r = len(vt) // 2
                at = stride * torch.arange(th) + rv - r
                res = chain(lambda m: mid[at + m], vt)
                res = torch.where(((gy >= r) & (gy < rows - r))[:, None],
                                  res, zero)
                n_i, n_j = min(th, out_rows - i0), min(TILE_W, out_cols - j0)
                out[i0:i0 + n_i, j0:j0 + n_j] = res[:n_i, :n_j]
    return outs


def build_pyramid_stacks_tiled(img, cfg):
    """The launch sequence of csrc/pyramid.cu: the pre-smoothing, then per
    level the gradient program and, below the coarsest level, the
    decimating program with H(pyramid gauss) at the kept columns only.
    Returns (stacks, the levels whose decimation fits no tile)."""
    from klt_tpu_torch.config import pyramid_shapes
    from klt_tpu_torch.kernels import gaussian_kernels
    from klt_tpu_torch.ops.convolve import convolve_separable
    g_s = gaussian_kernels(cfg.smooth_sigma)[0]
    gauss, deriv = gaussian_kernels(cfg.grad_sigma)
    g_p = gaussian_kernels(cfg.pyramid_sigma)[0]
    s, sh = cfg.subsampling, cfg.subsampling // 2
    shapes = pyramid_shapes(img.shape[1], img.shape[0], cfg)
    level, = tile_program(img.to(torch.float32), [(g_s, g_s)], 1, 0,
                          *img.shape)
    stacks, untiled = [], []
    for lvl, (cols, rows) in enumerate(shapes):
        gradx, grady = tile_program(level, [(deriv, gauss), (gauss, deriv)],
                                    1, 0, rows, cols)
        stacks.append(torch.stack([level, gradx, grady]))
        if lvl < len(shapes) - 1:
            ncols, nrows = shapes[lvl + 1]
            nxt = tile_program(level, [(g_p, g_p)], s, sh, nrows, ncols)
            if nxt is None:  # the kernel's global-memory passes
                untiled.append(lvl)
                nxt = [convolve_separable(level, g_p, g_p)
                       [sh::s, sh::s][:nrows, :ncols].contiguous()]
            level, = nxt
    return stacks, untiled


PYRAMID_CASES = pyramid_cases()


@pytest.mark.parametrize("case", range(len(PYRAMID_CASES)),
                         ids=[c[0] for c in PYRAMID_CASES])
def test_tiled_pyramid_bit_equal_to_plain(case):
    """Tile by tile with halos, H(pyramid gauss) at the kept columns only:
    the same bits as the plain version on the whole image, so the tiling
    and the decimated horizontal pass change no rounding and no zeroed
    border."""
    name, kw, hw = PYRAMID_CASES[case]
    cfg = config_from_fields(dataclasses.asdict(klt_tpu.TrackingConfig(**kw)))
    img = torch.from_numpy(noise_frames(1, hw, 21)[0])
    tiled, untiled = build_pyramid_stacks_tiled(img, cfg)
    plain = build_pyramid_stacks_plain(img, cfg)
    assert len(tiled) == len(plain) == cfg.n_pyramid_levels
    for a, b in zip(tiled, plain):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert a.abs().max() > 0 or min(a.shape[1:]) < 8
    assert untiled == ([0] if "no tile" in name else [])
