"""The bit-exact tier of the port (ops/lk_exact.py, ops/replace_exact.py)
held on the CPU against what pins the reference C tracker's bits: the C
goldens of tests/fixtures, the numpy C-order chain of
klt_tpu_torch/ops/exact_select.py and the scalar oracle
klt_tpu_torch/native/lk_exact_ref.c (kernel G's own lane program, built
with cc -O0 -ffp-contract=off); and against klt_tpu's exact replacement
for its picks and tie flags.  The tier's pyramid is kernel A's, whose
plain version already sums in the C order.  Kernels A, G, H2 and R's tie
entry are held against these plain versions on a card in
test_torch_cuda.py; the whole
replace run against klt_tpu in test_torch_exact_sequence.py.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import (exact_lk_cases, exact_replace_cases, replace_cases,
                        synthetic_frames, tie_frames)
from klt_tpu_torch import native
from klt_tpu_torch.kernels import gaussian_kernels
from klt_tpu_torch.interop import (config_from_fields,
                                   exact_pyramids_from_numpy,
                                   exact_pyramids_to_numpy)
from klt_tpu_torch.ops import exact_select as es
from klt_tpu_torch.ops.lk_exact import (build_pyramids_exact,
                                        exact_constants,
                                        track_features_exact)
from klt_tpu_torch.ops.pyramid import build_pyramid_stacks_plain
from klt_tpu_torch.ops.replace_exact import (_conv_h_exact, _conv_v_exact,
                                             exact_response_device,
                                             exact_response_from_grads,
                                             exact_response_plain,
                                             replace_lost_exact_,
                                             replace_lost_features_exact)
from klt_tpu_torch.ops.selection import _candidate_borders
from klt_tpu_torch.utils.parity import detection_epochs, table_parity_stats

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def golden(name, shape):
    return np.fromfile(os.path.join(FIXTURES, name), np.float32).reshape(
        shape)


def bits(a):
    """The f32 bit patterns, so that -0.0 and +0.0 differ."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def assert_bits_equal(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def numpy_chain(frame, cfg, n_levels, smooth=True):
    """The exact pyramid by the numpy C-order chain of exact_select."""
    level = np.asarray(frame, np.float32)
    if smooth:
        level = es.smoothed_image_exact(level, cfg.smooth_sigma)
    ss = cfg.subsampling
    out = []
    for lvl in range(n_levels):
        if lvl:
            r, c = level.shape[0] // ss, level.shape[1] // ss
            level = es.smoothed_image_exact(level, cfg.pyramid_sigma)[
                ss // 2::ss, ss // 2::ss][:r, :c]
        out.append((level, *es.gradients_exact(level, cfg.grad_sigma)))
    return out


def scene_u8():
    img = golden("smoothed_img0.f32", (240, 320))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ #
# the exact pyramid: kernel A's                                       #
# ------------------------------------------------------------------ #

def test_plain_exact_chain_equals_the_c_goldens():
    """From the C tracker's smoothed image (level 0 as given, so no
    smoothing): kernel A's plain version gives its gradients, pyramid
    level 1 and level 1's gradients, all bit for bit."""
    sm = golden("smoothed_img0.f32", (240, 320))
    cfg = kt.TrackingConfig()
    assert (cfg.n_pyramid_levels, cfg.subsampling) == (2, 4)
    st = build_pyramid_stacks_plain(torch.from_numpy(sm), cfg, smooth=False)
    assert_bits_equal(st[0][0], sm)
    assert_bits_equal(st[0][1], golden("gradx_img0.f32", (240, 320)))
    assert_bits_equal(st[0][2], golden("grady_img0.f32", (240, 320)))
    assert_bits_equal(st[1][0], golden("pyr1_img0.f32", (60, 80)))
    assert_bits_equal(st[1][1], golden("pyr1_gradx_img0.f32", (60, 80)))
    assert_bits_equal(st[1][2], golden("pyr1_grady_img0.f32", (60, 80)))


CHAIN_CASES = {
    "scene, default": (lambda: scene_u8(), {}),
    "scene, 3 levels of subsampling 2": (
        lambda: scene_u8(), {"n_pyramid_levels": 3, "subsampling": 2}),
    "seeded u8 61x47, 9x9 window": (
        lambda: np.random.RandomState(3).randint(0, 256, (47, 61), np.uint8),
        {"window_width": 9, "window_height": 9}),
    "seeded u8 120x160, 3 levels of subsampling 4": (
        lambda: np.random.RandomState(4).randint(0, 256, (120, 160),
                                                 np.uint8),
        {"n_pyramid_levels": 3, "subsampling": 4}),
    "a frame narrower than the pyramid taps": (
        lambda: np.random.RandomState(5).randint(0, 256, (40, 18), np.uint8),
        {}),
}


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_plain_exact_chain_equals_exact_select(name):
    make, kw = CHAIN_CASES[name]
    frame = make()
    cfg = kt.TrackingConfig(**kw)
    got = build_pyramids_exact(torch.from_numpy(frame), cfg)
    want = numpy_chain(frame, cfg, cfg.n_pyramid_levels)
    assert len(got) == len(want)
    for st, ref in zip(got, want):
        for plane, r in zip(st, ref):
            assert_bits_equal(plane, r)


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_kernel_a_plain_pyramid_is_the_exact_chain(name):
    """Kernel A's plain version without its pre-smoothing, at one level
    (the response of a frame that is not smoothed before selecting) and
    at every level, is the C-order chain from the frame itself, to the
    bit.  (klt_tpu's Pallas kernel A sums in another order, which is why
    klt_tpu has a separate exact pyramid; the port's does not.)"""
    make, kw = CHAIN_CASES[name]
    frame = make()
    cfg = kt.TrackingConfig(**kw)
    for n in (1, cfg.n_pyramid_levels):
        got = build_pyramid_stacks_plain(torch.from_numpy(frame), cfg, n,
                                         smooth=False)
        want = numpy_chain(frame, cfg, n, smooth=False)
        assert len(got) == len(want) == n
        for st, ref in zip(got, want):
            for plane, r in zip(st, ref):
                assert_bits_equal(plane, r)


def test_conv_chain_of_a_map_narrower_than_the_taps_is_zero():
    taps = np.full(7, 1.0 / 7, np.float32)
    img = torch.rand(10, 6)
    assert torch.equal(_conv_h_exact(img, taps), torch.zeros(10, 6))
    assert torch.equal(_conv_v_exact(img.T.contiguous(), taps),
                       torch.zeros(6, 10))


def test_conv_chain_keeps_the_sign_of_a_zero_sum():
    """A known gap of the reference, decided as klt_tpu does
    (klt_tpu/ops/replace_exact.py:67): the chain is seeded with its first
    term, so a sum of -0.0 terms stays -0.0; C starts from 0.0f and gives
    +0.0 there.  Only a float frame holding -0.0 can show it (a u8 frame
    has no negative zero), and no int cast or comparison sees the sign."""
    g, _ = gaussian_kernels(0.7)
    img = torch.full((9, 9), -0.0)
    out = _conv_h_exact(img, g)
    r = len(g) // 2
    inner = out[:, r:9 - r]
    assert (inner == 0).all() and torch.signbit(inner).all()
    assert not torch.signbit(out[:, :r]).any()  # the zeroed border: +0.0
    # what C would give: 0.0f + (-0.0) + ... = +0.0
    c_sum = np.float32(0.0)
    for t in g:
        c_sum = c_sum + np.float32(-0.0) * t
    assert not np.signbit(c_sum)
    assert_bits_equal(out, es.convolve_horiz_exact(img.numpy(), g))


def test_exact_pyramids_round_trip_through_klt_tpus_tuples():
    cfg = kt.TrackingConfig()
    st = build_pyramids_exact(torch.from_numpy(scene_u8()), cfg)
    imgs, gxs, gys = exact_pyramids_to_numpy(st)
    assert len(imgs) == 2 and imgs[1].shape == (60, 80)
    back = exact_pyramids_from_numpy((imgs, gxs, gys))
    for a, b in zip(back, st):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ #
# H2: the exact response                                               #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("window", [(7, 7), (9, 9), (5, 9)])
def test_exact_response_equals_corner_response_exact(window):
    gx = golden("gradx_img0.f32", (240, 320))
    gy = golden("grady_img0.f32", (240, 320))
    got = exact_response_plain(torch.from_numpy(gx), torch.from_numpy(gy),
                               *window)
    assert_bits_equal(got, es.corner_response_exact(gx, gy, *window))
    cfg = kt.TrackingConfig(window_width=window[0], window_height=window[1])
    assert_bits_equal(exact_response_from_grads(
        torch.from_numpy(gx), torch.from_numpy(gy), cfg), got)


@pytest.mark.parametrize("smooth", [True, False])
def test_exact_response_of_a_frame_equals_the_selection_chain(smooth):
    """exact_response_device honours smooth_before_selecting, as klt_tpu
    does; it equals the host selection chain either way."""
    frame = scene_u8()
    cfg = kt.TrackingConfig(smooth_before_selecting=smooth)
    got = exact_response_device(torch.from_numpy(frame), cfg)
    assert_bits_equal(got, es.selection_response_exact(frame, cfg))


def test_replacement_response_honours_smooth_before_selecting():
    """A known gap of the reference, decided as klt_tpu does
    (klt_tpu/ops/replace_exact.py:134): the response of a frame for its
    host repair is smoothed only when smooth_before_selecting is set.  C's
    KLTReplaceLostFeatures in sequential mode always takes the smoothed
    pyramid's level-0 gradients, which is what the exact run's in-loop
    replacement takes; with the option off the two differ."""
    frame = torch.from_numpy(scene_u8())
    off = kt.TrackingConfig(smooth_before_selecting=False)
    pyr = build_pyramids_exact(frame, off)
    c_like = exact_response_from_grads(pyr[0][1], pyr[0][2], off)
    ours = exact_response_device(frame, off)
    assert not torch.equal(ours, c_like)
    on = kt.TrackingConfig()
    assert torch.equal(exact_response_device(frame, on), c_like)


def test_exact_response_of_a_map_smaller_than_the_window():
    gx = torch.rand(5, 30)
    out = exact_response_plain(gx, gx, 7, 7)
    assert (out == np.float32(-3e38)).all()


# ------------------------------------------------------------------ #
# G: the exact LK walk against the scalar oracle                       #
# ------------------------------------------------------------------ #

def oracle(p1, p2, x, y, val, cfg):
    return native.track_exact_ref(
        [s.numpy() for s in p1], [s.numpy() for s in p2], x, y, val,
        exact_constants(cfg, *p1[0].shape[-2:]))


def assert_lanes_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g) if g.dtype == torch.float32
                                      else g.numpy(),
                                      bits(w) if w.dtype == np.float32
                                      else w)


LK_CASES = exact_lk_cases()


@pytest.mark.parametrize("case", range(len(LK_CASES)),
                         ids=[c[0] for c in LK_CASES])
def test_plain_lk_exact_equals_the_scalar_oracle_on_made_lanes(case):
    name, kw, f1, f2, x, y, val = LK_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    p1 = build_pyramids_exact(torch.from_numpy(f1), cfg)
    p2 = build_pyramids_exact(torch.from_numpy(f2), cfg)
    got = track_features_exact(p1, p2, *(torch.from_numpy(a)
                                         for a in (x, y, val)), cfg)
    want = oracle(p1, p2, x, y, val, cfg)
    assert_lanes_equal(got, want)
    v = want[2]
    assert (v[:2] == kt.OOB).all() and (v[2:4] == kt.SMALL_DET).all()
    assert (v[10:12] == val[10:12]).all()  # lost slots untouched
    if name.startswith("default"):
        assert (v[7:10] == kt.LARGE_RESIDUE).any()
    if name.startswith("3 iterations"):
        assert (v == kt.MAX_ITERATIONS).sum() >= 3


@pytest.mark.parametrize("case", [0, 2], ids=[LK_CASES[0][0], LK_CASES[2][0]])
def test_plain_lk_exact_matches_klt_tpu_on_the_same_pyramids(case):
    """The port's exact stacks handed to klt_tpu's track_features_exact as
    its (imgs, gxs, gys) tuples: equal statuses, positions within 1e-4 px
    (klt_tpu on XLA:CPU does not keep the C order to the bit)."""
    from klt_tpu.ops.lk_exact import track_features_exact as tj
    name, kw, f1, f2, x, y, val = LK_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    p1 = build_pyramids_exact(torch.from_numpy(f1), cfg)
    p2 = build_pyramids_exact(torch.from_numpy(f2), cfg)
    got = track_features_exact(p1, p2, *(torch.from_numpy(a)
                                         for a in (x, y, val)), cfg)
    jcfg = klt_tpu.TrackingConfig(**kw)
    j1, j2 = (jax_tree(exact_pyramids_to_numpy(p)) for p in (p1, p2))
    jx, jy, jv = (np.asarray(a) for a in tj(j1, j2, jnp.asarray(x),
                                            jnp.asarray(y), jnp.asarray(val),
                                            jcfg))
    np.testing.assert_array_equal(got[2].numpy(), jv)
    np.testing.assert_allclose(got[0].numpy(), jx, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), jy, atol=1e-4, rtol=0)
    back = exact_pyramids_from_numpy(exact_pyramids_to_numpy(p1))
    assert all(torch.equal(a, b) for a, b in zip(back, p1))


def jax_tree(pyr):
    return tuple(tuple(jnp.asarray(a) for a in part) for part in pyr)


def test_small_det_inside_the_border_band_stays_small_det():
    """A known gap of the reference, decided as klt_tpu does
    (klt_tpu/ops/lk_exact.py:382): a lane killed SMALL_DET inside the
    border band keeps SMALL_DET; C tests out-of-bounds first and records
    OOB (trackFeatures.c:1394-1408)."""
    name, kw, f1, f2, x, y, val = LK_CASES[0]
    cfg = kt.TrackingConfig(**kw)
    assert (x[5:7] < cfg.borderx).all()  # inside the left border band
    p1 = build_pyramids_exact(torch.from_numpy(f1), cfg)
    p2 = build_pyramids_exact(torch.from_numpy(f2), cfg)
    _, _, v = track_features_exact(p1, p2, *(torch.from_numpy(a)
                                             for a in (x, y, val)), cfg)
    assert (v[5:7] == kt.SMALL_DET).all()  # C: OOB
    assert (oracle(p1, p2, x, y, val, cfg)[2][5:7] == kt.SMALL_DET).all()


def seeded_pair(kw, seed):
    """Two 120x160 crops of the scene along the synthetic path, with
    features selected on the first."""
    fr = synthetic_frames(1 + seed % 5 + 1)[:, 50:170, 70:230]
    cfg = kt.TrackingConfig(sequential_mode=True, **kw)
    fl = kt.FeatureList.create(80)
    kt.KLTracker(cfg, device="cpu").select_good_features(fr[0], fl)
    rng = np.random.RandomState(seed)
    x = fl.x + rng.uniform(-1.5, 1.5, 80).astype(np.float32)
    y = fl.y + rng.uniform(-1.5, 1.5, 80).astype(np.float32)
    return fr[0], fr[-1], x, y, fl.val, cfg


@pytest.mark.parametrize("levels,ss", [(2, 4), (3, 2)])
@pytest.mark.parametrize("win", [5, 7, 9])
def test_plain_lk_exact_equals_the_scalar_oracle_on_frame_pairs(levels, ss,
                                                                 win):
    kt.set_verbosity(0)
    f1, f2, x, y, val, cfg = seeded_pair(
        {"window_width": win, "window_height": win,
         "n_pyramid_levels": levels, "subsampling": ss}, seed=win + levels)
    p1 = build_pyramids_exact(torch.from_numpy(f1), cfg)
    p2 = build_pyramids_exact(torch.from_numpy(f2), cfg)
    got = track_features_exact(p1, p2, *(torch.from_numpy(a)
                                         for a in (x, y, val)), cfg)
    want = oracle(p1, p2, x, y, val, cfg)
    assert_lanes_equal(got, want)
    assert (want[2] == kt.TRACKED).sum() >= 20


@pytest.mark.parametrize("kw,match", [
    ({"window_width": 7, "window_height": 9}, "square"),
    ({"lighting_insensitive": True}, "lighting")])
def test_exact_tier_limits_raise(kw, match):
    cfg = kt.TrackingConfig(**kw)
    frame = torch.from_numpy(scene_u8()[:60, :80])
    p = build_pyramids_exact(frame, cfg)
    x = torch.tensor([30.0])
    with pytest.raises(ValueError, match=match):
        track_features_exact(p, p, x, x, torch.zeros(1, dtype=torch.int32),
                             cfg)
    with pytest.raises(ValueError, match=match):
        kt.track_sequence_replace_exact(
            torch.from_numpy(np.stack([scene_u8()[:60, :80]] * 2)), x, x,
            torch.zeros(1, dtype=torch.int32), cfg)


# ------------------------------------------------------------------ #
# R's tie entry: the pick loop with its tie flag                       #
# ------------------------------------------------------------------ #

def jax_replace(frame, x, y, val, cfg):
    from klt_tpu.ops.replace_exact import replace_lost_features_exact as rj
    jcfg = klt_tpu.TrackingConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    out = rj(jnp.asarray(frame), jnp.asarray(x), jnp.asarray(y),
             jnp.asarray(val), jcfg)
    return [np.asarray(a) for a in out]


def replace_states():
    """(name, frame, x, y, val, cfg) with lost slots: tracked states of a
    120x160 crop, and one whose frame holds a block copied to two places."""
    kt.set_verbosity(0)
    fr = tie_frames(synthetic_frames(6)[:, 40:160, 60:220], 5)
    cfg = kt.TrackingConfig(sequential_mode=True)
    out = []
    for name, t in (("one frame tracked", 1),
                    ("a block copied to two places", 5)):
        fl = kt.FeatureList.create(50)
        tr = kt.KLTracker(cfg, device="cpu")
        tr.select_good_features(fr[0], fl)
        for i in range(1, t + 1):
            tr.track_features(fr[i - 1], fr[i], fl)
        assert (fl.val < 0).sum() >= 5
        out.append((name, fr[t], fl.x, fl.y, fl.val, cfg))
    return out


def test_replace_exact_plain_equals_klt_tpu():
    """Picks, NOT_FOUND slots and the tie flag equal klt_tpu's; the
    picks' values are the integer of the numpy chain's response to the
    bit (klt_tpu on XLA:CPU may be one off there: it does not keep the C
    order in its fused conv chains)."""
    ties = []
    for name, frame, x, y, val, cfg in replace_states():
        got = replace_lost_features_exact(
            torch.from_numpy(frame), *(torch.from_numpy(a)
                                       for a in (x, y, val)), cfg)
        jx, jy, jv, jtie = jax_replace(frame, x, y, val, cfg)
        np.testing.assert_array_equal(got[0].numpy(), jx)
        np.testing.assert_array_equal(got[1].numpy(), jy)
        np.testing.assert_array_equal(got[2].numpy() > 0, jv > 0)
        np.testing.assert_array_equal(got[2].numpy()[jv <= 0], jv[jv <= 0])
        assert bool(got[3]) == bool(jtie), name
        resp = es.selection_response_exact(frame, cfg)
        new = (val < 0) & (got[2].numpy() > 0)
        assert new.sum() >= 3
        xi, yi = got[0].numpy()[new].astype(int), got[1].numpy()[new].astype(
            int)
        np.testing.assert_array_equal(got[2].numpy()[new],
                                      resp[yi, xi].astype(np.int32))
        ties.append(bool(got[3]))
    assert ties == [False, True]


def tiled_replace_tie_model(resp, x, y, val, cfg, tile):
    """Kernel R's tie entry (csrc/replace.cu, klt_replace_lost_tie) written
    out in numpy on tiles of `tile` x `tile` cells; x, y, val are updated
    in place and the tie flag returned.  A tile's best carries how many of
    its cells hold the best's value (saturated at 2); the pick is the best
    of the tiles' bests, its count the sum of the counts of the tiles that
    hold that value; the square is killed and every live tile it meets is
    scanned again."""
    h, w = resp.shape
    borderx, bordery, step = _candidate_borders(cfg)
    floor = max(1, int(cfg.min_eigenvalue))
    stamp = max(int(cfg.mindist) - 1, 0)
    n = len(val)
    if not (val < 0).any():
        return False
    cx, cy = np.trunc(x).astype(np.int64), np.trunc(y).astype(np.int64)
    live = (val >= 0) & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    yy, xx = np.mgrid[0:h, 0:w]
    ok = ((yy >= bordery) & (yy < h - bordery) & (xx >= borderx) &
          (xx < w - borderx) & ((yy - bordery) % step == 0) &
          ((xx - borderx) % step == 0))
    trunc = np.trunc(np.where(resp > 0, resp, 0)).astype(np.int64)
    killed = np.zeros((h, w), bool)
    for f in np.flatnonzero(live):
        killed |= (np.abs(xx - cx[f]) <= stamp) & (np.abs(yy - cy[f]) <= stamp)
    m = np.where(ok & ~killed & (trunc >= floor), trunc, -1)
    flat = yy * w + xx
    best = {}

    def scan(ty, tx):
        sl = (slice(ty * tile, (ty + 1) * tile),
              slice(tx * tile, (tx + 1) * tile))
        v = m[sl].max()
        best[ty, tx] = (int(v), int(flat[sl][m[sl] == v].min()),
                        min(int((m[sl] == v).sum()), 2))

    for ty in range(-(-h // tile)):
        for tx in range(-(-w // tile)):
            scan(ty, tx)
    slot, tie = 0, False
    while True:
        while slot < n and val[slot] >= 0:
            slot += 1
        bv, bi, _ = max(best.values(), key=lambda b: (b[0], -b[1]))
        if slot >= n or bv < floor:
            break
        count = sum(c for v, _, c in best.values() if v == bv)
        tie = tie or count > 1
        py, px = divmod(bi, w)
        x[slot], y[slot], val[slot] = px, py, bv
        x0, x1 = max(px - stamp, 0), min(px + stamp, w - 1)
        y0, y1 = max(py - stamp, 0), min(py + stamp, h - 1)
        m[y0:y1 + 1, x0:x1 + 1] = -1
        for ty in range(y0 // tile, y1 // tile + 1):
            for tx in range(x0 // tile, x1 // tile + 1):
                if best[ty, tx][0] >= 0:
                    scan(ty, tx)
    lost = val < 0
    x[lost] = y[lost] = -1.0
    val[lost] = kt.NOT_FOUND
    return tie


TIE_CASES = replace_cases() + exact_replace_cases()


@pytest.mark.parametrize("tile", [7, 16, 32])
@pytest.mark.parametrize("case", range(len(TIE_CASES)),
                         ids=[c[0] for c in TIE_CASES])
def test_tiled_tie_model_equals_the_plain_loop(case, tile):
    """The tie entry's counts give the plain loop's flag, never more,
    whatever the tile size: a tile whose best survives a stamp that kills
    a cell of equal value is counted again."""
    name, kw, resp, x, y, val = TIE_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    mx, my, mval = x.copy(), y.copy(), val.copy()
    mtie = tiled_replace_tie_model(resp, mx, my, mval, cfg, tile)
    state = [torch.from_numpy(a.copy()) for a in (x, y, val)]
    tie = torch.full((1,), 7, dtype=torch.int32)
    replace_lost_exact_(torch.from_numpy(resp), *state, cfg, tie)
    np.testing.assert_array_equal(mval, state[2].numpy())
    np.testing.assert_array_equal(mx, state[0].numpy())
    np.testing.assert_array_equal(my, state[1].numpy())
    assert int(tie) == int(mtie)
    want = {"unique maxima": 0, "a stamp kills one of two equal cells": 0,
            "two equal cells that no stamp reaches": 1,
            "a block copied to two places": 1, "no slot lost": 0,
            "no slot at all": 0}
    if name in want:
        assert int(tie) == want[name]


# ------------------------------------------------------------------ #
# utils/parity                                                         #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_stats_equal_klt_tpus(seed):
    from klt_tpu.utils import parity as jparity
    rng = np.random.RandomState(seed)
    n, t = 30, 12
    v_o = rng.choice([0, 0, 0, 5, 9, -1, -4], (n, t)).astype(np.int32)
    x_o = rng.uniform(0, 100, (n, t)).astype(np.float32)
    y_o = rng.uniform(0, 100, (n, t)).astype(np.float32)
    v_r, x_r, y_r = v_o.copy(), x_o.copy(), y_o.copy()
    flip = rng.rand(n, t) < 0.1
    v_r[flip] = -v_r[flip] - 1
    x_r = x_r + rng.normal(0, 0.3, (n, t)).astype(np.float32)
    assert np.array_equal(detection_epochs(v_o),
                          jparity.detection_epochs(v_o))
    for horizon in (None, 7):
        assert table_parity_stats(x_r, y_r, v_r, x_o, y_o, v_o, horizon) == \
            jparity.table_parity_stats(x_r, y_r, v_r, x_o, y_o, v_o, horizon)


def test_config_from_klt_tpu_runs_the_exact_tier():
    """A klt_tpu configuration carried across drives the port's exact
    tier (the sequence tests build theirs so)."""
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    frame = torch.from_numpy(scene_u8()[:80, :100])
    st = build_pyramids_exact(frame, cfg)
    assert [tuple(s.shape) for s in st] == [(3, 80, 100), (3, 20, 25)]
