"""The port's affine consistency check (utils/linalg, ops/affine,
track_sequence_affine, KLTracker) held against klt_tpu on the CPU, and the
plain version of kernel F against a lane-by-lane model of the kernel's
control flow.  Kernel F itself is held against the plain version on a card
in test_torch_cuda.py.

Tolerances against klt_tpu: statuses and `valid` masks exact; positions
within POS_TOL (they are the translation tracker's); the maps within
MAP_TOL: klt_tpu sums the normal equations with XLA's einsum and samples
its resident patches row by row, the port sums in the kernel's warp order
and blends four terms, so Gauss-Newton paths differ in the last bits of
every iteration.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import affine_cases, affine_frames, in_affine_region
from klt_tpu_torch.interop import (affine_state_from_numpy,
                                   affine_state_to_numpy, config_from_fields,
                                   features_from_numpy, stacks_from_numpy)
from klt_tpu_torch.ops.affine import (AffineState, affine_consistency_step,
                                      patch_shape, save_patches_plain,
                                      track_affine, track_affine_plain,
                                      window_offsets, _sample_patches)
from klt_tpu_torch.ops.interp import sample_stack_at
from klt_tpu_torch.ops.lk import _window_sum
from klt_tpu_torch.runtime.pipeline import (track_sequence,
                                            track_sequence_affine,
                                            track_sequence_stream)
from klt_tpu_torch.utils.linalg import gj_solve_spd, inv3

POS_TOL = 3.1e-5   # px, as the translation path holds
MAP_TOL = 1e-4     # entries of the 2x2 maps
SOLVE_TOL = 2e-5   # relative, solutions of well-conditioned systems
N_FEAT = 40

kt.set_verbosity(0)
klt_tpu.set_verbosity(0)


@functools.lru_cache(maxsize=None)
def frames() -> np.ndarray:
    """7 frames of 96x112 around the deforming region, which covers a
    quarter of the crop; rate 0.12 kills features there within 5 frames."""
    return np.ascontiguousarray(
        affine_frames(7, rate=0.12)[:, 72:168, 104:216])


def configs(mode, **kw):
    jcfg = klt_tpu.TrackingConfig(sequential_mode=True,
                                  affine_consistency_check=mode,
                                  n_pyramid_levels=2, subsampling=2, **kw)
    return jcfg, config_from_fields(dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def start_features():
    cfg = configs(2)[1]
    fl = kt.FeatureList.create(N_FEAT)
    kt.KLTracker(cfg, device="cpu").select_good_features(frames()[0], fl)
    return fl


# ------------------------------------------------------------------ #
# utils/linalg                                                         #
# ------------------------------------------------------------------ #

def spd_systems(n, seed, batch=64):
    rng = np.random.RandomState(seed)
    m = rng.standard_normal((batch, n, n + 3)).astype(np.float32)
    T = m @ m.transpose(0, 2, 1) + 0.5 * np.eye(n, dtype=np.float32)
    return T.astype(np.float32), rng.standard_normal(
        (batch, n, 2)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_gj_solve_spd_matches_klt_tpu(n):
    from klt_tpu.utils.linalg import gj_solve_spd as jsolve
    T, B = spd_systems(n, seed=n)
    X, small = gj_solve_spd(torch.from_numpy(T), torch.from_numpy(B))
    jX, jsmall = jsolve(jnp.asarray(T), jnp.asarray(B))
    assert not small.any() and not np.asarray(jsmall).any()
    scale = np.abs(np.asarray(jX)).max()
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0,
                               atol=SOLVE_TOL * scale)
    np.testing.assert_allclose(T @ X.numpy(), B, rtol=0, atol=1e-3)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_gj_solve_spd_zero_pivot_matches_klt_tpu(n):
    """A pivot that is exactly 0 (a zero row and column: a flat window)
    is reported as small, the pivot taken as 1, in both packages."""
    from klt_tpu.utils.linalg import gj_solve_spd as jsolve
    T, B = spd_systems(n, seed=10 + n, batch=8)
    T[::2, n - 1, :] = 0.0
    T[::2, :, n - 1] = 0.0
    T[1, :, :] = 0.0
    X, small = gj_solve_spd(torch.from_numpy(T), torch.from_numpy(B))
    jX, jsmall = jsolve(jnp.asarray(T), jnp.asarray(B))
    np.testing.assert_array_equal(small.numpy(), np.asarray(jsmall))
    assert small.numpy().tolist() == [True, True] + [True, False] * 3
    scale = np.abs(np.asarray(jX)).max()
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0,
                               atol=SOLVE_TOL * scale)


def test_inv3_matches_klt_tpu():
    from klt_tpu.utils.linalg import inv3 as jinv3
    rng = np.random.RandomState(3)
    M = (rng.standard_normal((32, 3, 3)) +
         3.0 * np.eye(3)).astype(np.float32)
    M[0] = 0.0   # det 0: the eps floor
    for eps in (0.0, 1e-3):
        ours = inv3(torch.from_numpy(M[1:] if eps == 0 else M), eps).numpy()
        ref = np.asarray(jinv3(jnp.asarray(M[1:] if eps == 0 else M), eps))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours[1:] @ M[1:],
                               np.broadcast_to(np.eye(3), (31, 3, 3)),
                               atol=1e-4)


# ------------------------------------------------------------------ #
# the plain version of kernel F against a model of the kernel          #
# ------------------------------------------------------------------ #

def f32(v):
    return np.float32(v)


def kernel_lane_model(patches, stack2, x1, y1, x2_in, y2_in, a_in, cfg):
    """One active lane as csrc/affine.cu runs it: scalar control flow with
    `break`s where the plain version masks, the elimination restricted to
    the entries right of the pivot column, the residue only for a lane
    still TRACKED.  Tensor arguments are one lane's ([3, 1, ph, pw]
    patches, [1] lanes); arithmetic is f32 (torch scalars and numpy f32).
    Returns (x2, y2, axx, ayx, axy, ayy, status, iters)."""
    mode = cfg.affine_consistency_check
    aw, ah = cfg.affine_window_width, cfg.affine_window_height
    hw, hh = f32(aw // 2), f32(ah // 2)
    ph, pw = patches.shape[-2:]
    nr, nc = stack2.shape[-2:]
    ncf, nrf, pcf, prf = f32(nc), f32(nr), f32(pw), f32(ph)
    eps = f32(1.001)
    dxo, dyo = window_offsets(aw, ah, "cpu")
    g1, gx1, gy1 = (t[0] for t in _sample_patches(
        patches, x1[:, None] + dxo, y1[:, None] + dyo))
    x1, y1 = f32(x1.item()), f32(y1.item())
    x2, y2 = f32(x2_in.item()), f32(y2_in.item())
    x2_0, y2_0 = x2, y2
    axx, ayx, axy, ayy = (f32(a.item()) for a in a_in)
    wsum = lambda t: f32(_window_sum(t).item())
    coord_oob = lambda c, n: c < 0 or n - c < eps
    win_oob = lambda x, y: (x - hw < 0 or ncf - (x + hw) < eps or
                            y - hh < 0 or nrf - (y + hh) < eps)

    def corners():
        return [axx * -hw + axy * hh + x2, ayx * -hw + ayy * hh + y2,
                axx * -hw + axy * -hh + x2, ayx * -hw + ayy * -hh + y2,
                axx * hw + axy * hh + x2, ayx * hw + ayy * hh + y2,
                axx * hw + axy * -hh + x2, ayx * hw + ayy * -hh + y2]

    def warp():
        t = lambda v: torch.tensor(v)
        if mode == 0:
            return t(x2) + dxo, t(y2) + dyo
        return (t(x2) + (t(axx) * dxo + t(axy) * dyo),
                t(y2) + (t(ayx) * dxo + t(ayy) * dyo))

    src_oob = (coord_oob(x1 - hw, pcf) or pcf - (x1 + hw) < eps or
               coord_oob(y1 - hh, prf) or prf - (y1 + hh) < eps)
    status, iters = kt.TRACKED, 0
    for _ in range(cfg.affine_max_iterations):
        if mode == 0:
            oob = src_oob or win_oob(x2, y2)
        else:
            old = corners()
            oob = src_oob or any(coord_oob(old[k], ncf) or
                                 coord_oob(old[k + 1], nrf)
                                 for k in range(0, 8, 2))
        if oob:
            status = kt.OOB
            break
        iters += 1
        g2, gx, gy = sample_stack_at(stack2, *warp())
        diff = g1 - g2
        if mode == 0:
            sx, sy = gx1 + gx, gy1 + gy
            gxx, gxy, gyy = wsum(sx * sx), wsum(sx * sy), wsum(sy * sy)
            ex = wsum(diff * sx) * f32(cfg.step_factor)
            ey = wsum(diff * sy) * f32(cfg.step_factor)
            det = gxx * gyy - gxy * gxy
            if det < f32(cfg.min_determinant):
                status = kt.SMALL_DET
                break
            dx = (gyy * ex - gxy * ey) / det
            dy = (gxx * ey - gxy * ex) / det
        else:
            d = ([dxo * gx + dyo * gy, dxo * gy - dyo * gx, gx, gy]
                 if mode == 1 else
                 [dxo * gx, dxo * gy, dyo * gx, dyo * gy, gx, gy])
            n = len(d)
            A = np.zeros((n, n + 1), np.float32)
            for p in range(n):
                for q in range(p, n):
                    A[p, q] = A[q, p] = wsum(d[p] * d[q])
                A[p, n] = wsum(d[p] * diff) * f32(0.5)
            small = False
            with np.errstate(all="ignore"):
                for col in range(n):
                    piv = A[col, col]
                    small = small or piv == 0
                    arow = A[col, col + 1:] / (f32(1) if piv == 0 else piv)
                    for r in range(n):
                        if r != col:
                            A[r, col + 1:] = A[r, col + 1:] - \
                                A[r, col] * arow
                    A[col, col + 1:] = arow
            if small:
                status = kt.SMALL_DET
                break
            a = A[:, n]
            axx, ayx = axx + a[0], ayx + a[1]
            if mode == 1:
                ayy, axy = axx, -ayx
            else:
                axy, ayy = axy + a[2], ayy + a[3]
            dx, dy = a[n - 2], a[n - 1]
        x2, y2 = x2 + dx, y2 + dy
        conv = abs(dx) < f32(cfg.min_displacement) and \
            abs(dy) < f32(cfg.min_displacement)
        if mode != 0:
            conv = conv and all(
                abs(o - c) < f32(cfg.affine_min_displacement)
                for o, c in zip(old, corners()))
        if conv:
            break
    mdd = f32(cfg.affine_max_displacement_differ)
    if win_oob(x2, y2) or x2 - x2_0 > mdd or y2 - y2_0 > mdd:
        status = kt.OOB
    if status == kt.TRACKED:
        g2 = sample_stack_at(stack2[:1], *warp())[0]
        if wsum((g1 - g2).abs()) / f32(aw * ah) > \
                f32(cfg.affine_max_residue):
            status = kt.LARGE_RESIDUE
    return x2, y2, axx, ayx, axy, ayy, status, iters


AFFINE_CASES = affine_cases()


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", range(len(AFFINE_CASES)),
                         ids=[c[0] for c in AFFINE_CASES])
def test_plain_affine_equals_the_kernels_control_flow(case, mode):
    """The masked torch loop over all lanes gives, lane by lane, the bits
    of the kernel's scalar control flow (breaks, partial elimination, the
    residue skipped for dead lanes), on the made states the card is asked:
    flat patches (a zero pivot), corners that leave the image, foreign
    patches, inactive lanes, three window sizes."""
    name, kw, patches, stack2, x1, y1, x2, y2, maps, active = \
        AFFINE_CASES[case]
    cfg = kt.TrackingConfig(affine_consistency_check=mode, **kw)
    t = torch.from_numpy
    args = (t(patches), t(stack2), t(x1), t(y1), t(x2), t(y2),
            tuple(t(m) for m in maps), t(active))
    gx2, gy2, ga, gst, git = track_affine_plain(*args, cfg)
    out4 = track_affine(*args, cfg)
    assert torch.equal(out4[0], gx2) and torch.equal(out4[3], gst)
    got = [gx2, gy2, *ga, gst, git]
    for i in range(len(x1)):
        if not active[i]:
            want = [x2[i], y2[i], *[m[i] for m in maps], kt.TRACKED, 0]
        else:
            want = kernel_lane_model(
                t(patches[:, i:i + 1]), t(stack2), t(x1[i:i + 1]),
                t(y1[i:i + 1]), t(x2[i:i + 1]), t(y2[i:i + 1]),
                [t(m[i:i + 1]) for m in maps], cfg)
        for g, w in zip(got, want):
            g = g[i].numpy()
            assert g.tobytes() == np.asarray(w, g.dtype).tobytes(), \
                (name, mode, i, got[6][i].item(), want[6])
    if active.any():
        statuses = set(gst[t(active)].tolist())
        assert {kt.TRACKED, kt.SMALL_DET, kt.OOB} <= statuses
        assert (gst[:4] == kt.SMALL_DET).all()   # the flat patches
    else:
        assert (gst == kt.TRACKED).all() and (git == 0).all()


def test_save_patches_plain_copies_clamped_windows():
    """Integer-aligned copies centred on the truncated position, the start
    clamped into the image; lanes outside the mask keep their patch."""
    rng = np.random.RandomState(2)
    stack = torch.from_numpy(rng.rand(3, 40, 50).astype(np.float32))
    cfg = kt.TrackingConfig(affine_consistency_check=2)
    ph, pw = patch_shape(cfg)
    x = torch.tensor([25.7, 1.2, 48.9, 20.0, -1.0])
    y = torch.tensor([20.3, 38.5, 0.4, 9.99, -1.0])
    mask = torch.tensor([True, True, True, False, True])
    old = torch.from_numpy(rng.rand(3, 5, ph, pw).astype(np.float32))
    new = save_patches_plain(old, stack, x, y, mask)
    starts = [(17, 12), (0, 23), (33, 0), None, (0, 0)]
    for i, start in enumerate(starts):
        if start is None:
            want = old[:, i]
        else:
            x0, y0 = start
            want = stack[:, y0:y0 + ph, x0:x0 + pw]
        assert torch.equal(new[:, i], want)


# ------------------------------------------------------------------ #
# against klt_tpu                                                      #
# ------------------------------------------------------------------ #

def assert_same_tracks(ours, ref):
    xs, ys, vs = (np.asarray(a) for a in ours)
    jx, jy, jv = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(vs, jv)
    np.testing.assert_allclose(xs, jx, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(ys, jy, rtol=0, atol=POS_TOL)


def killed_by_the_check(vs, cfg):
    """Lanes TRACKED at the last frame without the check and lost with
    it."""
    fl = start_features()
    _, _, v0 = track_sequence(torch.from_numpy(frames()),
                              *features_from_numpy(fl.x, fl.y, fl.val),
                              dataclasses.replace(
                                  cfg, affine_consistency_check=-1))
    return (v0[-1].numpy() == kt.TRACKED) & (np.asarray(vs)[-1] < 0)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_track_sequence_affine_matches_klt_tpu(mode, monkeypatch):
    """Six steps on frames whose centre is slowly covered and zoomed:
    the check kills features there (LARGE_RESIDUE or OOB), and both
    packages kill the same ones at the same frames."""
    from klt_tpu.runtime.pipeline import track_sequence_affine as jaffine
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg, cfg = configs(mode)
    fl = start_features()
    ours = track_sequence_affine(torch.from_numpy(frames()),
                                 *features_from_numpy(fl.x, fl.y, fl.val),
                                 cfg)
    ref = jaffine(jnp.asarray(frames()), jnp.asarray(fl.x),
                  jnp.asarray(fl.y), jnp.asarray(fl.val), jcfg)
    assert_same_tracks(ours, ref)
    killed = killed_by_the_check(ours[2], cfg)
    assert killed.sum() >= 2
    assert in_affine_region(fl.x[killed] + 104, fl.y[killed] + 72,
                            margin=12).all()
    assert (np.asarray(ours[2])[-1] == kt.TRACKED).sum() >= 8


def jax_pyramid_state(frame, jcfg):
    from klt_tpu.ops.pyramid import build_image_pyramids
    pyr, gx, gy = build_image_pyramids(jnp.asarray(frame), jcfg)
    return tuple(pyr), tuple(gx), tuple(gy)


def level0_stack(jstate):
    return stacks_from_numpy([np.stack([np.asarray(jstate[k][0])
                                        for k in range(3)])])[0]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_affine_step_matches_klt_tpu_from_a_carried_state(mode,
                                                           monkeypatch):
    """Both packages start from one mid-sequence AffineState (klt_tpu's
    after the steps into frames 1 and 2, carried over through interop)
    and the same pyramids and translation tracks, and take the steps into
    frames 3, 4 and 5, each from klt_tpu's state: the same kills, `valid`
    masks and patch centres, maps within MAP_TOL, the patches saved for
    newly tracked lanes bit-equal."""
    from klt_tpu.ops import affine as jaff
    from klt_tpu.ops.lk import track_features_pyramid
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg, cfg = configs(mode)
    fr = frames()
    fl = start_features()
    jstate = jaff.AffineState.create(N_FEAT, jcfg)
    x, y, val = (jnp.asarray(a) for a in (fl.x, fl.y, fl.val))
    fields = ("valid", "img", "gradx", "grady", "x", "y", "axx", "ayx",
              "axy", "ayy")
    p1 = jax_pyramid_state(fr[0], jcfg)
    checked = 0
    for t in range(1, 6):
        p2 = jax_pyramid_state(fr[t], jcfg)
        xn, yn, vn = track_features_pyramid(
            list(p1[0]), list(p1[1]), list(p1[2]), list(p2[0]), list(p2[1]),
            list(p2[2]), x, y, val, jcfg)
        if t == 3:   # forget two live patches: lanes that save again
            live = np.flatnonzero(np.asarray(jstate.valid))[:2]
            jstate.invalidate(live)
        before = {k: np.asarray(getattr(jstate, k)) for k in fields}
        jout = jaff.affine_consistency_step(jstate, p1, p2, x, y, val, xn,
                                            yn, vn, jcfg)
        if t >= 3:
            state = affine_state_from_numpy(before)
            out = affine_consistency_step(
                state, level0_stack(p1), level0_stack(p2),
                *features_from_numpy(x, y, val),
                *features_from_numpy(xn, yn, vn), cfg)
            for a, b in zip(out, jout):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            after = affine_state_to_numpy(state)
            np.testing.assert_array_equal(after["valid"],
                                          np.asarray(jstate.valid))
            for k in ("x", "y"):
                np.testing.assert_array_equal(after[k],
                                              np.asarray(getattr(jstate, k)))
            ok = after["valid"]
            for k in ("axx", "ayx", "axy", "ayy"):
                np.testing.assert_allclose(
                    after[k][ok], np.asarray(getattr(jstate, k))[ok],
                    rtol=0, atol=MAP_TOL)
            for k in ("img", "gradx", "grady"):
                np.testing.assert_array_equal(after[k][ok],
                                              np.asarray(getattr(jstate,
                                                                 k))[ok])
            checked += int((before["valid"] & (np.asarray(vn) == 0)).sum())
            if t == 3:
                assert (~before["valid"][live]).all() and ok[live].all()
        x, y, val = jout
        p1 = p2
    assert checked >= 20   # lanes verified against their patch
    if mode > 0:
        moved = np.abs(np.asarray(jstate.axx)[np.asarray(jstate.valid)] - 1)
        assert moved.max() > 1e-3   # the maps did leave the identity


def test_tracker_with_the_check_and_replacement_matches_klt_tpu(monkeypatch):
    """KLTracker with mode 2: track, then replace every frame; selection
    and replacement invalidate the patches of the slots they fill, which
    then save anew.  Feature lists equal klt_tpu.KLTracker's after every
    call (statuses and picks exact, positions within POS_TOL)."""
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg, cfg = configs(2, mindist=6)
    fr = frames()
    ours_t = kt.KLTracker(cfg, device="cpu")
    ref_t = klt_tpu.KLTracker(jcfg)
    ours, ref = kt.FeatureList.create(N_FEAT), \
        klt_tpu.FeatureList.create(N_FEAT)
    ours_t.select_good_features(fr[0], ours)
    ref_t.select_good_features(fr[0], ref)
    replaced = 0
    for i in range(1, len(fr)):
        ours_t.track_features(fr[i - 1], fr[i], ours)
        ref_t.track_features(fr[i - 1], fr[i], ref)
        np.testing.assert_array_equal(ours.val, ref.val)
        np.testing.assert_allclose(ours.x, ref.x, rtol=0, atol=POS_TOL)
        np.testing.assert_allclose(ours.y, ref.y, rtol=0, atol=POS_TOL)
        np.testing.assert_array_equal(ours_t._affine.valid.numpy(),
                                      np.asarray(ref_t._affine.valid))
        lost = ours.val < 0
        ours_t.replace_lost_features(fr[i], ours)
        ref_t.replace_lost_features(fr[i], ref)
        np.testing.assert_array_equal(ours.val, ref.val)
        refilled = lost & (ours.val > 0)
        np.testing.assert_array_equal(ours.x[refilled], ref.x[refilled])
        np.testing.assert_array_equal(ours.y[refilled], ref.y[refilled])
        replaced += int(refilled.sum())
        # a refilled slot has no reference patch until it is tracked again
        assert not ours_t._affine.valid.numpy()[lost].any()
        np.testing.assert_array_equal(ours_t._affine.valid.numpy(),
                                      np.asarray(ref_t._affine.valid))
    assert replaced >= 3
    # selection forgets every patch
    ours_t.select_good_features(fr[0], ours)
    assert not ours_t._affine.valid.any()


def test_lighting_insensitive_with_the_check_matches_klt_tpu(monkeypatch):
    """lighting_insensitive=True with mode 2: the translation stage keeps
    its gain and bias terms, the affine stage has none."""
    from klt_tpu.runtime.pipeline import track_sequence_affine as jaffine
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg, cfg = configs(2, lighting_insensitive=True)
    fl = start_features()
    fr = frames()[:5]
    ours = track_sequence_affine(torch.from_numpy(fr),
                                 *features_from_numpy(fl.x, fl.y, fl.val),
                                 cfg)
    ref = jaffine(jnp.asarray(fr), jnp.asarray(fl.x), jnp.asarray(fl.y),
                  jnp.asarray(fl.val), jcfg)
    assert_same_tracks(ours, ref)
    plain = track_sequence_affine(torch.from_numpy(fr),
                                  *features_from_numpy(fl.x, fl.y, fl.val),
                                  dataclasses.replace(
                                      cfg, lighting_insensitive=False))
    assert not torch.equal(plain[0], ours[0])


# ------------------------------------------------------------------ #
# the port's own entry points                                          #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("mode", [0, 2])
def test_sequence_affine_equals_tracker_loop_plain_and_precomp(mode):
    """track_sequence_affine gives the KLTracker loop's table bit for bit,
    and the same with plain=True and with precomp=True."""
    cfg = configs(mode)[1]
    fr = frames()
    fl = start_features().copy()
    feats = features_from_numpy(fl.x, fl.y, fl.val)
    xs, ys, vs = track_sequence_affine(torch.from_numpy(fr), *feats, cfg)
    for kw in ({"plain": True}, {"precomp": True}):
        other = track_sequence_affine(torch.from_numpy(fr), *feats, cfg,
                                      **kw)
        assert all(torch.equal(a, b) for a, b in zip((xs, ys, vs), other))
    tr = kt.KLTracker(cfg, device="cpu")
    for i in range(1, len(fr)):
        tr.track_features(fr[i - 1], fr[i], fl)
        np.testing.assert_array_equal(fl.x, xs[i - 1].numpy())
        np.testing.assert_array_equal(fl.val, vs[i - 1].numpy())


def test_sequence_affine_refuses_a_config_without_the_check():
    cfg = kt.TrackingConfig(sequential_mode=True)
    fl = start_features()
    with pytest.raises(ValueError, match="affine_consistency_check"):
        track_sequence_affine(torch.from_numpy(frames()),
                              *features_from_numpy(fl.x, fl.y, fl.val), cfg)


def test_affine_state_round_trips_through_interop():
    cfg = kt.TrackingConfig(affine_consistency_check=1)
    state = AffineState.create(5, cfg, "cpu")
    assert state.img.shape == (5, 17, 17) and not state.valid.any()
    assert (state.axx == 1).all() and (state.ayx == 0).all()
    state.patches.copy_(torch.arange(3 * 5 * 289.0).reshape(3, 5, 17, 17))
    state.valid[:] = True
    state.invalidate(np.array([1, 3]))
    state.invalidate(np.array([], np.int64))
    assert state.valid.tolist() == [True, False, True, False, True]
    fields = affine_state_to_numpy(state)
    assert sorted(fields) == sorted(
        f.name for f in dataclasses.fields(klt_tpu.ops.affine.AffineState))
    back = affine_state_from_numpy(fields)
    assert torch.equal(back.patches, state.patches)
    assert torch.equal(back.valid, state.valid)
    with pytest.raises(ValueError, match="fields"):
        affine_state_from_numpy({"valid": fields["valid"]})


def test_entry_points_run_on_the_card_by_default_and_raise_without_one():
    """Without a CUDA device the default raises instead of carrying on on
    the CPU; device="cpu" runs."""
    assert not torch.cuda.is_available()
    cfg = kt.TrackingConfig(sequential_mode=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.KLTracker(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.KLTracker()
    fl = start_features()
    fr = frames()[:3]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(track_sequence_stream(iter(fr), fl.x, fl.y, fl.val, cfg))
    tr = kt.KLTracker(cfg, device="cpu")
    assert tr.device.type == "cpu"
    (t, x, _, _), = track_sequence_stream(iter(fr), fl.x, fl.y, fl.val, cfg,
                                          device="cpu")
    on_cpu = track_sequence(torch.from_numpy(fr),
                            *features_from_numpy(fl.x, fl.y, fl.val), cfg)
    assert t == 2 and np.array_equal(x, on_cpu[0][-1].numpy())
    # tensors run where they lie
    (t, x2, _, _), = track_sequence_stream(
        iter(fr), *features_from_numpy(fl.x, fl.y, fl.val), cfg)
    assert np.array_equal(x, x2)
