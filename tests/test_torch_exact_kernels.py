"""Kernels G and H2 of the bit-exact tier (csrc/exact.cu) written out on
the CPU as the card runs them, since the kernels themselves cannot run
here: G's warp program in numpy f32, one lane at a time, and H2's tiling in
plain torch (`ops.replace_exact.exact_response_tiled`).  Each is held bit
for bit against the plain torch versions and, for G, the scalar oracle
(native/lk_exact_ref.c).  The kernels themselves are held against the
plain versions on a card in test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import klt_tpu_torch as kt
from chip_smoke import (exact_cases, exact_lk_cases, response_cases,
                        synthetic_frames)
from klt_tpu_torch import native
from klt_tpu_torch.ops.lk_exact import (build_pyramids_exact,
                                        exact_constants,
                                        track_features_exact_plain)
from klt_tpu_torch.ops.pyramid import build_pyramid_stacks_plain
from klt_tpu_torch.ops.replace_exact import (exact_response_plain,
                                             exact_response_tile,
                                             exact_response_tiled)

F32 = np.float32
WARP = 32
SUMS = 5  # gxx, gxy, gyy, ex, ey: one summing thread each


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.int32)


def assert_bits_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))


# ------------------------------------------------------------------ #
# G: the warp program, one lane at a time                              #
# ------------------------------------------------------------------ #

def chunk_cells(win: int) -> int:
    """K, the cells a thread forms a chunk (launch_track's choice in
    csrc/exact.cu): a chunk is 32 K cells."""
    n = win * win
    return 2 if n <= 64 else 4 if n <= 128 else 8


def oob(x, y, hw, rows, cols) -> bool:
    """klt_x_oob: the reference's bounds test in f32."""
    fhw = F32(hw)
    return bool((x - fhw < F32(0)) or (F32(cols) - (x + fhw) < F32(1.001))
                or (y - fhw < F32(0)) or (F32(rows) - (y + fhw) < F32(1.001)))


def samples(planes, x, y, cells, win):
    """klt_x_cell and klt_x_blend at window cells `cells` (row-major
    indices) of (x, y): [P, len(cells)] samples of planes [P, H, W]."""
    hw = win // 2
    cx = x + (cells % win - hw).astype(F32)
    cy = y + (cells // win - hw).astype(F32)
    xt, yt = cx.astype(np.int32), cy.astype(np.int32)  # (int): truncation
    ax, ay = cx - xt.astype(F32), cy - yt.astype(F32)
    bx, by = F32(1) - ax, F32(1) - ay
    w00, w01, w10, w11 = bx * by, ax * by, bx * ay, ax * ay
    return (((w00 * planes[:, yt, xt] + w01 * planes[:, yt, xt + 1]) +
             w10 * planes[:, yt + 1, xt]) + w11 * planes[:, yt + 1, xt + 1])


def thread_cells(base, k, ncell):
    """The cells threads 0..31 form in the chunk at `base`: thread t takes
    base + t, base + t + 32, ..; [k, 32] with the cells past the window
    dropped (flattened)."""
    c = base + np.arange(WARP)[None, :] + WARP * np.arange(k)[:, None]
    return c[c < ncell]


def warp_level_model(st1, st2, x1, y1, x2, y2, kc):
    """warp_track_level of csrc/exact.cu for one lane: returns (x2, y2,
    status)."""
    rows, cols = st1.shape[-2:]
    win = kc["win"]
    hw, ncell, k = win // 2, win * win, chunk_cells(win)
    chunk = WARP * k
    status, iters = kt.TRACKED, 0
    run = not oob(x1, y1, hw, rows, cols) and not oob(x2, y2, hw, rows, cols)
    if not run:
        status = kt.OOB
    h1 = None
    if run:  # image 1 sampled once a level, thread t its cells t + 32 m
        h1 = np.zeros((3, ncell), F32)
        c = thread_cells(0, -(-ncell // WARP), ncell)
        h1[:, c] = samples(st1, x1, y1, c, win)
    if kc["max_iterations"] <= 0:
        run = False
    while run:
        acc = np.full(SUMS, -0.0, F32)  # the five summing threads
        for base in range(0, ncell, chunk):
            c = thread_cells(base, k, ncell)
            g1, gx1, gy1 = h1[:, c]
            g2, gx2, gy2 = samples(st2, x2, y2, c, win)
            diff, gx, gy = g1 - g2, gx1 + gx2, gy1 + gy2
            buf = np.zeros((SUMS, chunk), F32)  # the chunk's product rows
            buf[:, c - base] = np.stack(
                [gx * gx, gx * gy, gy * gy, diff * gx, diff * gy])
            for m in range(min(chunk, ncell - base)):  # in row-major order
                acc = acc + buf[:, m]
        gxx, gxy, gyy, ex, ey = acc  # __shfl_sync to every thread
        ex, ey = ex * kc["step_factor"], ey * kc["step_factor"]
        det = gxx * gyy - gxy * gxy
        if not det >= kc["min_determinant"]:
            status = kt.SMALL_DET
            break
        dx = (gyy * ex - gxy * ey) / det
        dy = (gxx * ey - gxy * ex) / det
        x2, y2, iters = x2 + dx, y2 + dy, iters + 1
        run = ((abs(dx) >= kc["min_displacement"] or
                abs(dy) >= kc["min_displacement"]) and
               iters < kc["max_iterations"])
        if run and oob(x2, y2, hw, rows, cols):
            status, run = kt.OOB, False
    if oob(x2, y2, hw, rows, cols):
        status = kt.OOB
    if status == kt.TRACKED and kc["check_residue"]:
        resid = F32(-0.0)  # thread 0's chain
        for base in range(0, ncell, chunk):
            c = thread_cells(base, k, ncell)
            buf = np.zeros(chunk, F32)
            buf[c - base] = np.abs(h1[0, c] -
                                   samples(st2[:1], x2, y2, c, win)[0])
            for m in range(min(chunk, ncell - base)):
                resid = resid + buf[m]
        if resid / F32(ncell) > kc["max_residue"]:
            status = kt.LARGE_RESIDUE
    if status == kt.TRACKED and iters >= kc["max_iterations"]:
        status = kt.MAX_ITERATIONS
    return x2, y2, status


def warp_track_model(stacks1, stacks2, x, y, val, cfg):
    """exact_track of csrc/exact.cu: a warp per lane, the level walk and
    write-back of klt_x_track_lane.  numpy in, numpy (x, y, val) out."""
    st1 = [s.numpy() for s in stacks1]
    st2 = [s.numpy() for s in stacks2]
    kc = {name: (F32(v) if isinstance(v, float) else v) for name, v in
          exact_constants(cfg, *st1[0].shape[-2:]).items()}
    ss = kc["subsampling"]
    xo, yo, vo = x.copy(), y.copy(), val.copy()
    with np.errstate(all="ignore"):
        for f in np.flatnonzero(val >= 0):
            xloc, yloc = x[f], y[f]
            for _ in st1:
                xloc, yloc = xloc / ss, yloc / ss
            xout, yout, status, alive = xloc, yloc, kt.TRACKED, True
            for r in range(len(st1) - 1, -1, -1):
                xloc, yloc, xout, yout = xloc * ss, yloc * ss, xout * ss, \
                    yout * ss
                if not alive:
                    continue
                xout, yout, status = warp_level_model(
                    st1[r], st2[r], xloc, yloc, xout, yout, kc)
                alive = status not in (kt.SMALL_DET, kt.OOB)
            # klt_x_write_back
            border = (xout < kc["border_x0"] or xout > kc["border_x1"] or
                      yout < kc["border_y0"] or yout > kc["border_y1"])
            is_oob = status == kt.OOB or (status != kt.SMALL_DET and border)
            if is_oob or status < 0:
                xo[f], yo[f] = -1.0, -1.0
                vo[f] = kt.OOB if is_oob else status
            else:
                xo[f], yo[f], vo[f] = xout, yout, kt.TRACKED
    return xo, yo, vo


def check_warp_model(f1, f2, x, y, val, cfg):
    p1 = build_pyramids_exact(torch.from_numpy(f1), cfg)
    p2 = build_pyramids_exact(torch.from_numpy(f2), cfg)
    got = warp_track_model(p1, p2, x, y, val, cfg)
    assert_bits_equal(got, native.track_exact_ref(
        [s.numpy() for s in p1], [s.numpy() for s in p2], x, y, val,
        exact_constants(cfg, *p1[0].shape[-2:])))
    assert_bits_equal(got, track_features_exact_plain(
        p1, p2, *(torch.from_numpy(a) for a in (x, y, val)), cfg))
    return got


LK_CASES = exact_lk_cases()


@pytest.mark.parametrize("case", range(len(LK_CASES)),
                         ids=[c[0] for c in LK_CASES])
def test_kernel_g_warp_model_equals_oracle_and_plain_on_made_lanes(case):
    name, kw, f1, f2, x, y, val = LK_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    v = check_warp_model(f1, f2, x, y, val, cfg)[2]
    assert (v[:2] == kt.OOB).all() and (v[2:4] == kt.SMALL_DET).all()
    if name.startswith("min displacement 0"):
        # every lane that was not killed ran max_iterations on every level
        assert (v == kt.MAX_ITERATIONS).sum() >= 20
        assert not (v == kt.TRACKED).any()
    if "27x27" in name:
        assert chunk_cells(cfg.window_width) * WARP < 27 * 27


def seeded_pair(kw, seed):
    """Two 120x160 crops of the scene along the synthetic path, features
    selected on the first, then moved by up to 1.5 px."""
    fr = synthetic_frames(2 + seed % 5)[:, 50:170, 70:230]
    cfg = kt.TrackingConfig(sequential_mode=True, **kw)
    fl = kt.FeatureList.create(60)
    kt.KLTracker(cfg, device="cpu").select_good_features(fr[0], fl)
    rng = np.random.RandomState(seed)
    x = fl.x + rng.uniform(-1.5, 1.5, 60).astype(F32)
    y = fl.y + rng.uniform(-1.5, 1.5, 60).astype(F32)
    return fr[0], fr[-1], x, y, fl.val, cfg


@pytest.mark.parametrize("win,levels,ss", [
    (5, 2, 4), (7, 2, 4), (9, 3, 2), (15, 2, 2), (27, 1, 2)])
def test_kernel_g_warp_model_equals_oracle_and_plain_on_frame_pairs(
        win, levels, ss):
    kt.set_verbosity(0)
    f1, f2, x, y, val, cfg = seeded_pair(
        {"window_width": win, "window_height": win,
         "n_pyramid_levels": levels, "subsampling": ss}, seed=win)
    assert cfg.n_pyramid_levels == levels
    v = check_warp_model(f1, f2, x, y, val, cfg)[2]
    assert (v == kt.TRACKED).sum() >= 15


# ------------------------------------------------------------------ #
# H2: the tiling                                                       #
# ------------------------------------------------------------------ #

def test_kernel_h2_tile_rule():
    """A tile of 32 x 16 outputs, its three product planes with the halo in
    at most 227 KB of shared memory: square windows up to 115x115."""
    assert exact_response_tile(7, 7) == 16
    assert exact_response_tile(115, 115) == 16
    assert exact_response_tile(117, 117) == 0
    assert exact_response_tile(121, 121) == 0
    assert exact_response_tile(0, 7) == 0


RESPONSE_CASES = response_cases()


@pytest.mark.parametrize("case", range(len(RESPONSE_CASES)),
                         ids=[c[0] for c in RESPONSE_CASES])
def test_kernel_h2_tiled_model_equals_plain_on_response_cases(case):
    """Every window of response_cases fits H2's tile, also the 111x111 one
    that kernel D's tiles do not hold."""
    name, gx, gy, win = RESPONSE_CASES[case]
    gx, gy = torch.from_numpy(gx), torch.from_numpy(gy)
    got = exact_response_tiled(gx, gy, *win)
    assert_bits_equal([got], [exact_response_plain(gx, gy, *win)])
    if "clamp" in name:
        assert (got == 2147483583.0).any()


EXACT_CASES = exact_cases()


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("case", range(len(EXACT_CASES)),
                         ids=[c[0] for c in EXACT_CASES])
def test_kernel_h2_tiled_model_equals_plain_on_exact_cases(case, smooth):
    """On kernel A's level-0 gradients, smoothed and not, as the exact tier
    gives them to H2."""
    _, kw, frame = EXACT_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    st = build_pyramid_stacks_plain(torch.from_numpy(frame), cfg, 1, smooth)
    gx, gy = st[0][1], st[0][2]
    win = (cfg.window_width, cfg.window_height)
    assert_bits_equal([exact_response_tiled(gx, gy, *win)],
                      [exact_response_plain(gx, gy, *win)])


def test_kernel_h2_tiled_model_refuses_a_window_no_tile_holds():
    gx = torch.zeros(130, 130)
    with pytest.raises(ValueError, match="no tile"):
        exact_response_tiled(gx, gx, 121, 121)
