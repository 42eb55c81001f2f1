"""Lost-feature replacement in the port held against klt_tpu on the CPU:
the corner response (plain version of kernel D), the device replacement
(plain version of kernel R), KLTracker's replace flow,
track_sequence_replace, the batched pyramid (plain version of kernel E),
precomp, track_sequence_stream and the PPM overlay.  The kernels
themselves are held against these plain versions on a card in
test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import klt_tpu
import klt_tpu_torch as kt
from chip_smoke import replace_cases, response_cases, synthetic_frames
from klt_tpu_torch.interop import config_from_fields, features_from_numpy
from klt_tpu_torch.ops.convolve import convolve_1d
from klt_tpu_torch.ops.pyramid import (build_pyramid_stacks_batched,
                                       build_pyramid_stacks_plain)
from klt_tpu_torch.ops.replace import (replace_lost_features_device,
                                       replace_lost_plain_)
from klt_tpu_torch.ops.selection import (_candidate_borders,
                                         corner_response_plain)
from klt_tpu_torch.runtime import pipeline
from klt_tpu_torch.runtime.pipeline import (track_sequence,
                                            track_sequence_replace,
                                            track_sequence_stream)

POS_TOL = 1e-3  # px, as tests/test_torch_slice.py: XLA sums in another order
MAP_TOL = 1e-3  # as tests/test_torch_pyramid.py
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def frames():
    """Synthetic frames with known motion; a flat patch covers part of
    the scene from frame 3 on, so that features are lost and replaced."""
    fr = synthetic_frames(11)
    fr[3:, 60:120, 100:180] = 128
    return fr


def jcfg_and_cfg(**kw):
    jcfg = klt_tpu.TrackingConfig(**kw)
    return jcfg, config_from_fields(dataclasses.asdict(jcfg))


def level0_gradients(frame, cfg):
    st = build_pyramid_stacks_plain(torch.from_numpy(frame), cfg)
    return st[0][1], st[0][2]


def trace(gx, gy, ww, wh):
    """Box-filtered gxx + gyy: the scale an ulp of the response has."""
    box = lambda a: convolve_1d(convolve_1d(a, np.ones(ww, np.float32), -1),
                                np.ones(wh, np.float32), -2)
    return (box(gx * gx) + box(gy * gy)).numpy()


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from klt_tpu.pallas import pyramid as pp
    from klt_tpu.pallas import selection as ps
    monkeypatch.setenv("KLT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("KLT_TPU_NO_PALLAS", raising=False)
    for fn in (pp._fused_call, pp._fused_call_batched, ps._response_call):
        fn.cache_clear()
    yield
    for fn in (pp._fused_call, pp._fused_call_batched, ps._response_call):
        fn.cache_clear()


@pytest.mark.parametrize("window", [(7, 7), (9, 5)])
def test_corner_response_matches_pallas_kernel_interpret(window, frames,
                                                         interpret_pallas):
    """Tolerance: 2 f32 ulps of the window's trace (gxx + gyy).  XLA:CPU
    compiles the interpreted kernel with roundings of its own: about one
    pixel in ten differs in the last bits, by at most 1.3 ulps of the
    trace.  The port's plain version is IEEE step by step (it equals
    numpy evaluating the same expression)."""
    from klt_tpu.pallas.selection import fused_corner_response
    ww, wh = window
    _, cfg = jcfg_and_cfg()
    gx, gy = level0_gradients(frames[1], cfg)
    ref = np.asarray(fused_corner_response(jnp.asarray(gx.numpy()),
                                           jnp.asarray(gy.numpy()), ww, wh))
    ours = corner_response_plain(gx, gy, ww, wh).numpy()
    assert ours.shape == ref.shape
    tol = 2 * EPS * trace(gx, gy, ww, wh)
    assert (np.abs(ours - ref) <= tol).all()
    # zeroed borders, as the Pallas kernel's
    assert not ours[:wh // 2].any() and not ours[:, :ww // 2].any()
    assert not ref[:wh // 2].any() and not ref[:, :ww // 2].any()


@pytest.mark.parametrize("window", [(7, 7), (9, 5)])
def test_corner_response_matches_xla_path_on_the_interior(window, frames,
                                                          monkeypatch):
    """klt_tpu's XLA path zero-pads its box filter instead of zeroing the
    borders, so only the window-interior region compares.  Tolerance: 2
    f32 ulps of the trace (XLA's convolution sums in its own order)."""
    from klt_tpu.ops.selection import corner_response
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    ww, wh = window
    _, cfg = jcfg_and_cfg()
    gx, gy = level0_gradients(frames[4], cfg)
    ref = np.asarray(corner_response(jnp.asarray(gx.numpy()),
                                     jnp.asarray(gy.numpy()), ww, wh))
    ours = corner_response_plain(gx, gy, ww, wh).numpy()
    inner = (slice(wh // 2, -(wh // 2)), slice(ww // 2, -(ww // 2)))
    tol = 2 * EPS * trace(gx, gy, ww, wh)[inner]
    assert (np.abs(ours[inner] - ref[inner]) <= tol).all()


RESPONSE_CASES = response_cases()


@pytest.mark.parametrize("case", range(len(RESPONSE_CASES)),
                         ids=[c[0] for c in RESPONSE_CASES])
def test_tiled_corner_response_bit_equal_to_plain(case):
    """Kernel D's tiling written out in plain torch (tile by tile with
    halos, products once per pixel, zeroing by global coordinates) gives
    the plain version's bits on every shape the card is asked."""
    from klt_tpu_torch.ops.selection import (_INT_LIMIT,
                                             corner_response_tiled,
                                             response_tile_rows)
    name, gx, gy, win = RESPONSE_CASES[case]
    gx, gy = torch.from_numpy(gx), torch.from_numpy(gy)
    tiled = corner_response_tiled(gx, gy, *win)
    plain = corner_response_plain(gx, gy, *win)
    assert (tiled is None) == ("no tile" in name)
    if tiled is not None:
        assert torch.equal(tiled.view(torch.int32), plain.view(torch.int32))
    th = response_tile_rows(*win, *gx.shape)
    assert th == (0 if "no tile" in name else 32 if "tall" in name else 8)
    assert torch.isfinite(plain).all()
    assert ("clamp" in name) == bool((plain == _INT_LIMIT).any())
    if min(gx.shape) > max(win):
        assert plain.abs().max() > 0


def lost_state(fl, rng, share):
    """fl with a share of its slots lost under various tracking codes."""
    val = fl.val.copy()
    lost = rng.rand(fl.n_features) < share
    val[lost] = rng.choice([kt.NOT_FOUND, kt.SMALL_DET, kt.OOB,
                            kt.LARGE_RESIDUE], lost.sum())
    x = np.where(lost, -1.0, fl.x).astype(np.float32)
    y = np.where(lost, -1.0, fl.y).astype(np.float32)
    return x, y, val


@pytest.mark.parametrize("kw", [
    {"mindist": 10}, {"mindist": 1}, {"mindist": 5, "n_skipped_pixels": 1},
    {"mindist": 10, "n_skipped_pixels": 1, "min_eigenvalue": 500},
    {"mindist": 5, "min_eigenvalue": 500}])
def test_replace_device_matches_klt_tpu(kw, frames, interpret_pallas):
    """The plain replacement against klt_tpu's on the same gradient maps
    (its response through the Pallas kernel in interpret mode): x, y and
    val exactly equal."""
    from klt_tpu.ops.replace import replace_lost_features_device as jrep
    jcfg, cfg = jcfg_and_cfg(sequential_mode=True, **kw)
    fl = kt.FeatureList.create(120)
    kt.KLTracker(cfg, device="cpu").select_good_features(frames[0], fl)
    x, y, val = lost_state(fl, np.random.RandomState(3), 0.25)
    gx, gy = level0_gradients(frames[1], cfg)
    ref = jrep(jnp.asarray(gx.numpy()), jnp.asarray(gy.numpy()),
               jnp.asarray(x), jnp.asarray(y), jnp.asarray(val), jcfg)
    ours = replace_lost_features_device(gx, gy,
                                        *features_from_numpy(x, y, val), cfg)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    refilled = (val < 0) & (ours[2].numpy() > 0)
    assert refilled.sum() > 0


def test_replace_device_exhausts_candidates(frames, interpret_pallas):
    """More lost slots than candidates on a small crop: every slot left
    lost becomes NOT_FOUND at (-1, -1), whatever its tracking code was,
    in both packages."""
    from klt_tpu.ops.replace import replace_lost_features_device as jrep
    jcfg, cfg = jcfg_and_cfg(sequential_mode=True, mindist=10)
    crop = np.ascontiguousarray(frames[1][80:144, 120:200])
    gx, gy = level0_gradients(crop, cfg)
    n = 80
    x = np.full(n, -1.0, np.float32)
    y = np.full(n, -1.0, np.float32)
    val = np.resize(np.array([kt.OOB, kt.SMALL_DET, kt.LARGE_RESIDUE,
                              kt.MAX_ITERATIONS], np.int32), n)
    x[:3], y[:3], val[:3] = (30.0, 40.0, 50.0), (30.0, 32.0, 34.0), 0
    ref = jrep(jnp.asarray(gx.numpy()), jnp.asarray(gy.numpy()),
               jnp.asarray(x), jnp.asarray(y), jnp.asarray(val), jcfg)
    ours = replace_lost_features_device(gx, gy,
                                        *features_from_numpy(x, y, val), cfg)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    xo, yo, vo = (a.numpy() for a in ours)
    unfilled = vo < 0
    assert 0 < (vo[3:] > 0).sum() and unfilled.sum() > 0
    assert (vo[unfilled] == kt.NOT_FOUND).all()
    assert (xo[unfilled] == -1.0).all() and (yo[unfilled] == -1.0).all()
    assert (vo[:3] == 0).all()  # live slots untouched


def test_replace_device_equals_host_tier(frames):
    """The device replacement (masked argmax) and KLTracker's host tier
    (tie-exact sort and suppression) take the same values; a pick may
    land elsewhere only where its truncated value is tied among the
    candidates (scan order against quicksort order): the flat patch
    appearing at frame 3 makes such ties along its edge."""
    from klt_tpu_torch.ops.selection import candidate_points
    cfg = kt.TrackingConfig(sequential_mode=True)
    tr = kt.KLTracker(cfg, device="cpu")
    fl = kt.FeatureList.create(150)
    tr.select_good_features(frames[2], fl)
    tr.track_features(frames[2], frames[3], fl)
    assert (fl.val < 0).sum() > 5
    host = fl.copy()
    tr.replace_lost_features(frames[3], host)
    st = tr._pyr_last
    xd, yd, vd = replace_lost_features_device(
        st[0][1], st[0][2], *features_from_numpy(fl.x, fl.y, fl.val), cfg)
    np.testing.assert_array_equal(vd.numpy(), host.val)
    moved = (xd.numpy() != host.x) | (yd.numpy() != host.y)
    assert moved.sum() <= 2
    pts = candidate_points(corner_response_plain(st[0][1], st[0][2], 7, 7)
                           .numpy(), cfg, 320, 240)
    for v in host.val[moved]:
        assert (pts[:, 2] == v).sum() > 1


def tiled_replace_model(resp, x, y, val, cfg, tile):
    """Kernel R's algorithm (csrc/replace.cu) written out in numpy, on
    tiles of `tile` x `tile` cells; x, y, val are updated in place.
    First pass, tile by tile: the features whose square meets the tile,
    the masked int cells less those inside a listed square, the tile's
    best (value, lowest flat index).  Then the greedy loop: the best of
    the tiles' bests fills the first lost slot, its square is killed, and
    of the tiles the square meets those whose best was killed are scanned
    again.  Returns how many tiles were scanned again."""
    h, w = resp.shape
    borderx, bordery, step = _candidate_borders(cfg)
    floor = max(1, int(cfg.min_eigenvalue))
    stamp = max(int(cfg.mindist) - 1, 0)
    n = len(val)
    cx, cy = np.trunc(x).astype(np.int64), np.trunc(y).astype(np.int64)
    live = (val >= 0) & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    yy, xx = np.mgrid[0:h, 0:w]
    ok = ((yy >= bordery) & (yy < h - bordery) & (xx >= borderx) &
          (xx < w - borderx) & ((yy - bordery) % step == 0) &
          ((xx - borderx) % step == 0))
    trunc = np.trunc(resp).astype(np.int64)
    flat = yy * w + xx
    m = np.full((h, w), -1, np.int64)
    tiles_y, tiles_x = -(-h // tile), -(-w // tile)
    best = {}

    def scan(ty, tx):
        sl = (slice(ty * tile, (ty + 1) * tile),
              slice(tx * tile, (tx + 1) * tile))
        v = m[sl].max()
        best[ty, tx] = (int(v), int(flat[sl][m[sl] == v].min()))

    if not (val < 0).any():
        return 0
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            y0, x0 = ty * tile, tx * tile
            sl = (slice(y0, y0 + tile), slice(x0, x0 + tile))
            meets = live & (cx >= x0 - stamp) & (cx <= x0 + tile - 1 + stamp) \
                & (cy >= y0 - stamp) & (cy <= y0 + tile - 1 + stamp)
            killed = np.zeros(m[sl].shape, bool)
            for f in np.flatnonzero(meets):
                killed |= (np.abs(xx[sl] - cx[f]) <= stamp) & \
                    (np.abs(yy[sl] - cy[f]) <= stamp)
            m[sl] = np.where(ok[sl] & ~killed & (trunc[sl] >= floor),
                             trunc[sl], -1)
            scan(ty, tx)

    slot, rescans = 0, 0
    while True:
        while slot < n and val[slot] >= 0:
            slot += 1
        # the larger value, the lower flat index at equal value
        bv, bi = max(best.values(), key=lambda b: (b[0], -b[1]))
        if slot >= n or bv < floor:
            break
        py, px = divmod(bi, w)
        x[slot], y[slot], val[slot] = px, py, bv
        x0, x1 = max(px - stamp, 0), min(px + stamp, w - 1)
        y0, y1 = max(py - stamp, 0), min(py + stamp, h - 1)
        m[y0:y1 + 1, x0:x1 + 1] = -1
        for ty in range(y0 // tile, y1 // tile + 1):
            for tx in range(x0 // tile, x1 // tile + 1):
                ov, oi = best[ty, tx]
                oy, ox = divmod(oi, w)
                if ov >= 0 and x0 <= ox <= x1 and y0 <= oy <= y1:
                    scan(ty, tx)
                    rescans += 1
    lost = val < 0
    x[lost] = y[lost] = -1.0
    val[lost] = kt.NOT_FOUND
    return rescans


REPLACE_CASES = replace_cases()


@pytest.mark.parametrize("tile", [7, 16, 32])
@pytest.mark.parametrize("case", range(len(REPLACE_CASES)),
                         ids=[c[0] for c in REPLACE_CASES])
def test_tiled_replace_model_equals_plain(case, tile):
    """The tile hierarchy picks what the argmax over the whole map picks,
    ties across tiles and rows included, whatever the tile size."""
    name, kw, resp, x, y, val = REPLACE_CASES[case]
    cfg = kt.TrackingConfig(**kw)
    mx, my, mval = x.copy(), y.copy(), val.copy()
    rescans = tiled_replace_model(resp, mx, my, mval, cfg, tile)
    px, py, pval = features_from_numpy(x, y, val)
    replace_lost_plain_(torch.from_numpy(resp), px, py, pval, cfg)
    np.testing.assert_array_equal(mval, pval.numpy())
    np.testing.assert_array_equal(mx, px.numpy())
    np.testing.assert_array_equal(my, py.numpy())
    lost = val < 0
    filled = int((lost & (mval > 0)).sum())
    assert not ((mval < 0) & (mval != kt.NOT_FOUND)).any()
    if name.startswith("no slot"):
        assert filled == 0 and rescans == 0
        np.testing.assert_array_equal(mval, val)
    else:
        assert filled > 0 and rescans >= filled
    if name.startswith(("more lost", "all slots")):
        assert (mval[lost] == kt.NOT_FOUND).any()  # candidates ran out
    if name.startswith("ties"):
        # equal values were picked from several tiles and rows
        top = mval[lost & (mval > 0)]
        rows = my[lost & (mval > 0)][top == top.max()]
        assert (top == top.max()).sum() > 3 and len(set(rows // 32)) > 1


def assert_same_tracks(ours, ref):
    np.testing.assert_array_equal(np.asarray(ours[2]), np.asarray(ref[2]))
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=POS_TOL)


def test_tracker_replace_flow_matches_klt_tpu(frames, monkeypatch):
    """The reference's example3 REPLACE flow through both KLTrackers
    (klt_tpu on its XLA path) over 4 frames: statuses and picks exact,
    positions within POS_TOL."""
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    kw = {"sequential_mode": True, "mindist": 8}
    ours_t = kt.KLTracker(kt.TrackingConfig(**kw), device="cpu")
    ref_t = klt_tpu.KLTracker(klt_tpu.TrackingConfig(**kw))
    ours = kt.FeatureList.create(60)
    ref = klt_tpu.FeatureList.create(60)
    ours_t.select_good_features(frames[0], ours)
    ref_t.select_good_features(frames[0], ref)
    replaced = 0
    for i in range(1, 5):
        ours_t.track_features(frames[i - 1], frames[i], ours)
        ref_t.track_features(frames[i - 1], frames[i], ref)
        assert_same_tracks((ours.x, ours.y, ours.val),
                           (ref.x, ref.y, ref.val))
        lost = ours.val < 0
        ours_t.replace_lost_features(frames[i], ours)
        ref_t.replace_lost_features(frames[i], ref)
        assert_same_tracks((ours.x, ours.y, ours.val),
                           (ref.x, ref.y, ref.val))
        replaced += int((lost & (ours.val > 0)).sum())
    assert replaced >= 10


def start_features(frame, n, cfg):
    fl = kt.FeatureList.create(n)
    kt.KLTracker(cfg, device="cpu").select_good_features(frame, fl)
    return fl


def test_track_sequence_replace_matches_klt_tpu(frames, monkeypatch):
    """Over 6 frames against klt_tpu's track_sequence_replace on its XLA
    path: the bar is status agreement >= 0.97 per frame and POS_TOL where
    both agree (their pyramids differ at the ulp level); on this scene the
    statuses and picks agree exactly, so that is asserted."""
    from klt_tpu.runtime.pipeline import track_sequence_replace as jtsr
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg, cfg = jcfg_and_cfg(sequential_mode=True)
    fl = start_features(frames[0], 100, cfg)
    ref = jtsr(jnp.asarray(frames[:7]), jnp.asarray(fl.x), jnp.asarray(fl.y),
               jnp.asarray(fl.val), jcfg)
    ours = track_sequence_replace(torch.from_numpy(frames[:7]),
                                  *features_from_numpy(fl.x, fl.y, fl.val),
                                  cfg)
    ref = [np.asarray(a) for a in ref]
    ours = [a.numpy() for a in ours]
    assert ours[0].shape == (6, 100)
    for t in range(6):
        assert (ours[2][t] == ref[2][t]).mean() >= 0.97
    assert_same_tracks(ours, ref)
    assert (ours[2][2] > 0).sum() >= 5  # refilled at the patch's frame


def test_track_sequence_replace_equals_tracker_loop(frames):
    """The device replacement inside track_sequence_replace and the
    KLTracker loop's host tier differ only at integer ties (scan order
    against quicksort order); on this scene there are none."""
    cfg = kt.TrackingConfig(sequential_mode=True)
    fl = start_features(frames[0], 100, cfg)
    start = fl.copy()
    tr = kt.KLTracker(cfg, device="cpu")
    rows = []
    for i in range(1, 7):
        tr.track_features(frames[i - 1], frames[i], fl)
        tr.replace_lost_features(frames[i], fl)
        rows.append(fl.copy())
    xs, ys, vs = track_sequence_replace(
        torch.from_numpy(frames[:7]),
        *features_from_numpy(start.x, start.y, start.val), cfg)
    for t, row in enumerate(rows):
        np.testing.assert_array_equal(vs[t].numpy(), row.val)
        np.testing.assert_array_equal(xs[t].numpy(), row.x)
        np.testing.assert_array_equal(ys[t].numpy(), row.y)


@pytest.mark.parametrize("entry", ["track_sequence", "track_sequence_replace",
                                   "track_sequence_stream"])
def test_precomp_is_bit_equal(entry, frames, monkeypatch):
    """precomp=True (batched pyramids ahead of the steps, here 4 frames a
    launch over 10 steps) gives bit-equal tables."""
    monkeypatch.setattr(pipeline, "PRECOMP_FRAMES", 4)
    cfg = kt.TrackingConfig(sequential_mode=True)
    fl = start_features(frames[0], 60, cfg)
    feats = features_from_numpy(fl.x, fl.y, fl.val)
    if entry == "track_sequence_stream":
        run = lambda pre: [a for out in track_sequence_stream(
            iter(frames), *feats, cfg, chunk=3, precomp=pre)
            for a in out[1:]]
    else:
        fn = getattr(pipeline, entry)
        run = lambda pre: [a.numpy() for a in fn(torch.from_numpy(frames),
                                                 *feats, cfg, precomp=pre)]
    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a, b)


def test_batched_pyramid_matches_pallas_kernel_interpret(frames,
                                                         interpret_pallas):
    """Plain batched pyramid at [4, 64, 80] against klt_tpu's batched
    Pallas kernel in interpret mode (MAP_TOL, as the single-frame
    comparison); per image it is bit-equal to the single-frame plain
    pyramid."""
    from klt_tpu.pallas.pyramid import fused_build_pyramid_stacks_batched
    jcfg, cfg = jcfg_and_cfg()
    imgs = np.ascontiguousarray(frames[:4, 80:144, 120:200])
    ref = fused_build_pyramid_stacks_batched(jnp.asarray(imgs), jcfg)
    ours = build_pyramid_stacks_batched(torch.from_numpy(imgs), cfg)
    assert len(ours) == len(ref) == cfg.n_pyramid_levels
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=MAP_TOL)
    for i in range(4):
        one = build_pyramid_stacks_plain(torch.from_numpy(imgs[i]), cfg)
        for a, b in zip(ours, one):
            assert torch.equal(a[i], b)


def test_track_sequence_stream_matches_klt_tpu(frames, monkeypatch):
    """Chunks of 4 over 11 frames (a partial tail of 2) against klt_tpu's
    stream on its XLA path: the same snapshot frames, statuses exact,
    positions within POS_TOL; each snapshot bit-equal to the port's
    track_sequence at that frame."""
    from klt_tpu.runtime.pipeline import track_sequence_stream as jstream
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    jcfg, cfg = jcfg_and_cfg(sequential_mode=True)
    fl = start_features(frames[0], 50, cfg)
    ref = list(jstream(iter(frames), fl.x, fl.y, fl.val, jcfg, chunk=4))
    ours = list(track_sequence_stream(iter(frames), fl.x, fl.y, fl.val, cfg,
                                      chunk=4, device="cpu"))
    assert [o[0] for o in ours] == [r[0] for r in ref] == [4, 8, 10]
    whole = track_sequence(torch.from_numpy(frames),
                           *features_from_numpy(fl.x, fl.y, fl.val), cfg)
    for o, r in zip(ours, ref):
        assert_same_tracks(o[1:], r[1:])
        for a, w in zip(o[1:], whole):
            np.testing.assert_array_equal(a, w[o[0] - 1].numpy())


def test_device_response_selection_matches_klt_tpu(frames, monkeypatch):
    """KLT_TPU_EXACT_SELECT=0 in both packages (klt_tpu on its XLA path):
    the same positions; a truncated value may differ by 1 where XLA's
    rounding crosses an integer."""
    monkeypatch.setenv("KLT_TPU_EXACT_SELECT", "0")
    monkeypatch.setenv("KLT_TPU_NO_PALLAS", "1")
    for kw in ({}, {"smooth_before_selecting": False, "mindist": 5}):
        ours = kt.FeatureList.create(150)
        ref = klt_tpu.FeatureList.create(150)
        kt.KLTracker(kt.TrackingConfig(**kw),
                     device="cpu").select_good_features(
            frames[0], ours)
        klt_tpu.KLTracker(klt_tpu.TrackingConfig(**kw)).select_good_features(
            frames[0], ref)
        np.testing.assert_array_equal(ours.x, ref.x)
        np.testing.assert_array_equal(ours.y, ref.y)
        assert np.abs(ours.val - ref.val).max() <= 1
        assert ours.count_remaining() == 150


def test_write_feature_list_ppm_byte_equal_to_klt_tpu(frames, tmp_path):
    from klt_tpu.utils.viz import write_feature_list_ppm as jwrite
    fl = start_features(frames[0], 40, kt.TrackingConfig())
    fl.val[::7] = kt.OOB  # lost features are not drawn
    fl.x[0], fl.y[0], fl.val[0] = 0.2, 239.4, 3  # clipped at the edges
    kt.write_feature_list_ppm(fl, frames[1], str(tmp_path / "ours.ppm"))
    jwrite(klt_tpu.FeatureList(fl.x, fl.y, fl.val), frames[1],
           str(tmp_path / "ref.ppm"))
    ours = (tmp_path / "ours.ppm").read_bytes()
    assert ours == (tmp_path / "ref.ppm").read_bytes()
    assert ours.startswith(b"P6\n320 240\n255\n")


def test_cuda_wrappers_refuse_cpu_tensors(frames):
    from klt_tpu_torch.cuda.corner_response import corner_response_cuda
    from klt_tpu_torch.cuda.pyramid import build_pyramid_stacks_batched_cuda
    from klt_tpu_torch.cuda.replace import replace_lost_cuda_
    cfg = kt.TrackingConfig()
    gx, gy = level0_gradients(frames[1], cfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        corner_response_cuda(gx, gy, 7, 7)
    with pytest.raises(ValueError, match="CUDA tensor"):
        build_pyramid_stacks_batched_cuda(torch.from_numpy(frames[:2]), cfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        replace_lost_cuda_(gx, *features_from_numpy([1.0], [1.0], [-1]),
                           cfg)
