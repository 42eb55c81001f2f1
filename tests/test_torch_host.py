"""klt_tpu_torch's host layer held against klt_tpu: Gaussian taps, config
derivations, feature-file formats, the native runtime and selection."""

import dataclasses
import os

import numpy as np
import pytest

import klt_tpu
import klt_tpu_torch as kt
from conftest import FIXTURES, load_f32

SIGMAS = [0.3, 0.5, 0.7, 1.0, 1.5, 2.7, 3.6, 7.2]
TABLES = sorted(f for f in os.listdir(FIXTURES) if f.startswith("table_"))


def fixture_frame() -> np.ndarray:
    """The 240x320 fixture scene as a uint8 frame."""
    img = load_f32("smoothed_img0.f32", (240, 320))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_taps_bit_equal(sigma):
    from klt_tpu.kernels import gaussian_kernels as jax_taps
    from klt_tpu_torch.kernels import gaussian_kernels, kernel_widths
    for ours, ref in zip(gaussian_kernels(sigma), jax_taps(sigma)):
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours.view(np.uint32),
                                      ref.view(np.uint32))
    assert kernel_widths(sigma) == klt_tpu.kernels.kernel_widths(sigma)


@pytest.mark.parametrize("window", [(3, 3), (4, 4), (5, 7), (7, 7),
                                    (9, 5), (11, 11), (15, 15)])
def test_config_derivations_equal(window):
    from klt_tpu.config import derive_pyramid as jax_pyr
    from klt_tpu_torch.config import derive_pyramid, derive_border
    from klt_tpu_torch.interop import config_from_fields
    ww, wh = window
    for sr in (0, 1, 3, 5, 8, 15, 25, 30, 60, 100):
        assert derive_pyramid(ww, wh, sr) == jax_pyr(ww, wh, sr)
        ref = klt_tpu.TrackingConfig(window_width=ww, window_height=wh,
                                     search_range=sr)
        ours = kt.TrackingConfig(window_width=ww, window_height=wh,
                                 search_range=sr)
        fields = dataclasses.asdict(ref)
        fields.pop("reanchor_unroll")
        assert dataclasses.asdict(ours) == fields
        assert derive_border(ours) == klt_tpu.config.derive_border(ref)
        assert config_from_fields(dataclasses.asdict(ref)) == ours
        assert (kt.config.pyramid_shapes(320, 240, ours) ==
                klt_tpu.config.pyramid_shapes(320, 240, ref))


def test_config_from_fields_rejects_unknown_fields():
    from klt_tpu_torch.interop import config_from_fields
    with pytest.raises(ValueError, match="no_such_field"):
        config_from_fields({"no_such_field": 1})


@pytest.mark.parametrize("name", TABLES)
def test_feature_table_binary_round_trip(name, tmp_path):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        raw = f.read()
    ft = kt.read_feature_table(path)
    ref = klt_tpu.read_feature_table(path)
    for a, b in ((ft.x, ref.x), (ft.y, ref.y), (ft.val, ref.val)):
        np.testing.assert_array_equal(a, b)
    out = tmp_path / "out.ft"
    kt.write_feature_table(ft, str(out))
    assert out.read_bytes() == raw


@pytest.mark.parametrize("fmt", ["%5.1f", "%6d"])
def test_feature_files_text_equal(fmt, tmp_path):
    """Text tables, lists and histories byte-equal to klt_tpu's writers,
    and binary lists/histories too."""
    path = os.path.join(FIXTURES, "table_lighting.ft")
    ft = kt.read_feature_table(path)
    ref = klt_tpu.read_feature_table(path)
    pairs = [
        (lambda p, f: kt.write_feature_table(ft, p, f),
         lambda p, f: klt_tpu.write_feature_table(ref, p, f)),
        (lambda p, f: kt.write_feature_list(ft.extract_list(3), p, f),
         lambda p, f: klt_tpu.write_feature_list(ref.extract_list(3), p, f)),
        (lambda p, f: kt.write_feature_history(ft.extract_history(5), p, f),
         lambda p, f: klt_tpu.write_feature_history(ref.extract_history(5),
                                                    p, f)),
    ]
    for i, (ours, theirs) in enumerate(pairs):
        for f in (fmt, None):
            a, b = tmp_path / f"a{i}", tmp_path / f"b{i}"
            ours(str(a), f)
            theirs(str(b), f)
            assert a.read_bytes() == b.read_bytes()
    back = kt.read_feature_table(str(tmp_path / "a0"))
    np.testing.assert_array_equal(back.val, ft.val)


def test_native_sort_and_suppress_equal_klt_tpu():
    from klt_tpu import native as jax_native
    from klt_tpu_torch import native
    rng = np.random.RandomState(7)
    n = 4000
    pts = np.stack([rng.randint(0, 200, n), rng.randint(0, 150, n),
                    rng.randint(0, 60, n)], axis=1).astype(np.int32)
    ours = native.sort_points_desc(pts.copy())
    ref = jax_native.sort_points_desc(pts.copy())
    np.testing.assert_array_equal(ours, ref)  # tie order included
    out = []
    for mod, p in ((native, ours), (jax_native, ref)):
        fx = np.full(300, -1.0, np.float32)
        fy = np.full(300, -1.0, np.float32)
        fv = np.full(300, -1, np.int32)
        mod.min_dist_suppress(p, fx, fy, fv, 200, 150, mindist=7,
                              min_eigenvalue=1, overwrite_all=True)
        out.append((fx, fy, fv))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def _lazy_case(name, rng, n=4000):
    """(pts int32 [n, 3] in a 200x150 image, slots, min_eigenvalue); a
    "<case>.pending<k>" case keeps at most k ranges pending."""
    name = name.split(".")[0]
    hi, slots, floor = 8, 60, 1
    if name in ("n0", "n1", "n2"):
        n = int(name[1])
    elif name == "spread":
        hi = 20000
    elif name == "floor_above_all":
        floor = hi + 1               # the walk reads the whole list
    elif name == "fewer_candidates_than_slots":
        n = 25
    pts = np.stack([rng.randint(0, 200, n), rng.randint(0, 150, n),
                    rng.randint(1, hi + 1, n)], axis=1).astype(np.int32)
    if name == "all_equal":
        pts[:, 2] = 5
    elif name == "sorted":
        pts[:, 2] = np.arange(n, 0, -1)
    return pts, slots, floor


@pytest.mark.parametrize("mindist", [0, 1, 10])
@pytest.mark.parametrize("overwrite_all", [True, False])
@pytest.mark.parametrize("case", [
    "ties", "spread", "n0", "n1", "n2", "all_equal", "sorted",
    "floor_above_all", "fewer_candidates_than_slots",
    # ranges nested deeper than the pending bound are sorted whole
    "ties.pending1", "spread.pending2", "sorted.pending3",
    "floor_above_all.pending4"])
def test_lazy_sort_equals_the_full_sort(case, overwrite_all, mindist,
                                        monkeypatch):
    """The lazy sort and its walk select what sort_points_desc and
    min_dist_suppress select, and its final rows are the full sort's."""
    from klt_tpu_torch import native
    if ".pending" in case:
        monkeypatch.setattr(native, "LAZY_PENDING", int(case[-1]))
    rng = np.random.RandomState(len(case) + 10 * mindist)
    pts, slots, floor = _lazy_case(case, rng)
    live = rng.rand(slots) < (0.0 if overwrite_all else 0.5)
    start = (np.where(live, rng.randint(0, 200, slots), -1).astype(np.float32),
             np.where(live, rng.randint(0, 150, slots), -1).astype(np.float32),
             np.where(live, rng.randint(1, 50, slots), -1).astype(np.int32))
    full = native.sort_points_desc(pts.copy())
    want = tuple(a.copy() for a in start)
    native.min_dist_suppress(full, *want, 200, 150, mindist, floor,
                             overwrite_all)
    lazy = native.LazySort(pts.copy(), np.empty((150, 200), np.uint8))
    got = tuple(a.copy() for a in start)
    lazy.min_dist_suppress(*got, 200, 150, mindist, floor, overwrite_all)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    k = lazy.n_final
    assert min(len(pts), 1) <= k <= len(pts)
    np.testing.assert_array_equal(lazy.pts[:k], full[:k])  # tie order too
    # the rest is the same rows, not yet in order
    np.testing.assert_array_equal(np.sort(lazy.pts[:, 2]),
                                  np.sort(pts[:, 2]))
    if case.split(".")[0] in ("floor_above_all",
                              "fewer_candidates_than_slots"):
        assert k == len(pts)
        np.testing.assert_array_equal(lazy.pts, full)


def test_native_rejects_points_outside_the_image():
    from klt_tpu_torch import native
    pts = np.array([[5, 5, 10], [300, 5, 9]], np.int32)
    f = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="outside"):
        native.min_dist_suppress(pts, f, f.copy(), np.zeros(2, np.int32),
                                 200, 150, 10, 1, True)


def test_selection_response_and_candidates_equal():
    from klt_tpu.ops.exact_select import selection_response_exact as jresp
    from klt_tpu.ops.selection import candidate_points as jcand
    from klt_tpu_torch.ops.exact_select import selection_response_exact
    from klt_tpu_torch.ops.selection import candidate_points
    img = fixture_frame()
    for kw in ({}, {"smooth_before_selecting": False, "n_skipped_pixels": 1,
                    "window_width": 5}):
        ours_cfg = kt.TrackingConfig(**kw)
        ref_cfg = klt_tpu.TrackingConfig(**kw)
        ours = selection_response_exact(img, ours_cfg)
        ref = jresp(img, ref_cfg)
        np.testing.assert_array_equal(ours.view(np.uint32),
                                      ref.view(np.uint32))
        np.testing.assert_array_equal(candidate_points(ours, ours_cfg, 320,
                                                       240),
                                      jcand(ref, ref_cfg, 320, 240))


# (frame rows, cols, config fields): the grid's step, a window wider than
# twice the border, odd sizes, a border that leaves no candidate
CANDIDATE_GRIDS = [
    (64, 80, {}),
    (64, 80, {"n_skipped_pixels": 1}),
    (61, 77, {"n_skipped_pixels": 2}),
    (97, 123, {"window_width": 61, "window_height": 55, "borderx": 3,
               "bordery": 5}),
    (53, 71, {"n_skipped_pixels": 1, "window_width": 5, "borderx": 0,
              "bordery": 1}),
    (40, 44, {}),
]


def candidate_map(rng, rows, cols):
    """A float32 response map holding negative, fractional and +-0.5
    values and values near 2^31, spread over the whole map so that every
    grid meets them."""
    special = np.float32([0.5, -0.5, 0.4999999, -0.4999999, 1.5, -1.5,
                          2.9999998, -2.9999998, 0.0, -0.0, 1e-30, -7.25,
                          2147483520.0, -2147483520.0, -2147483648.0,
                          16777217.0, 8388607.5])
    m = rng.normal(0.0, 3e3, (rows, cols)).astype(np.float32)
    pick = rng.random((rows, cols)) < 0.4
    m[pick] = rng.choice(special, int(pick.sum()))
    return m


@pytest.mark.parametrize("rows,cols,kw", CANDIDATE_GRIDS,
                         ids=[f"{r}x{c}-{sorted(k)}"
                              for r, c, k in CANDIDATE_GRIDS])
def test_candidate_pass_equals_klt_tpu(rows, cols, kw):
    """The C pass (native.candidate_list) gives klt_tpu's candidate list
    bit for bit, rows in the same order; two maps written one after the
    other into one buffer, which the lazy sort permuted in between, give
    exactly the second map's list."""
    from klt_tpu.ops.selection import candidate_points as jcand
    from klt_tpu_torch import native
    from klt_tpu_torch.ops.selection import (candidate_count,
                                             candidate_points)
    rng = np.random.default_rng(rows * 1000 + cols)
    ours_cfg = kt.TrackingConfig(**kw)
    ref_cfg = klt_tpu.TrackingConfig(**kw)
    first, second = (candidate_map(rng, rows, cols) for _ in range(2))
    want = jcand(first, ref_cfg, cols, rows)
    assert len(want) == candidate_count(ours_cfg, cols, rows)
    np.testing.assert_array_equal(
        candidate_points(first, ours_cfg, cols, rows), want)
    out = np.full_like(want, -7)
    assert candidate_points(first, ours_cfg, cols, rows, out=out) is out
    np.testing.assert_array_equal(out, want)
    if len(out) > 1:
        native.LazySort(out, np.empty((rows, cols), np.uint8))  # in place
        assert not np.array_equal(out, want)
    np.testing.assert_array_equal(
        candidate_points(second, ours_cfg, cols, rows, out=out),
        jcand(second, ref_cfg, cols, rows))
    with pytest.raises(ValueError):
        candidate_points(first, ours_cfg, cols, rows, out=out[:, :2])


# kernel S's plain model (ops/select_sort.py) held against lazy_select.c:
# the list, one partition in the pairing form, and a lazy sort resumed from
# the partitions it made

SPECIALS = np.float32([np.nan, -np.nan, np.inf, -np.inf, 2147483648.0,
                       -2147483648.0, 2147483520.0, -2147483520.0,
                       4294967296.0, -2147483904.0, 0.9999999, -0.9999999])


@pytest.mark.parametrize("rows,cols,kw", CANDIDATE_GRIDS,
                         ids=[f"{r}x{c}-{sorted(k)}"
                              for r, c, k in CANDIDATE_GRIDS])
def test_card_list_model_equals_the_c_pass(rows, cols, kw):
    """S's list in plain torch is klt_candidate_list's, bit for bit, NaN,
    +-inf and values at and beyond +-2^31 included; its state holds the
    one range [0, n) pending, as klt_lazy_sort_begin starts."""
    import torch
    from klt_tpu_torch import native
    from klt_tpu_torch.ops.select_sort import candidate_list_plain
    from klt_tpu_torch.ops.selection import candidate_count, candidate_points
    rng = np.random.default_rng(rows * 7 + cols)
    cfg = kt.TrackingConfig(**kw)
    m = candidate_map(rng, rows, cols)
    pick = rng.random((rows, cols)) < 0.3
    m[pick] = rng.choice(SPECIALS, int(pick.sum()))
    n = candidate_count(cfg, cols, rows)
    out = torch.full((n, 3), -7, dtype=torch.int32)
    state = torch.full((3 + 2 * native.LAZY_PENDING,), -5, dtype=torch.int64)
    candidate_list_plain(torch.from_numpy(m), cfg, out, state)
    np.testing.assert_array_equal(out.numpy(),
                                  candidate_points(m, cfg, cols, rows))
    want = [native.LAZY_PENDING, 1, 0, 0, n] if n >= 2 else \
        [native.LAZY_PENDING, 0, n]
    assert state[:len(want)].tolist() == want


def _values(kind, rng, n):
    """int32 [n, 3] rows of a `_lazy_case` kind at n rows."""
    return _lazy_case(kind, rng, n)[0]


@pytest.mark.parametrize("n", [2, 3, 17, 4000, 300_000])
@pytest.mark.parametrize("kind", ["ties", "spread", "all_equal", "sorted"])
def test_pairing_partition_equals_the_c_loop(kind, n):
    """One partition in the pairing form moves every row where
    klt_sort_points_desc's Hoare loop moves it, ties included, and stops
    at the same pivot row; also on a range inside a longer list."""
    import torch
    from klt_tpu_torch import native
    from klt_tpu_torch.ops.select_sort import partition_plain
    rng = np.random.RandomState(n + len(kind))
    pts = _values(kind, rng, n)
    want = pts.copy()
    j = native.partition_desc(want)
    got = torch.from_numpy(pts.copy())
    assert partition_plain(got, 0, n) == j
    np.testing.assert_array_equal(got.numpy(), want)
    if n >= 4:
        lo, hi = n // 4, n - n // 8
        want = pts.copy()
        j = native.partition_desc(want[lo:hi])
        got = torch.from_numpy(pts.copy())
        assert partition_plain(got, lo, hi) == j
        np.testing.assert_array_equal(got.numpy(), want)


# (kind, rows, k0, s_min, rounds, cap): the model's partitions, then the
# host's; "spill" prefixes are shorter than the walk's reach
RESUMED = [
    ("ties", 300_000, 8192, 16384, 64, None),
    ("spread", 300_000, 8192, 16384, 64, None),
    ("spread", 300_000, 500, 1000, 64, None),
    ("all_equal", 300_000, 8192, 16384, 64, None),
    ("sorted", 300_000, 4000, 3000, 64, None),
    ("floor_above_all", 40_000, 2000, 1000, 64, None),
    ("spread", 300_000, 500, 1000, 2, None),       # stopped by rounds
    ("spread", 300_000, 50_000, 1000, 64, 3),      # stopped by the cap
    ("ties", 25, 4, 2, 64, None),
    ("n2", 2, 1, 1, 64, None),
]


@pytest.mark.parametrize("prefix", ["k0+s_min", "spill", "all"])
@pytest.mark.parametrize("overwrite_all", [True, False])
@pytest.mark.parametrize("case", RESUMED, ids=[
    "-".join(map(str, c)) for c in RESUMED])
def test_lazy_sort_resumed_from_the_model_equals_the_lazy_sort(
        case, overwrite_all, prefix, monkeypatch):
    """A LazySort resumed from the state and the list head that S's plain
    partitions leave selects what a LazySort started on the host selects,
    makes the same rows final, in the same tie order, whether its walk
    stays inside the head or brings in the rest; rows the model left to
    the host (cap, rounds) are sorted there."""
    import torch
    from klt_tpu_torch import native
    from klt_tpu_torch.ops.select_sort import (head_partitions_plain,
                                               start_state)
    kind, n, k0, s_min, rounds, cap = case
    if cap is not None:
        monkeypatch.setattr(native, "LAZY_PENDING", cap)
    rng = np.random.RandomState(n % 1000 + k0 + rounds)
    pts, slots, floor = _lazy_case(kind, rng, n)
    if kind == "ties" and n == 25:
        slots = 40                          # more slots than rows
    live = rng.rand(slots) < (0.0 if overwrite_all else 0.5)
    start = (np.where(live, rng.randint(0, 200, slots), -1).astype(np.float32),
             np.where(live, rng.randint(0, 150, slots), -1).astype(np.float32),
             np.where(live, rng.randint(1, 50, slots), -1).astype(np.int32))
    walk = (200, 150, 10, floor, overwrite_all)

    host = native.LazySort(pts.copy(), np.empty((150, 200), np.uint8))
    want = tuple(a.copy() for a in start)
    host.min_dist_suppress(*want, *walk)

    card = torch.from_numpy(pts.copy())
    state = torch.empty(3 + 2 * native.LAZY_PENDING, dtype=torch.int64)
    state[0] = native.LAZY_PENDING
    start_state(state, n)
    made = head_partitions_plain(card, state, k0, s_min, rounds)
    assert made <= rounds
    rows = {"k0+s_min": min(n, k0 + s_min), "spill": min(n, 3),
            "all": n}[prefix]
    head = np.full_like(pts, -1)
    head[:rows] = card.numpy()[:rows]
    brought = []

    def rest():
        brought.append(1)
        head[rows:] = card.numpy()[rows:]
        return n

    lazy = native.LazySort.resume(head, state.numpy(), rows,
                                  np.empty((150, 200), np.uint8))
    got = tuple(a.copy() for a in start)
    lazy.min_dist_suppress(*got, *walk, more=rest)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert lazy.n_final == host.n_final
    k = lazy.n_final
    np.testing.assert_array_equal(head[:k], host.pts[:k])  # tie order too
    if prefix == "all":
        assert not brought
    if prefix == "spill" and n > 3:
        assert brought == [1]


def test_resume_rejects_what_is_no_lazy_sort_state():
    from klt_tpu_torch import native
    pts = np.zeros((10, 3), np.int32)
    state = np.zeros(3 + 2 * native.LAZY_PENDING, np.int64)
    state[0] = native.LAZY_PENDING
    walk_map = np.zeros((5, 5), np.uint8)
    native.LazySort.resume(pts, state, 10, walk_map)
    with pytest.raises(ValueError, match="state"):
        native.LazySort.resume(pts, state[:-1], 10, walk_map)
    with pytest.raises(ValueError, match="state"):
        native.LazySort.resume(pts, state, 11, walk_map)
    with pytest.raises(ValueError, match="walk_map"):
        native.LazySort.resume(pts, state, 10, walk_map.astype(np.int32))
    with pytest.raises(ValueError, match="walk_map"):
        native.LazySort(pts.copy(), walk_map[:, ::2])
    lazy = native.LazySort.resume(pts, state, 0, walk_map)
    f = np.zeros(1, np.float32)
    with pytest.raises(RuntimeError, match="needs row 0"):
        lazy.min_dist_suppress(f, f.copy(), np.full(1, -1, np.int32), 5, 5,
                               1, 1, False)


@pytest.mark.parametrize("n_feat,kw", [(150, {}), (1000, {"mindist": 5}),
                                       (64, {"min_eigenvalue": 500})])
def test_selection_picks_equal(n_feat, kw):
    img = fixture_frame()
    ours = kt.FeatureList.create(n_feat)
    kt.KLTracker(kt.TrackingConfig(**kw),
                 device="cpu").select_good_features(img, ours)
    ref = klt_tpu.FeatureList.create(n_feat)
    klt_tpu.KLTracker(klt_tpu.TrackingConfig(**kw)).select_good_features(
        img, ref)
    assert ours.count_remaining() > 0
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.y, ref.y)
    np.testing.assert_array_equal(ours.val, ref.val)


def test_pnm_round_trip_equals_klt_tpu(tmp_path):
    img = fixture_frame()
    rgb = np.stack([img, img[::-1], 255 - img], axis=-1)
    kt.write_pgm(str(tmp_path / "a.pgm"), img)
    klt_tpu.write_pgm(str(tmp_path / "b.pgm"), img)
    kt.write_ppm(str(tmp_path / "a.ppm"), rgb)
    klt_tpu.write_ppm(str(tmp_path / "b.ppm"), rgb)
    for ext in ("pgm", "ppm"):
        assert ((tmp_path / f"a.{ext}").read_bytes() ==
                (tmp_path / f"b.{ext}").read_bytes())
    np.testing.assert_array_equal(kt.read_pgm(str(tmp_path / "b.pgm")), img)
    np.testing.assert_array_equal(kt.read_ppm(str(tmp_path / "b.ppm")), rgb)


def test_errors_surface():
    from klt_tpu_torch.errors import KLTError, KLTWarningCategory, klt_warning
    assert issubclass(KLTError, RuntimeError)
    with pytest.warns(KLTWarningCategory, match="careful"):
        klt_warning("careful")
