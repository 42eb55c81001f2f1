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


@pytest.mark.parametrize("n_feat,kw", [(150, {}), (1000, {"mindist": 5}),
                                       (64, {"min_eigenvalue": 500})])
def test_selection_picks_equal(n_feat, kw):
    img = fixture_frame()
    ours = kt.FeatureList.create(n_feat)
    kt.KLTracker(kt.TrackingConfig(**kw)).select_good_features(img, ours)
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
