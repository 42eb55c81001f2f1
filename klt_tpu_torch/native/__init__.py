"""ctypes bindings for the native host runtime (sort + suppression, the
threaded PGM batch loader) and for the scalar oracle of the bit-exact LK
tier.

Compiles the port's own `kltnative.c`, beside this file (a byte-for-byte
copy of the JAX package's native source, which the tests hold equal),
with `cc -O2 -shared -fPIC` into the port's build directory on first use,
and again whenever the source is newer than the library.  `lk_exact_ref.c`
(the scalar lane program of csrc/lk_exact_lane.h, whose per-cell helpers
kernel G shares, one feature after another) builds the same way with `cc -O0 -ffp-contract=off`, so that
every f32 operation rounds on its own, as the reference's goldens were
made (tools/fixtures/gen.sh).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import BUILD_DIR, compile_shared, is_stale, repo_path

_SRC = repo_path("klt_tpu_torch", "native", "kltnative.c")
_LIB = os.path.join(BUILD_DIR, "libkltnative.so")
_REF_SRC = repo_path("klt_tpu_torch", "native", "lk_exact_ref.c")
_REF_DEPS = [_REF_SRC, repo_path("klt_tpu_torch", "csrc", "lk_exact_lane.h")]
_REF_LIB = os.path.join(BUILD_DIR, "liblkexactref.so")
_lock = threading.Lock()
_lib = None
_ref_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if is_stale(_LIB, [_SRC]):
            cc = os.environ.get("CC", "cc")
            compile_shared([cc, "-O2", "-shared", "-fPIC", "-pthread", _SRC],
                           _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.klt_sort_points_desc.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.klt_sort_points_desc.restype = None
        lib.klt_min_dist_suppress.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.klt_min_dist_suppress.restype = None
        lib.klt_load_pgm_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.klt_load_pgm_batch.restype = ctypes.c_int64
        _lib = lib
        return lib


def sort_points_desc(pts: np.ndarray) -> np.ndarray:
    """In-place descending sort of int32 [n, 3] (x, y, val) triples by val,
    with the reference's exact tie ordering."""
    pts = np.ascontiguousarray(pts, dtype=np.int32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected [n, 3] points, got {pts.shape}")
    lib = _load()
    lib.klt_sort_points_desc(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(pts.shape[0]))
    return pts


def min_dist_suppress(pts: np.ndarray, fx: np.ndarray, fy: np.ndarray,
                      fval: np.ndarray, ncols: int, nrows: int,
                      mindist: int, min_eigenvalue: int,
                      overwrite_all: bool) -> None:
    """Greedy minimum-distance acceptance into (fx, fy, fval), in place."""
    pts = np.ascontiguousarray(pts, dtype=np.int32)
    for a, dt in ((fx, np.float32), (fy, np.float32), (fval, np.int32)):
        if a.dtype != dt or not a.flags.c_contiguous or a.shape != fx.shape:
            raise ValueError("feature arrays must be contiguous [n] "
                             "float32 x, y and int32 val")
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected [n, 3] points, got {pts.shape}")
    if pts.size and (pts[:, 0].min() < 0 or pts[:, 0].max() >= ncols or
                     pts[:, 1].min() < 0 or pts[:, 1].max() >= nrows):
        raise ValueError("candidate points outside the image")
    lib = _load()
    lib.klt_min_dist_suppress(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(pts.shape[0]),
        fx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fval.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(fx.shape[0]),
        ctypes.c_int32(ncols), ctypes.c_int32(nrows),
        ctypes.c_int32(max(mindist, 0)), ctypes.c_int32(min_eigenvalue),
        ctypes.c_int32(1 if overwrite_all else 0))


def load_pgm_batch(paths, height: int, width: int,
                   n_threads: int = 8) -> np.ndarray:
    """Threaded batch load of binary PGM frames -> uint8 [n, h, w].

    The native analogue of looping pgmReadFile (src/V1/pnmio.c:206-230),
    parallelized across files for long sequences.  Every file must be
    height x width; raises OSError naming the first file that fails."""
    n = len(paths)
    if height <= 0 or width <= 0:
        raise ValueError("height and width must be positive")
    out = np.empty((n, height, width), np.uint8)
    if n == 0:
        return out
    names = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * n)(*names)
    rc = _load().klt_load_pgm_batch(
        arr, ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(height), ctypes.c_int64(width),
        ctypes.c_int64(n_threads))
    if rc != 0:
        raise OSError(f"failed to load PGM file: {paths[rc - 1]}")
    return out


def _load_ref() -> ctypes.CDLL:
    global _ref_lib
    with _lock:
        if _ref_lib is not None:
            return _ref_lib
        if is_stale(_REF_LIB, _REF_DEPS):
            cc = os.environ.get("CC", "cc")
            compile_shared([cc, "-O0", "-ffp-contract=off", "-shared",
                            "-fPIC", _REF_SRC], _REF_LIB)
        lib = ctypes.CDLL(_REF_LIB)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.klt_exact_track_ref.argtypes = (
            [ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(i),
             ctypes.POINTER(i), i, p, p, p, i, i, i, i] + [f] * 9 + [p] * 3)
        lib.klt_exact_track_ref.restype = i
        _ref_lib = lib
        return lib


def track_exact_ref(stacks1, stacks2, x, y, val, consts: dict):
    """The scalar lane program of csrc/lk_exact_lane.h on the host, one
    feature after another (kernel G spreads each lane over a warp).

    stacks1, stacks2: finest-first f32 [3, H_l, W_l] numpy stacks of the
    two frames; x, y f32 [N], val i32 [N]; consts: the lane program's
    configuration (`ops.lk_exact.exact_constants`).  Returns new numpy
    (x, y, val)."""
    st1 = [np.ascontiguousarray(s, np.float32) for s in stacks1]
    st2 = [np.ascontiguousarray(s, np.float32) for s in stacks2]
    if len(st1) != len(st2) or any(a.shape != b.shape or a.ndim != 3 or
                                   a.shape[0] != 3
                                   for a, b in zip(st1, st2)):
        raise ValueError("stacks must be pairs of equal [3, H, W] levels")
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    val = np.ascontiguousarray(val, np.int32)
    n = x.shape[0]
    if y.shape != (n,) or val.shape != (n,):
        raise ValueError("x, y, val must be [N]")
    nlev = len(st1)
    xo, yo, vo = np.empty_like(x), np.empty_like(y), np.empty_like(val)
    ptrs = ctypes.c_void_p * nlev
    ints = ctypes.c_int * nlev
    k = consts
    rc = _load_ref().klt_exact_track_ref(
        ptrs(*[a.ctypes.data for a in st1]),
        ptrs(*[a.ctypes.data for a in st2]),
        ints(*[a.shape[1] for a in st1]), ints(*[a.shape[2] for a in st1]),
        nlev, x.ctypes.data, y.ctypes.data, val.ctypes.data, n, k["win"],
        k["max_iterations"], k["check_residue"], k["subsampling"],
        k["min_determinant"], k["min_displacement"], k["step_factor"],
        k["max_residue"], k["border_x0"], k["border_x1"], k["border_y0"],
        k["border_y1"], xo.ctypes.data, yo.ctypes.data, vo.ctypes.data)
    if rc != 0:
        raise ValueError(f"the oracle takes 1 to 8 levels, got {nlev}")
    return xo, yo, vo
