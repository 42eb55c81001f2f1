"""ctypes bindings for the native host runtime (sort + suppression).

Compiles `klt_tpu/native/kltnative.c` (the C source the JAX package
ships; nothing of that package is imported) with `cc -O2 -shared -fPIC`
into the port's build directory on first use, and again whenever the
source is newer than the library.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import BUILD_DIR, compile_shared, is_stale, repo_path

_SRC = repo_path("klt_tpu", "native", "kltnative.c")
_LIB = os.path.join(BUILD_DIR, "libkltnative.so")
_lock = threading.Lock()
_lib = None


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
