"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

The sources in klt_tpu_torch/csrc/ are compiled by nvcc into one shared
library with a plain C interface, `build/klt_tpu_torch/libklt_kernels.so`,
at first use (and again whenever a source is newer than the library): one
nvcc process per source, all started together, then one link.
Each C entry enqueues its kernels on the stream it is given and returns
`cudaGetLastError()`; a `Kernel` raises when that is not cudaSuccess and
otherwise counts one launch, so a run can show which kernels its main
path went through.  Under a CUDA graph (cuda/graph.py) the C entries run
once, at capture, which launches nothing: the capture's counts are taken
back and credited on every replay.

No flag relaxes IEEE arithmetic: `/` and `sqrtf` stay correctly rounded,
and `-fmad=false` keeps every multiply and add separately rounded, in
the order the plain torch versions and the C reference use.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from .._build import BUILD_DIR, compile_shared, is_stale, repo_path

SOURCES = [repo_path("klt_tpu_torch", "csrc", name)
           for name in ("pyramid.cu", "lk_level.cu", "corner_response.cu",
                        "replace.cu", "affine.cu", "exact.cu",
                        "select_sort.cu")]
# headers the sources include: a change to one rebuilds the library
HEADERS = [repo_path("klt_tpu_torch", "csrc", "lk_exact_lane.h")]
LIB = os.path.join(BUILD_DIR, "libklt_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
# What the last build printed (ptxas register/spill report) and took.
build_log = ""
build_seconds = None


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _build() -> str:
    """Compile every source to an object file in parallel, then link the
    library; returns what nvcc printed (ptxas' register report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}."
                           f"{os.getpid()}.o")
        cmd = [_nvcc()] + NVCC_FLAGS + ["-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        log.append(compile_shared([_nvcc(), "-shared"] +
                                  [obj for _, obj, _ in jobs], LIB))
    finally:
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(log)


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load libklt_kernels.so."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if is_stale(LIB, SOURCES + HEADERS):
            t0 = time.perf_counter()
            build_log = _build()
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(LIB)
        lib.klt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.klt_cuda_error_string.restype = ctypes.c_char_p
        lib.klt_lk_max_levels.argtypes = []
        lib.klt_lk_max_levels.restype = ctypes.c_int
        for name in ("klt_replace_tile", "klt_replace_max_tiles"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.klt_pyramid_needs_scratch.argtypes = [_I, _I, _I]
        lib.klt_pyramid_needs_scratch.restype = ctypes.c_int
        for name in ("klt_corner_response_tile", "klt_exact_response_tile"):
            getattr(lib, name).argtypes = [_I, _I]
            getattr(lib, name).restype = ctypes.c_int
        lib.klt_affine_max_cells.argtypes = []
        lib.klt_affine_max_cells.restype = ctypes.c_int
        lib.klt_select_scratch_ints.argtypes = [_LL]
        lib.klt_select_scratch_ints.restype = _LL
        lib.klt_exact_max_levels.argtypes = []
        lib.klt_exact_max_levels.restype = ctypes.c_int
        if lib.klt_exact_max_levels() != EXACT_MAX_LEVELS:
            raise RuntimeError("EXACT_MAX_LEVELS differs from the library's "
                               "KLT_EXACT_MAX_LEVELS")
        if lib.klt_affine_max_cells() != AFFINE_MAX_CELLS:
            raise RuntimeError("AFFINE_MAX_CELLS differs from the library's "
                               "KLT_AFFINE_MAX_CELLS")
        if lib.klt_lk_max_levels() != LK_MAX_LEVELS:
            raise RuntimeError("LK_MAX_LEVELS differs from the library's "
                               "KLT_MAX_LEVELS")
        if (lib.klt_replace_tile(), lib.klt_replace_max_tiles()) != \
                (REPLACE_TILE, REPLACE_MAX_TILES):
            raise RuntimeError("REPLACE_TILE or REPLACE_MAX_TILES differs "
                               "from the library's kTile, kMaxTiles")
        for k in KERNELS:
            fn = getattr(lib, k.symbol)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


class Kernel:
    """One C entry of libklt_kernels.so and its launch count."""

    def __init__(self, symbol: str, argtypes: list, source: str,
                 replaces: str):
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None  # the bound C function, once the library is loaded

    def __call__(self, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(load_library(), self.symbol)
        rc = fn(*args)
        if rc != 0:
            msg = load_library().klt_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

PYRAMID = Kernel(
    "klt_build_pyramid",
    # img, img_is_u8, rows, cols, nlev, ss, 4 x (taps, ntaps),
    # level outputs (host array of device pointers), scratch, stream
    [_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _I,
     ctypes.POINTER(_P), _P, _P],
    source="klt_tpu_torch/csrc/pyramid.cu",
    replaces="klt_tpu/pallas/pyramid.py:104")

LK_LEVEL = Kernel(
    "klt_lk_level",
    # stack1, stack2, rows, cols, x1, y1, x2, y2, active, n,
    # window w/h, min_displacement, min_determinant, step_factor,
    # max_iterations, lighting, want_residue,
    # x2_out, y2_out, status, iters, residue, stream
    [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I,
     _I, _I, _F, _F, _F, _I, _I, _I,
     _P, _P, _P, _P, _P, _P],
    source="klt_tpu_torch/csrc/lk_level.cu",
    replaces="klt_tpu/pallas/lk2.py:55")

PYRAMID_BATCHED = Kernel(
    "klt_build_pyramid_batched",
    # imgs, img_is_u8, batch, rows, cols, nlev, ss, 4 x (taps, ntaps),
    # level outputs (host array of device pointers), scratch, stream
    [_P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _I,
     ctypes.POINTER(_P), _P, _P],
    source="klt_tpu_torch/csrc/pyramid.cu",
    replaces="klt_tpu/pallas/pyramid.py:247")

# Kernel D, tiled in shared memory: one launch, no scratch.
CORNER_RESPONSE = Kernel(
    "klt_corner_response",
    # gradx, grady, rows, cols, window w/h, out, stream
    [_P, _P, _I, _I, _I, _I, _P, _P],
    source="klt_tpu_torch/csrc/corner_response.cu",
    replaces="klt_tpu/pallas/selection.py:28")

# Kernel D for a window that no tile holds: two global-memory passes.
CORNER_RESPONSE_GLOBAL = Kernel(
    "klt_corner_response_global",
    # gradx, grady, rows, cols, window w/h, out, scratch, stream
    [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    source="klt_tpu_torch/csrc/corner_response.cu",
    replaces="klt_tpu/pallas/selection.py:28")

# Not a TPU kernel: the XLA while_loop of klt_tpu's device replacement.
REPLACE_LOST = Kernel(
    "klt_replace_lost",
    # resp, rows, cols, x, y, val, n, borderx, bordery, step, floor,
    # stamp, scratch (map and tile bests), ticket, stream
    [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    source="klt_tpu_torch/csrc/replace.cu",
    replaces="klt_tpu/ops/replace.py:95")

LK_LEVEL_BATCHED = Kernel(
    "klt_lk_level_batched",
    # stack1, stack2, batch, rows, cols, x1, y1, x2, y2, active,
    # features per sequence, window w/h, min_displacement,
    # min_determinant, step_factor, max_iterations, lighting,
    # want_residue, x2_out, y2_out, status, iters, residue, stream
    [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
     _I, _I, _F, _F, _F, _I, _I, _I,
     _P, _P, _P, _P, _P, _P],
    source="klt_tpu_torch/csrc/lk_level.cu",
    replaces="klt_tpu/pallas/lk.py:60")

# The whole coarse-to-fine loop of a frame pair in one launch: kernel B
# (one sequence) and kernel C (B sequences) with the level loop that
# klt_tpu leaves to XLA around its kernels.
_LK_CFG = [_I, _I, _F, _F, _F, _I, _I]  # window w/h, min_displacement,
#                      min_determinant, step_factor, max_iterations, lighting
_LK_FRAME = [_F] * 6   # subsampling, max_residue, border x/y, limit x/y

LK_PYRAMID = Kernel(
    "klt_lk_pyramid",
    # per-level host arrays: stacks1, stacks2 (device pointers), rows,
    # cols; nlev, x, y, val, n, the level and frame constants,
    # x_out, y_out, val_out, stream
    [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
     ctypes.POINTER(_I), _I, _P, _P, _P, _I] + _LK_CFG + _LK_FRAME +
    [_P, _P, _P, _P],
    source="klt_tpu_torch/csrc/lk_level.cu",
    replaces="klt_tpu/pallas/lk2.py:55")

LK_PYRAMID_BATCHED = Kernel(
    "klt_lk_pyramid_batched",
    # per-level host arrays: stacks1, stacks2, stride1, stride2 (floats
    # from one sequence to the next), rows, cols; nlev, batch, x, y, val,
    # features per sequence, the level and frame constants,
    # x_out, y_out, val_out, stream
    [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_LL),
     ctypes.POINTER(_LL), ctypes.POINTER(_I), ctypes.POINTER(_I), _I, _I,
     _P, _P, _P, _I] + _LK_CFG + _LK_FRAME + [_P, _P, _P, _P],
    source="klt_tpu_torch/csrc/lk_level.cu",
    replaces="klt_tpu/pallas/lk.py:60")

# Kernel F, not a TPU kernel either: klt_tpu runs the Gauss-Newton loop of
# the affine consistency check as XLA only.
AFFINE_TRACK = Kernel(
    "klt_affine_track",
    # patches, stack2, sequences, rows, cols, x1, y1, x2, y2, axx, ayx,
    # axy, ayy, active, n, mode, window w/h, max_iterations,
    # min_displacement, affine_min_displacement, max_displacement_differ,
    # max_residue, step_factor, min_determinant, x2, y2, axx, ayx, axy,
    # ayy out, status, iters, stream
    [_P, _P, _I, _I, _I] + [_P] * 9 + [_I] * 5 + [_F] * 6 + [_P] * 9,
    source="klt_tpu_torch/csrc/affine.cu",
    replaces="klt_tpu/ops/affine.py:235")

# Kernel F with the tracker's step around it: which lanes save a patch,
# which are verified, and the state's update, all in the one launch.
AFFINE_STEP = Kernel(
    "klt_affine_step",
    # patches, stack1, stack2, sequences, rows, cols, valid, patch centre
    # x/y, axx, ayx, axy, ayy (the state, in place), x_old, y_old, xn, yn,
    # vn, n, mode, window w/h, max_iterations, the six constants of
    # klt_affine_track, x, y, val out, iters, stream
    [_P, _P, _P, _I, _I, _I] + [_P] * 12 + [_I] * 5 + [_F] * 6 + [_P] * 5,
    source="klt_tpu_torch/csrc/affine.cu",
    replaces="klt_tpu/ops/affine.py:860")

# Kernel R's tie entry: the pick loop of klt_tpu's exact replacement, which
# also reports whether a pick's maximum was not unique.
REPLACE_LOST_TIE = Kernel(
    "klt_replace_lost_tie",
    # klt_replace_lost's arguments (scratch with a third int a tile), then
    # the tie flag, stream
    [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    source="klt_tpu_torch/csrc/replace.cu",
    replaces="klt_tpu/ops/replace_exact.py:186")

# The bit-exact tier (csrc/exact.cu), none of it a TPU kernel: klt_tpu runs
# it as XLA only; its pyramid is kernel A's.  H2: the C-order
# min-eigenvalue response, tiled in shared memory.
EXACT_RESPONSE = Kernel(
    "klt_exact_response",
    # gradx, grady, rows, cols, window w/h, out, stream
    [_P, _P, _I, _I, _I, _I, _P, _P],
    source="klt_tpu_torch/csrc/exact.cu",
    replaces="klt_tpu/ops/replace_exact.py:143")

# H2 for a window that no tile holds: a thread per pixel.
EXACT_RESPONSE_GLOBAL = Kernel(
    "klt_exact_response_global",
    # gradx, grady, rows, cols, window w/h, out, stream
    [_P, _P, _I, _I, _I, _I, _P, _P],
    source="klt_tpu_torch/csrc/exact.cu",
    replaces="klt_tpu/ops/replace_exact.py:143")

# G: the C-order LK walk of a frame pair, a warp per feature, each window
# sum one chain in the C order.
EXACT_TRACK = Kernel(
    "klt_exact_track",
    # per-level host arrays: stacks1, stacks2 (device pointers), rows,
    # cols; nlev, x, y, val, n, win, max_iterations, check_residue, the
    # f32 constants (subsampling, min_determinant, min_displacement,
    # step_factor, max_residue, border x0/x1/y0/y1), x, y, val out, stream
    [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
     ctypes.POINTER(_I), _I, _P, _P, _P, _I, _I, _I, _I] + [_F] * 9 +
    [_P, _P, _P, _P],
    source="klt_tpu_torch/csrc/exact.cu",
    replaces="klt_tpu/ops/lk_exact.py:215")

# S: the candidate list of a selection, and the lazy quicksort's large
# partitions of it in one cooperative launch (csrc/select_sort.cu).  Not
# TPU kernels: klt_tpu builds and sorts the list on the host.
SELECT_LIST = Kernel(
    "klt_select_list",
    # resp, row stride, grid columns / rows, borderx, bordery, step, out,
    # state, cap, stream
    [_P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    source="klt_tpu_torch/csrc/select_sort.cu",
    replaces="klt_tpu_torch/native/lazy_select.c::klt_candidate_list")

SELECT_PARTITIONS = Kernel(
    "klt_select_partitions",
    # rows, n, state, k0, s_min, rounds, scratch, scratch ints, stream
    [_P, _LL, _P, _I, _I, _I, _P, _LL, _P],
    source="klt_tpu_torch/csrc/select_sort.cu",
    replaces="klt_tpu_torch/native/lazy_select.c::klt_lazy_sort_begin")

KERNELS = (PYRAMID, LK_LEVEL, CORNER_RESPONSE, PYRAMID_BATCHED, REPLACE_LOST,
           LK_LEVEL_BATCHED, LK_PYRAMID, LK_PYRAMID_BATCHED,
           CORNER_RESPONSE_GLOBAL, AFFINE_TRACK, AFFINE_STEP,
           REPLACE_LOST_TIE, EXACT_RESPONSE, EXACT_TRACK,
           EXACT_RESPONSE_GLOBAL, SELECT_LIST, SELECT_PARTITIONS)

# The side of kernel R's tiles and the most tiles its map may have (kTile
# and kMaxTiles of csrc/replace.cu; the library returns both).
REPLACE_TILE = 32
REPLACE_MAX_TILES = 25000

# The most cells of an affine window kernel F takes (KLT_AFFINE_MAX_CELLS
# of csrc/affine.cu; the library's klt_affine_max_cells() returns it).
AFFINE_MAX_CELLS = 256

# The most pyramid levels kernel G takes (KLT_EXACT_MAX_LEVELS of
# csrc/lk_exact_lane.h; the library's klt_exact_max_levels() returns it).
EXACT_MAX_LEVELS = 8

# The most pyramid levels a pyramid entry takes (KLT_MAX_LEVELS of
# csrc/lk_level.cu; the library's klt_lk_max_levels() returns it).
LK_MAX_LEVELS = 8


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> tuple[int, ...]:
    """Every kernel's count, in the order of KERNELS."""
    return tuple(k.launches for k in KERNELS)


def take_launches(before: tuple[int, ...]) -> tuple[int, ...]:
    """The launches each kernel counted since `before` (launch_counts()),
    taken off its count again: a stream capture calls the C entries but
    runs nothing on the card (cuda/graph.py credits them per replay)."""
    taken = tuple(k.launches - b for k, b in zip(KERNELS, before))
    for k, b in zip(KERNELS, before):
        k.launches = b
    return taken


def credit_launches(launches: tuple[int, ...]) -> None:
    """Add a replayed graph's launches (take_launches) to the counts."""
    for k, n in zip(KERNELS, launches):
        k.launches += n


def check_cuda_tensor(t, name: str, dtype, ndim: int) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype and rank."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
