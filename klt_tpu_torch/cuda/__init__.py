"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

The sources in klt_tpu_torch/csrc/ are compiled by nvcc into one shared
library with a plain C interface, `build/klt_tpu_torch/libklt_kernels.so`,
at first use (and again whenever a source is newer than the library).
Each C entry enqueues its kernels on the stream it is given and returns
`cudaGetLastError()`; a `Kernel` raises when that is not cudaSuccess and
otherwise counts one launch, so a run can show which kernels its main
path went through.

No flag relaxes IEEE arithmetic: `/` and `sqrtf` stay correctly rounded,
and `-fmad=false` keeps every multiply and add separately rounded, in
the order the plain torch versions and the C reference use.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

import torch

from .._build import BUILD_DIR, compile_shared, is_stale, repo_path

SOURCES = [repo_path("klt_tpu_torch", "csrc", name)
           for name in ("pyramid.cu", "lk_level.cu")]
LIB = os.path.join(BUILD_DIR, "libklt_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
# What the last build printed (ptxas register/spill report) and took.
build_log = ""
build_seconds = None


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load libklt_kernels.so."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if is_stale(LIB, SOURCES):
            t0 = time.perf_counter()
            build_log = compile_shared([_nvcc()] + NVCC_FLAGS + SOURCES, LIB)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(LIB)
        lib.klt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.klt_cuda_error_string.restype = ctypes.c_char_p
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

    def __call__(self, *args) -> None:
        lib = load_library()
        rc = getattr(lib, self.symbol)(*args)
        if rc != 0:
            msg = lib.klt_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

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

KERNELS = (PYRAMID, LK_LEVEL)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


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
