"""Wrappers of the bit-exact tier's kernels (csrc/exact.cu): H2, the exact
response (a tiled entry, and a global-memory entry for a window no tile
holds); G, the exact LK walk of a frame pair.  The tier's pyramid is
kernel A's (cuda/pyramid.py).

The plain torch versions are `ops.replace_exact.exact_response_plain` and
`ops.lk_exact.track_features_exact_plain`.  Every wrapper takes CUDA
tensors only, allocates its outputs on the current stream of their device
and raises when the kernel does not take its inputs or fails to launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import TrackingConfig
from ..ops.lk_exact import check_exact_config, exact_constants
from . import (EXACT_MAX_LEVELS, EXACT_RESPONSE, EXACT_RESPONSE_GLOBAL,
               EXACT_TRACK, check_cuda_tensor, load_library)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=64)
def library_exact_tile_rows(window_width: int, window_height: int) -> int:
    """Output rows of kernel H2's tile for this window as the library
    chooses them, or 0: no tile holds it.
    `ops.replace_exact.exact_response_tile` is the same rule in Python,
    for the plain model of the tiling."""
    return load_library().klt_exact_response_tile(window_width,
                                                  window_height)


def exact_response_cuda(gx: torch.Tensor, gy: torch.Tensor,
                        window_width: int, window_height: int
                        ) -> torch.Tensor:
    """f32 [H, W] CUDA gradients -> f32 [H, W] exact response, one launch
    of kernel H2: the tiled entry, or the global-memory entry for a window
    that no tile holds."""
    tiled = library_exact_tile_rows(window_width, window_height)
    return _response(EXACT_RESPONSE if tiled else EXACT_RESPONSE_GLOBAL, gx,
                     gy, window_width, window_height)


def exact_response_global_cuda(gx: torch.Tensor, gy: torch.Tensor,
                               window_width: int, window_height: int
                               ) -> torch.Tensor:
    """Kernel H2's global-memory entry (a thread per pixel) for any
    window; the contract of `exact_response_cuda`."""
    return _response(EXACT_RESPONSE_GLOBAL, gx, gy, window_width,
                     window_height)


def _response(kernel, gx, gy, window_width: int, window_height: int):
    check_cuda_tensor(gx, "gx", torch.float32, 2)
    check_cuda_tensor(gy, "gy", torch.float32, 2)
    if gx.shape != gy.shape or gx.device != gy.device:
        raise ValueError(f"gx {tuple(gx.shape)} on {gx.device} and gy "
                         f"{tuple(gy.shape)} on {gy.device} differ")
    if window_width < 1 or window_height < 1:
        raise ValueError(f"window {window_width}x{window_height}")
    h, w = gx.shape
    out = torch.empty((h, w), dtype=torch.float32, device=gx.device)
    with torch.cuda.device(gx.device):
        kernel(gx.data_ptr(), gy.data_ptr(), h, w, window_width,
               window_height, out.data_ptr(), _stream(gx.device))
    return out


def track_exact_cuda(stacks1, stacks2, x: torch.Tensor, y: torch.Tensor,
                     val: torch.Tensor, cfg: TrackingConfig):
    """Kernel G: finest-first lists of [3, H_l, W_l] exact stacks of the
    two frames, x, y f32 [N], val i32 [N]; one launch.  Returns (x_new,
    y_new, val_new)."""
    check_exact_config(cfg)
    nlev = len(stacks1)
    if nlev != len(stacks2) or not 1 <= nlev <= EXACT_MAX_LEVELS:
        raise ValueError(f"{nlev} and {len(stacks2)} levels; kernel G takes "
                         f"1 to {EXACT_MAX_LEVELS} of each")
    for r, (a, b) in enumerate(zip(stacks1, stacks2)):
        check_cuda_tensor(a, f"stacks1[{r}]", torch.float32, 3)
        check_cuda_tensor(b, f"stacks2[{r}]", torch.float32, 3)
        if a.shape != b.shape or a.shape[0] != 3:
            raise ValueError(f"level {r} stacks must both be [3, H, W], got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
    check_cuda_tensor(x, "x", torch.float32, 1)
    check_cuda_tensor(y, "y", torch.float32, 1)
    check_cuda_tensor(val, "val", torch.int32, 1)
    n = x.shape[0]
    if y.shape[0] != n or val.shape[0] != n:
        raise ValueError(f"x, y, val hold {n}, {y.shape[0]}, "
                         f"{val.shape[0]} features")
    dev = x.device
    if any(t.device != dev for t in (y, val, *stacks1, *stacks2)):
        raise ValueError("stacks and features lie on several devices")
    rows0, cols0 = stacks1[0].shape[-2:]
    k = exact_constants(cfg, rows0, cols0)
    ptrs = ctypes.c_void_p * nlev
    ints = ctypes.c_int * nlev
    out = (torch.empty_like(x), torch.empty_like(y), torch.empty_like(val))
    with torch.cuda.device(dev):
        EXACT_TRACK(
            ptrs(*[s.data_ptr() for s in stacks1]),
            ptrs(*[s.data_ptr() for s in stacks2]),
            ints(*[s.shape[-2] for s in stacks1]),
            ints(*[s.shape[-1] for s in stacks1]), nlev, x.data_ptr(),
            y.data_ptr(), val.data_ptr(), n, k["win"], k["max_iterations"],
            k["check_residue"], k["subsampling"], k["min_determinant"],
            k["min_displacement"], k["step_factor"], k["max_residue"],
            k["border_x0"], k["border_x1"], k["border_y0"], k["border_y1"],
            *[t.data_ptr() for t in out], _stream(dev))
    return out
