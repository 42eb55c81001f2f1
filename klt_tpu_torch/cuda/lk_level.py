"""Wrappers of kernels B and C (csrc/lk_level.cu, a warp per feature).

Level entries, the counterparts of klt_tpu/pallas/lk2.py (B) and
klt_tpu/pallas/lk.py (C): `lk_level_cuda` and `lk_level_batched_cuda` run
the Newton loop of one pyramid level, for one sequence or for B sequences
in one launch.  Their plain torch versions are `ops.lk.lk_level_plain` and
`ops.lk.lk_level_batched_plain`, with the same contract:
(x2, y2, status, iters, residue), each [F] (B) or [B, F] (C).

Pyramid entries: `lk_pyramid_cuda` and `lk_pyramid_batched_cuda` run a
whole frame pair in one launch: the division chain, every level's Newton
loop, the status checks after each level and the final border
classification, everything `ops.lk.track_features_pyramid_levels` (their
plain version) does with one level launch and some forty torch launches
per level.  Contract: (x, y, val) in, (x_new, y_new, val_new) out, [N] or
[B, N].  On this card LK is bound by latency, the dependent Newton chain
and the launches around it, not by bytes or operations; a warp per
feature shortens the chain and the pyramid entries leave one launch.

Every wrapper raises on what its kernel does not take (CPU tensors, mixed
devices, wrong dtypes, shapes or strides, more than LK_MAX_LEVELS levels),
launches on the current stream, checks the launch and never synchronises.
The kernels sum a window in the order `ops.lk._window_sum` documents.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import TrackingConfig
from . import (LK_LEVEL, LK_LEVEL_BATCHED, LK_MAX_LEVELS, LK_PYRAMID,
               LK_PYRAMID_BATCHED, check_cuda_tensor)


def _check_level(stack1, stack2, x1, y1, x2, y2, active,
                 cfg: TrackingConfig, batched: bool):
    """Raise unless the inputs fit kernel B (batched=False: stacks
    [3, H, W], lanes [F]) or C (stacks [B, 3, H, W], lanes [B, F])."""
    sdim, ldim = (4, 2) if batched else (3, 1)
    check_cuda_tensor(stack1, "stack1", torch.float32, sdim)
    check_cuda_tensor(stack2, "stack2", torch.float32, sdim)
    want = "[B, 3, H, W]" if batched else "[3, H, W]"
    if stack1.shape != stack2.shape or stack1.shape[-3] != 3:
        raise ValueError(f"stacks must both be {want}, got "
                         f"{tuple(stack1.shape)} and {tuple(stack2.shape)}")
    check_cuda_tensor(x1, "x1", torch.float32, ldim)
    lanes = tuple(x1.shape)
    if batched and lanes[0] != stack1.shape[0]:
        raise ValueError(f"x1 has {lanes[0]} sequences, the stacks "
                         f"{stack1.shape[0]}")
    for name, t in (("y1", y1), ("x2", x2), ("y2", y2)):
        check_cuda_tensor(t, name, torch.float32, ldim)
        if tuple(t.shape) != lanes:
            raise ValueError(f"{name} has features of shape "
                             f"{tuple(t.shape)}, not {lanes}")
    check_cuda_tensor(active, "active", torch.bool, ldim)
    if tuple(active.shape) != lanes:
        raise ValueError(f"active has features of shape "
                         f"{tuple(active.shape)}, not {lanes}")
    devs = {t.device for t in (stack1, stack2, x1, y1, x2, y2, active)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    rows, cols = stack1.shape[-2:]
    w, h = cfg.window_width, cfg.window_height
    if rows < h + 1 or cols < w + 1:
        raise ValueError(f"a {cols}x{rows} level is smaller than the "
                         f"{w}x{h} window plus one")


def _launch(kernel, lead: tuple, n: int, stack1, stack2, x1, y1, x2, y2,
            active, cfg: TrackingConfig, want_residue: bool):
    """Launch `kernel` with its leading shape arguments `lead` (before
    the lanes) and n features per sequence (after them)."""
    dev = stack1.device
    x2o = torch.empty_like(x2)
    y2o = torch.empty_like(y2)
    status = torch.empty(x2.shape, dtype=torch.int32, device=dev)
    iters = torch.empty(x2.shape, dtype=torch.int32, device=dev)
    residue = torch.empty_like(x2)
    if x2.numel() == 0:
        return x2o, y2o, status, iters, residue
    act = active.to(torch.uint8)
    f32 = lambda v: float(np.float32(v))
    with torch.cuda.device(dev):
        kernel(stack1.data_ptr(), stack2.data_ptr(), *lead,
               x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
               act.data_ptr(), n,
               cfg.window_width, cfg.window_height,
               f32(cfg.min_displacement), f32(cfg.min_determinant),
               f32(cfg.step_factor), cfg.max_iterations,
               int(cfg.lighting_insensitive), int(want_residue),
               x2o.data_ptr(), y2o.data_ptr(), status.data_ptr(),
               iters.data_ptr(), residue.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    return x2o, y2o, status, iters, residue


def lk_level_cuda(stack1, stack2, x1, y1, x2, y2, active,
                  cfg: TrackingConfig, want_residue: bool = True):
    """Kernel B: stacks [3, H, W], lanes [F]."""
    _check_level(stack1, stack2, x1, y1, x2, y2, active, cfg, batched=False)
    _, rows, cols = stack1.shape
    return _launch(LK_LEVEL, (rows, cols), x1.shape[0], stack1, stack2,
                   x1, y1, x2, y2, active, cfg, want_residue)


def lk_level_batched_cuda(stack1, stack2, x1, y1, x2, y2, active,
                          cfg: TrackingConfig, want_residue: bool = True):
    """Kernel C: stacks [B, 3, H, W], lanes [B, F]; one launch for all
    B * F lanes."""
    _check_level(stack1, stack2, x1, y1, x2, y2, active, cfg, batched=True)
    b, _, rows, cols = stack1.shape
    return _launch(LK_LEVEL_BATCHED, (b, rows, cols), x1.shape[1],
                   stack1, stack2, x1, y1, x2, y2, active, cfg, want_residue)


def _check_pyramid(stacks1, stacks2, x, y, val, cfg: TrackingConfig,
                   batched: bool) -> None:
    """Raise unless the inputs fit a pyramid entry: finest-first level
    stacks [3, H_l, W_l] with lanes [N] (batched=False), or
    [B, 3, H_l, W_l] with lanes [B, N]; each sequence's [3, H_l, W_l]
    contiguous; everything on one CUDA device.  Written for the hot
    path: few tensor attribute reads per call."""
    nlev = cfg.n_pyramid_levels
    if len(stacks1) != nlev or len(stacks2) != nlev:
        raise ValueError("stacks must hold n_pyramid_levels levels")
    if nlev > LK_MAX_LEVELS:
        raise ValueError(f"{nlev} pyramid levels: the LK pyramid kernels "
                         f"take at most {LK_MAX_LEVELS}")
    sdim = 4 if batched else 3
    f32 = torch.float32
    lanes = x.shape
    lead = lanes[:-1]
    dev = x.get_device()
    for r in range(nlev):
        a, b = stacks1[r], stacks2[r]
        if a.dtype is not f32 or b.dtype is not f32:
            raise ValueError(f"level {r} stacks must be float32 tensors")
        sa = a.shape
        if len(sa) != sdim or b.shape != sa or sa[-3] != 3 or \
                sa[:-3] != lead:
            want = "[B, 3, H, W]" if batched else "[3, H, W]"
            if len(sa) == sdim and b.shape == sa and sa[-3] == 3:
                raise ValueError(f"stacks {tuple(sa)} do not fit features "
                                 f"{tuple(lanes)}")
            raise ValueError(f"level {r} stacks must both be {want}, got "
                             f"{tuple(sa)} and {tuple(b.shape)}")
        inner = (sa[-2] * sa[-1], sa[-1], 1)
        if a.stride()[-3:] != inner or b.stride()[-3:] != inner:
            raise ValueError(f"level {r} stacks must be contiguous in "
                             f"their [3, H, W]")
        if a.get_device() != dev or b.get_device() != dev:
            dev = None
    for name, t, dtype in (("x", x, f32), ("y", y, f32),
                           ("val", val, torch.int32)):
        if t.dtype is not dtype:
            raise ValueError(f"{name} must be a {dtype} tensor")
        if t.shape != lanes:
            raise ValueError(f"{name} has features of shape "
                             f"{tuple(t.shape)}, not {tuple(lanes)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.get_device() != dev:
            dev = None
    if not x.is_cuda:
        raise ValueError("stacks and features must be CUDA tensors")
    if dev is None:
        raise ValueError("stacks and features lie on several devices")


@functools.lru_cache(maxsize=64)
def _constants(cfg: TrackingConfig, rows0: int, cols0: int) -> tuple:
    """The level and frame constants of the pyramid entries, as the f32
    values the torch loop uses (ops/lk.py)."""
    f32 = lambda v: float(np.float32(v))
    bx, by = np.float32(cfg.borderx), np.float32(cfg.bordery)
    return (cfg.window_width, cfg.window_height, f32(cfg.min_displacement),
            f32(cfg.min_determinant), f32(cfg.step_factor),
            cfg.max_iterations, int(cfg.lighting_insensitive),
            f32(cfg.subsampling), f32(cfg.max_residue), float(bx), float(by),
            float(np.float32(cols0 - 1) - bx),
            float(np.float32(rows0 - 1) - by))


def _launch_pyramid(kernel, stacks1, stacks2, x, y, val,
                    cfg: TrackingConfig, batched: bool):
    nlev = len(stacks1)
    ptrs = ctypes.c_void_p * nlev
    ints = ctypes.c_int * nlev
    result = (torch.empty_like(x), torch.empty_like(y),
              torch.empty_like(val))
    if x.numel() == 0:
        return result
    rows0, cols0 = stacks1[0].shape[-2:]
    levels = [ptrs(*[s.data_ptr() for s in stacks1]),
              ptrs(*[s.data_ptr() for s in stacks2])]
    lead = [nlev]
    if batched:
        longs = ctypes.c_longlong * nlev
        levels += [longs(*[s.stride(0) for s in stacks1]),
                   longs(*[s.stride(0) for s in stacks2])]
        lead.append(x.shape[0])
    levels += [ints(*[s.shape[-2] for s in stacks1]),
               ints(*[s.shape[-1] for s in stacks1])]
    dev = x.device
    args = (*levels, *lead, x.data_ptr(), y.data_ptr(), val.data_ptr(),
            x.shape[-1], *_constants(cfg, rows0, cols0),
            *[t.data_ptr() for t in result])
    if dev.index == torch.cuda.current_device():
        kernel(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            kernel(*args, torch.cuda.current_stream(dev).cuda_stream)
    return result


def lk_pyramid_cuda(stacks1, stacks2, x, y, val, cfg: TrackingConfig):
    """Kernel B's pyramid entry: finest-first lists of [3, H_l, W_l]
    stacks of the two frames, x, y f32 [N], val i32 [N]; one launch.
    Returns (x_new, y_new, val_new)."""
    _check_pyramid(stacks1, stacks2, x, y, val, cfg, batched=False)
    return _launch_pyramid(LK_PYRAMID, stacks1, stacks2, x, y, val, cfg,
                           batched=False)


def lk_pyramid_batched_cuda(stacks1, stacks2, x, y, val,
                            cfg: TrackingConfig):
    """Kernel C's pyramid entry: finest-first lists of [B, 3, H_l, W_l]
    stacks (any stride between sequences), x, y f32 [B, N], val i32
    [B, N]; one launch for all B * N lanes.  Returns (x_new, y_new,
    val_new)."""
    _check_pyramid(stacks1, stacks2, x, y, val, cfg, batched=True)
    return _launch_pyramid(LK_PYRAMID_BATCHED, stacks1, stacks2, x, y, val,
                           cfg, batched=True)
