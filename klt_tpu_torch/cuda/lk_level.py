"""Wrappers of kernels B and C (csrc/lk_level.cu): the Newton loop of one
level, for one sequence (B) or for B sequences in one launch (C).

The plain torch versions are `ops.lk.lk_level_plain` and
`ops.lk.lk_level_batched_plain`; the contracts are the same:
(x2, y2, status, iters, residue), each [F] (B) or [B, F] (C).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TrackingConfig
from . import LK_LEVEL, LK_LEVEL_BATCHED, check_cuda_tensor


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
