"""Wrapper of kernel B (csrc/lk_level.cu): the Newton loop of one level.

The plain torch version is `ops.lk.lk_level_plain`; the contract is the
same: (x2, y2, status, iters, residue), each [F].
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TrackingConfig
from . import LK_LEVEL, check_cuda_tensor


def lk_level_cuda(stack1, stack2, x1, y1, x2, y2, active,
                  cfg: TrackingConfig, want_residue: bool = True):
    check_cuda_tensor(stack1, "stack1", torch.float32, 3)
    check_cuda_tensor(stack2, "stack2", torch.float32, 3)
    if stack1.shape != stack2.shape or stack1.shape[0] != 3:
        raise ValueError(f"stacks must both be [3, H, W], got "
                         f"{tuple(stack1.shape)} and {tuple(stack2.shape)}")
    check_cuda_tensor(x1, "x1", torch.float32, 1)
    n = x1.shape[0]
    for name, t in (("y1", y1), ("x2", x2), ("y2", y2)):
        check_cuda_tensor(t, name, torch.float32, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} features, not {n}")
    check_cuda_tensor(active, "active", torch.bool, 1)
    if active.shape[0] != n:
        raise ValueError(f"active has {active.shape[0]} features, not {n}")
    devs = {t.device for t in (stack1, stack2, x1, y1, x2, y2, active)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    _, rows, cols = stack1.shape
    w, h = cfg.window_width, cfg.window_height
    if rows < h + 1 or cols < w + 1:
        raise ValueError(f"a {cols}x{rows} level is smaller than the "
                         f"{w}x{h} window plus one")

    dev = stack1.device
    x2o = torch.empty_like(x2)
    y2o = torch.empty_like(y2)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    iters = torch.empty(n, dtype=torch.int32, device=dev)
    residue = torch.empty_like(x2)
    if n == 0:
        return x2o, y2o, status, iters, residue
    act = active.to(torch.uint8)
    f32 = lambda v: float(np.float32(v))
    with torch.cuda.device(dev):
        LK_LEVEL(stack1.data_ptr(), stack2.data_ptr(), rows, cols,
                 x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                 act.data_ptr(), n, w, h,
                 f32(cfg.min_displacement), f32(cfg.min_determinant),
                 f32(cfg.step_factor), cfg.max_iterations,
                 int(cfg.lighting_insensitive), int(want_residue),
                 x2o.data_ptr(), y2o.data_ptr(), status.data_ptr(),
                 iters.data_ptr(), residue.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    return x2o, y2o, status, iters, residue
