"""Wrappers of kernel F (csrc/affine.cu, a warp per feature).

`track_affine_cuda`, the track entry: the Gauss-Newton loop of the affine
consistency check on given patches.  Its plain torch version is
`ops.affine.track_affine_plain`, with the same contract.

`affine_step_cuda_`, the step entry: the tracker's whole consistency step
in one launch (the save of the reference patches of the features tracked
for the first time, the verification of the others), the per-feature state
updated in place.  Its plain version is
`ops.affine.affine_consistency_step_plain`.

Both take one sequence's level-0 stack [3, H, W] or the stacks of B
sequences [B, 3, H, W], whose lanes are flattened sequence-major: lane l
reads sequence l // (N / B) (the batched affine check).

The wrappers raise on what the kernel does not take (CPU tensors, mixed
devices, wrong dtypes, shapes or strides, a window of more than
AFFINE_MAX_CELLS cells), launch on the current stream, check the launch
and never synchronise; they never fall back to the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import TrackingConfig
from ..ops.affine import stack_sequences
from . import AFFINE_MAX_CELLS, AFFINE_STEP, AFFINE_TRACK, check_cuda_tensor


@functools.lru_cache(maxsize=64)
def _constants(cfg: TrackingConfig) -> tuple:
    """The kernel's constants, as the f32 values the plain version uses."""
    f32 = lambda v: float(np.float32(v))
    return (cfg.affine_consistency_check, cfg.affine_window_width,
            cfg.affine_window_height, cfg.affine_max_iterations,
            f32(cfg.min_displacement), f32(cfg.affine_min_displacement),
            f32(cfg.affine_max_displacement_differ),
            f32(cfg.affine_max_residue), f32(cfg.step_factor),
            f32(cfg.min_determinant))


def track_affine_cuda(patches, stack2, x1, y1, x2_in, y2_in, a_in, active,
                      cfg: TrackingConfig):
    """Kernel F, one launch: contract of `ops.affine.track_affine_plain`
    on CUDA tensors: patches f32 [3, N, ph, pw], stack2 f32 [3, H, W] or
    [B, 3, H, W] (lane l of sequence l // (N / B)), the
    lanes' x1, y1, x2_in, y2_in and a_in = (axx, ayx, axy, ayy) f32 [N],
    active bool [N].  Returns (x2, y2, (axx, ayx, axy, ayy), status,
    iters)."""
    mode, aw, ah = cfg.affine_consistency_check, cfg.affine_window_width, \
        cfg.affine_window_height
    if mode not in (0, 1, 2):
        raise ValueError(f"affine_consistency_check must be 0, 1 or 2, got "
                         f"{mode}")
    if aw * ah > AFFINE_MAX_CELLS:
        raise ValueError(f"a {aw}x{ah} affine window has more than the "
                         f"{AFFINE_MAX_CELLS} cells kernel F takes")
    check_cuda_tensor(patches, "patches", torch.float32, 4)
    check_cuda_tensor(stack2, "stack2", torch.float32, stack2.dim())
    n = x1.shape[0]
    nseq = stack_sequences(stack2, n)
    if tuple(patches.shape) != (3, n, ah + 2, aw + 2):
        raise ValueError(f"patches must be [3, {n}, {ah + 2}, {aw + 2}], "
                         f"got {tuple(patches.shape)}")
    rows, cols = stack2.shape[-2:]
    if rows < ah + 2 or cols < aw + 2:
        raise ValueError(f"stack2 must be at least {aw + 2}x{ah + 2}, got "
                         f"{tuple(stack2.shape)}")
    lanes = [("x1", x1), ("y1", y1), ("x2_in", x2_in), ("y2_in", y2_in),
             ("axx", a_in[0]), ("ayx", a_in[1]), ("axy", a_in[2]),
             ("ayy", a_in[3])]
    for name, t in lanes:
        check_cuda_tensor(t, name, torch.float32, 1)
    check_cuda_tensor(active, "active", torch.bool, 1)
    tensors = [t for _, t in lanes] + [active]
    if any(t.shape[0] != n for t in tensors):
        raise ValueError("the lanes' tensors must all be [N]")
    dev = patches.device
    if any(t.device != dev for t in [stack2] + tensors):
        raise ValueError("inputs lie on several devices")

    outs = [torch.empty_like(x2_in) for _ in range(6)]
    status = torch.empty(n, dtype=torch.int32, device=dev)
    iters = torch.empty(n, dtype=torch.int32, device=dev)
    result = (outs[0], outs[1], tuple(outs[2:]), status, iters)
    if n == 0:
        return result
    # a bool tensor is one byte a lane, 0 or 1: read as u8
    with torch.cuda.device(dev):
        AFFINE_TRACK(patches.data_ptr(), stack2.data_ptr(), nseq, rows, cols,
                     *[t.data_ptr() for t in tensors], n, *_constants(cfg),
                     *[t.data_ptr() for t in outs], status.data_ptr(),
                     iters.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    return result


def affine_step_cuda_(state, stack1, stack2, x_old, y_old, xn, yn, vn,
                      cfg: TrackingConfig):
    """Kernel F's step entry, one launch: contract of
    `ops.affine.affine_consistency_step` on CUDA tensors.  state: an
    `ops.affine.AffineState` whose tensors are updated IN PLACE; stack1,
    stack2 f32 [3, H, W], or [B, 3, H, W] with lane l of sequence
    l // (N / B); x_old, y_old, xn, yn f32 [N]; vn i32 [N].  Returns
    (x, y, val, iters)."""
    mode, aw, ah = cfg.affine_consistency_check, cfg.affine_window_width, \
        cfg.affine_window_height
    if mode not in (0, 1, 2):
        raise ValueError(f"affine_consistency_check must be 0, 1 or 2, got "
                         f"{mode}")
    if aw * ah > AFFINE_MAX_CELLS:
        raise ValueError(f"a {aw}x{ah} affine window has more than the "
                         f"{AFFINE_MAX_CELLS} cells kernel F takes")
    n = xn.shape[0]
    f32, dev = torch.float32, xn.device
    patches = state.patches
    lanes = (state.x, state.y, state.axx, state.ayx, state.axy, state.ayy,
             x_old, y_old, xn, yn)
    if patches.dtype is not f32 or \
            tuple(patches.shape) != (3, n, ah + 2, aw + 2) or \
            not patches.is_contiguous():
        raise ValueError(f"state.patches must be contiguous f32 "
                         f"[3, {n}, {ah + 2}, {aw + 2}], got "
                         f"{tuple(patches.shape)}")
    rows, cols = stack2.shape[-2:]
    nseq = stack_sequences(stack2, n)
    for name, st in (("stack1", stack1), ("stack2", stack2)):
        if st.dtype is not f32 or st.shape != stack2.shape or \
                not st.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 of stack2's "
                             f"shape {tuple(stack2.shape)}, got "
                             f"{tuple(st.shape)}")
    if rows < ah + 2 or cols < aw + 2:
        raise ValueError(f"a {cols}x{rows} frame is smaller than the "
                         f"{aw + 2}x{ah + 2} patch")
    if any(t.dtype is not f32 or t.shape != (n,) or not t.is_contiguous()
           for t in lanes):
        raise ValueError("the state's and the lanes' tensors must be "
                         "contiguous f32 [N]")
    if state.valid.dtype is not torch.bool or state.valid.shape != (n,) or \
            vn.dtype is not torch.int32 or vn.shape != (n,) or \
            not vn.is_contiguous() or not state.valid.is_contiguous():
        raise ValueError("state.valid must be bool [N] and vn int32 [N]")
    if not xn.is_cuda or any(t.device != dev for t in
                             (patches, stack1, stack2, state.valid, vn,
                              *lanes)):
        raise ValueError("the state, the stacks and the lanes must lie on "
                         "one CUDA device")
    outs = (torch.empty_like(xn), torch.empty_like(yn), torch.empty_like(vn),
            torch.empty_like(vn))
    if n == 0:
        return outs
    consts = _constants(cfg)
    with torch.cuda.device(dev):
        AFFINE_STEP(patches.data_ptr(), stack1.data_ptr(), stack2.data_ptr(),
                    nseq, rows, cols, state.valid.data_ptr(),
                    *[t.data_ptr() for t in lanes], vn.data_ptr(), n,
                    *consts, *[t.data_ptr() for t in outs],
                    torch.cuda.current_stream(dev).cuda_stream)
    return outs
