"""Batched multi-sequence tracking with the affine consistency check
(klt_tpu's parallel/batched_affine.py).

B independent sequences advance one frame pair per step, as in
batched_lk.py: one batched-pyramid launch (kernel E) for the B new frames,
one launch of kernel C's pyramid entry for all B * N features; then one
launch of kernel F's step entry over the same B * N lanes, flattened
sequence-major ([B * N], lane l of sequence l // N), each lane reading the
level-0 planes of its own sequence in the [B, 3, H, W] stacks.  One
`AffineState` of B * N lanes carries the reference patches and maps.  On
the card the step loop runs as CUDA graphs of chunks of steps
(runtime/pipeline.py, cuda/graph.py).

This is the throughput point of the affine check: a step costs three
launches whatever B is, so B sequences share the host's cost of one.
klt_tpu's global compaction and repair predicates answer the TPU's lack of
gathers and have no counterpart here.  `plain=True` runs the plain torch
versions of the three kernels on any device.
"""

from __future__ import annotations

import torch

from ..config import TrackingConfig
from ..ops.affine import AffineState, affine_consistency_step
from ..runtime.pipeline import _run
from .batched_lk import (_check_batched, _step_stacks,
                         track_features_pyramid_batched)


def track_sequences_affine_batched(frames: torch.Tensor, x: torch.Tensor,
                                   y: torch.Tensor, val: torch.Tensor,
                                   cfg: TrackingConfig, plain: bool = False,
                                   precomp: bool = False):
    """Track B sequences through T frames with the affine consistency
    check after every step's translation track.

    frames: uint8/f32 [B, T, H, W]; x, y f32 [B, N]; val i32 [B, N], all
    on one device.  cfg.affine_consistency_check must be 0, 1 or 2.
    Returns (xs, ys, vals) of shape [T-1, B, N]; lane (b, n) equals
    `runtime.pipeline.track_sequence_affine` on sequence b alone.
    precomp=True builds the stacks of several steps in one launch, with
    results bit-equal to the default's.
    """
    _check_affine(cfg)
    _check_batched(frames, x)
    return _run(frames, x, y, val, cfg, plain, precomp, affine=True,
                batched=True)


def _check_affine(cfg: TrackingConfig) -> None:
    if cfg.affine_consistency_check not in (0, 1, 2):
        raise ValueError("track_sequences_affine_batched needs "
                         "affine_consistency_check 0, 1 or 2, got "
                         f"{cfg.affine_consistency_check}")


def _run_eager(frames: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               val: torch.Tensor, cfg: TrackingConfig, plain: bool = False,
               precomp: bool = False):
    """`track_sequences_affine_batched`'s step loop with the kernels
    called one step at a time, without graphs: what the graphs are held
    against on the card."""
    _check_affine(cfg)
    _check_batched(frames, x)
    b, t_len = frames.shape[:2]
    n = x.shape[1]
    shape = (max(t_len - 1, 0), b, n)
    xs = torch.empty(shape, dtype=torch.float32, device=frames.device)
    ys = torch.empty_like(xs)
    vals = torch.empty(shape, dtype=torch.int32, device=frames.device)
    if t_len == 0:
        return xs, ys, vals
    state = AffineState.create(b * n, cfg, frames.device)
    flat = lambda a: a.reshape(b * n)
    stacks = _step_stacks(frames, cfg, plain, precomp)
    st1 = next(stacks)
    for t, st2 in enumerate(stacks):
        xn, yn, vn = track_features_pyramid_batched(st1, st2, x, y, val, cfg,
                                                    plain)
        out = affine_consistency_step(state, st1[0], st2[0], flat(x),
                                      flat(y), flat(val), flat(xn), flat(yn),
                                      flat(vn), cfg, plain=plain)
        x, y, val = (a.reshape(b, n) for a in out)
        xs[t], ys[t], vals[t] = x, y, val
        st1 = st2
    return xs, ys, vals
