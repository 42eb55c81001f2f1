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
from ..runtime.pipeline import _run
from .batched_lk import _check_batched


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
