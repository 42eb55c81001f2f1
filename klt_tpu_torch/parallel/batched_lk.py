"""Batched multi-sequence LK tracking (klt_tpu's parallel/batched_lk.py).

B independent sequences advance one frame pair per step as a dense
[B, H, W] batch: one batched-pyramid launch (kernel E) builds the B
frames' finest-first [B, 3, H_l, W_l] stacks, and one LK launch per level
(kernel C) tracks all B * N features, each lane reading its own
sequence's planes.  Each step's stacks stay on the device as the next
step's first stacks.  This is the throughput path for many streams on one
card (multi-camera rigs, fleets of dashcams, farms of traffic cameras):
a step costs the launches of one sequence's step.

klt_tpu's channel-packed [B, H, 3W] stacks, flattened patch extraction,
canvas carry, stall compaction and feature-block padding answer the TPU's
VMEM patch residency and have no counterpart here.  `plain=True` runs the
plain torch versions of both kernels on any device (the reference the
kernels are held against).
"""

from __future__ import annotations

import torch

from ..config import TrackingConfig
from ..ops.lk import track_features_pyramid_stacks
from ..ops.pyramid import (build_pyramid_stacks_batched,
                           build_pyramid_stacks_batched_plain)
from ..runtime.pipeline import _run


def _build(plain: bool):
    return (build_pyramid_stacks_batched_plain if plain
            else build_pyramid_stacks_batched)


def track_features_pyramid_batched(sps1, sps2, x, y, val,
                                   cfg: TrackingConfig, plain: bool = False):
    """Coarse-to-fine tracking of B sequences between two batched
    pyramids.

    sps1/sps2: finest-first lists of [B, 3, H_l, W_l] stacks; x, y f32
    [B, N]; val i32 [B, N] (lanes with val < 0 pass through).  Returns
    (x, y, val) of [B, N], each lane classified as
    `ops.lk.track_features_pyramid_stacks` classifies it in its sequence
    alone.
    """
    if sps1[0].dim() != 4 or x.dim() != 2:
        raise ValueError(f"batched stacks [B, 3, H, W] and features [B, N] "
                         f"expected, got {tuple(sps1[0].shape)} and "
                         f"{tuple(x.shape)}")
    return track_features_pyramid_stacks(sps1, sps2, x, y, val, cfg,
                                         plain=plain)


def make_fused_pair_step(cfg: TrackingConfig, plain: bool = False):
    """Batched frame-pair step with one LK launch per level.

    step(img1 [B, H, W] u8/f32, img2, x [B, N], y, val) -> (x, y, val).
    Both frames' pyramids come from one batched-pyramid launch of 2B
    images.
    """
    build = _build(plain)

    def step(img1, img2, x, y, val):
        if img1.shape != img2.shape or img1.dim() != 3:
            raise ValueError(f"frame batches must both be [B, H, W], got "
                             f"{tuple(img1.shape)} and {tuple(img2.shape)}")
        b = img1.shape[0]
        stacks = build(torch.cat([img1, img2]), cfg)
        return track_features_pyramid_batched(
            [s[:b] for s in stacks], [s[b:] for s in stacks], x, y, val,
            cfg, plain)

    return step


def track_sequences_batched(frames: torch.Tensor, x: torch.Tensor,
                            y: torch.Tensor, val: torch.Tensor,
                            cfg: TrackingConfig, plain: bool = False,
                            precomp: bool = False):
    """Track B sequences through T frames.

    frames: uint8/f32 [B, T, H, W]; x, y f32 [B, N]; val i32 [B, N], all
    on one device.  Returns (xs, ys, vals) of shape [T-1, B, N]: the state
    after tracking into each frame t (t = 1..T-1).  Lane (b, n) equals
    `runtime.pipeline.track_sequence` on sequence b alone.

    Per step one batched-pyramid launch for the B new frames and one LK
    launch for all B * N features, with the stacks kept on the device as
    the next step's first stacks; on the card as replays of CUDA graphs of
    chunks of steps.  precomp=True builds the stacks of several steps in
    one launch (about PRECOMP_FRAMES images, klt_tpu's
    KLT_TPU_PRECOMP_PYR=1), with results bit-equal to the default's.
    """
    _check_batched(frames, x)
    return _run(frames, x, y, val, cfg, plain, precomp, batched=True)


def _check_batched(frames: torch.Tensor, x: torch.Tensor) -> None:
    if frames.dim() != 4:
        raise ValueError(f"frames must be [B, T, H, W], got "
                         f"{tuple(frames.shape)}")
    if x.dim() != 2 or x.shape[0] != frames.shape[0]:
        raise ValueError(f"features must be [B={frames.shape[0]}, N], got "
                         f"{tuple(x.shape)}")
