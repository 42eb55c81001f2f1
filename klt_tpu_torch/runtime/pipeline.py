"""Device-resident sequence tracker.

A Python frame loop over a [T, H, W] frame tensor: each frame's pyramid
is built on the frames' device and kept there as the next step's first
pyramid, so nothing but the per-frame feature tables is produced, and
with the CUDA kernels no step waits for the host.  Pyramid levels travel
as stacked [3, H_l, W_l] tensors, the pyramid kernel's output.

`plain=True` runs the plain torch versions of both kernels on any
device — the reference the kernels are held against on the card.
"""

from __future__ import annotations

import torch

from ..config import TrackingConfig
from ..ops.pyramid import build_pyramid_stacks, build_pyramid_stacks_plain
from ..ops.lk import track_features_pyramid_stacks


def track_sequence(frames: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   val: torch.Tensor, cfg: TrackingConfig,
                   plain: bool = False):
    """Track features through a whole sequence.

    frames: uint8/f32 [T, H, W]; x, y f32 [N]; val i32 [N], all on one
    device.  Returns (xs, ys, vals) of shape [T-1, N]: the state after
    tracking into each frame t (t = 1..T-1).
    """
    if frames.dim() != 3:
        raise ValueError(f"frames must be [T, H, W], got "
                         f"{tuple(frames.shape)}")
    build = build_pyramid_stacks_plain if plain else build_pyramid_stacks
    t_len, n = frames.shape[0], x.shape[0]
    xs = torch.empty((max(t_len - 1, 0), n), dtype=torch.float32,
                     device=frames.device)
    ys = torch.empty_like(xs)
    vals = torch.empty((max(t_len - 1, 0), n), dtype=torch.int32,
                       device=frames.device)
    st1 = build(frames[0], cfg)
    for t in range(1, t_len):
        st2 = build(frames[t], cfg)
        x, y, val = track_features_pyramid_stacks(st1, st2, x, y, val, cfg,
                                                  plain=plain)
        xs[t - 1], ys[t - 1], vals[t - 1] = x, y, val
        st1 = st2
    return xs, ys, vals


def track_pair_carry(pyr1_state, img2: torch.Tensor, feat,
                     cfg: TrackingConfig):
    """One frame-pair step with explicit device-resident pyramid carry
    (stacked-level state, as produced by prepare_pyramids).

    Returns ((x, y, val), pyr2_state): the building block for host-driven
    streaming (e.g. with lost-feature replacement between frames).
    """
    x, y, val = feat
    st2 = tuple(build_pyramid_stacks(img2, cfg))
    xn, yn, vn = track_features_pyramid_stacks(list(pyr1_state), list(st2),
                                               x, y, val, cfg)
    return (xn, yn, vn), st2


def prepare_pyramids(img: torch.Tensor, cfg: TrackingConfig):
    """Pyramid stacks of the first frame of a stream."""
    return tuple(build_pyramid_stacks(img, cfg))
