"""Multi-sequence batch tracking (klt_tpu's parallel/batch.py).

B independent sequences advance as a dense [B, H, W] batch through the
batched tier (parallel/batched_lk.py: kernels E and C).  With a mesh
(parallel/mesh.py::make_mesh, one rank per device) the sequences shard
over its `data` axis and, optionally, the features over `feat`: each rank
tracks its [B/data, N/feat] block and the blocks are gathered, so every
rank returns the global tensors.  Lanes are independent, so the result is
bit-equal to the run without a mesh.
"""

from __future__ import annotations

import numpy as np

from ..config import TrackingConfig
from ..ops.lk import track_features_pyramid_stacks
from ..ops.pyramid import build_pyramid_stacks
from .batched_lk import make_fused_pair_step, track_sequences_batched
from .mesh import block, gather


def make_pair_step(cfg: TrackingConfig):
    """Single-sequence frame-pair tracking step.

    step(img1 u8/f32 [H, W], img2, x [N], y [N], val [N]) -> (x, y, val)
    after tracking.
    """

    def step(img1, img2, x, y, val):
        return track_features_pyramid_stacks(build_pyramid_stacks(img1, cfg),
                                             build_pyramid_stacks(img2, cfg),
                                             x, y, val, cfg)

    return step


def _blocks(mesh, data_axis, feat_axis, b: int, n: int):
    return (block(mesh, data_axis, b, "sequences"),
            block(mesh, feat_axis, n, "features"))


def make_batch_step(cfg: TrackingConfig, mesh=None, data_axis: str = "data",
                    feat_axis: str | None = None):
    """Batched step over [B, ...] tensors: step(img1 [B, H, W], img2,
    x [B, N], y, val) -> (x, y, val), each lane equal to `make_pair_step`
    on its sequence.

    With a mesh, every rank passes the global tensors: the sequences split
    over `data_axis`, the features over `feat_axis` (None: not split),
    each rank steps its block and the blocks are gathered, so every rank
    returns the global [B, N] tensors.  B and N must split evenly."""
    step = make_fused_pair_step(cfg)
    if mesh is None:
        return step

    def sharded(img1, img2, x, y, val):
        rows, cols = _blocks(mesh, data_axis, feat_axis, img1.shape[0],
                             x.shape[-1])
        out = step(img1[rows], img2[rows], *(a[rows, cols].contiguous()
                                             for a in (x, y, val)))
        return tuple(gather(gather(o, mesh, feat_axis, 1), mesh, data_axis,
                            0) for o in out)

    return sharded


def track_batch(frames, x, y, val, cfg: TrackingConfig, mesh=None,
                feat_axis: str | None = None):
    """Track B sequences through T frames.

    frames: uint8 [B, T, H, W]; x, y f32 [B, N]; val i32 [B, N].  Returns
    per-frame tables (xs, ys, vals) of shape [T-1, B, N], from
    `track_sequences_batched`.  With a mesh, as `make_batch_step`: the
    sequences split over its "data" axis, the features over `feat_axis`,
    and every rank returns the global tables.
    """
    if mesh is None:
        return track_sequences_batched(frames, x, y, val, cfg)
    rows, cols = _blocks(mesh, "data", feat_axis, frames.shape[0],
                         x.shape[-1])
    out = track_sequences_batched(
        frames[rows].contiguous(),
        *(a[rows, cols].contiguous() for a in (x, y, val)), cfg)
    return tuple(gather(gather(o, mesh, feat_axis, 2), mesh, "data", 1)
                 for o in out)


def pad_features_for_mesh(x, y, val, multiple: int):
    """Pad the feature axis (the last) of host arrays to a multiple of
    `multiple` (the mesh's feat-axis size).

    Padded lanes carry x = y = 0 and val = -1 (dead), which every tracking
    op passes through, so results on the first n lanes are unchanged.
    Returns (x, y, val, n_orig) as numpy arrays (the inputs themselves
    when no padding is needed): slice outputs back with [..., :n_orig].
    """
    n = x.shape[-1]
    pad = (-n) % multiple
    if pad == 0:
        return x, y, val, n
    widths = [(0, 0)] * (np.ndim(x) - 1) + [(0, pad)]
    grow = lambda a, v: np.pad(np.asarray(a), widths, constant_values=v)
    return grow(x, 0.0), grow(y, 0.0), grow(val, -1), n
