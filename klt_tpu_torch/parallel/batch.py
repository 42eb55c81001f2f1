"""Multi-sequence batch tracking (klt_tpu's parallel/batch.py) on one card.

klt_tpu runs B independent sequences as a dense [B, H, W] batch sharded
over a device mesh's `data` axis.  The port runs them on one card through
the batched tier (parallel/batched_lk.py).  Mesh sharding is not ported
yet: a `mesh` argument raises NotImplementedError and is never ignored.
"""

from __future__ import annotations

import numpy as np

from ..config import TrackingConfig
from ..ops.lk import track_features_pyramid_stacks
from ..ops.pyramid import build_pyramid_stacks
from .batched_lk import make_fused_pair_step, track_sequences_batched


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh sharding is not ported: klt_tpu_torch runs on one card "
            "(ROADMAP queue 1, item 10: multi-device)")


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


def make_batch_step(cfg: TrackingConfig, mesh=None, data_axis: str = "data",
                    feat_axis: str | None = None):
    """Batched step over [B, ...] tensors: step(img1 [B, H, W], img2,
    x [B, N], y, val) -> (x, y, val), each lane equal to `make_pair_step`
    on its sequence.  `mesh` (with data_axis, feat_axis) is not ported and
    raises."""
    _refuse_mesh(mesh)
    return make_fused_pair_step(cfg)


def track_batch(frames, x, y, val, cfg: TrackingConfig, mesh=None,
                feat_axis: str | None = None):
    """Track B sequences through T frames.

    frames: uint8 [B, T, H, W]; x, y f32 [B, N]; val i32 [B, N].  Returns
    per-frame tables (xs, ys, vals) of shape [T-1, B, N], from
    `track_sequences_batched`.  `mesh` is not ported and raises.
    """
    _refuse_mesh(mesh)
    return track_sequences_batched(frames, x, y, val, cfg)


def pad_features_for_mesh(x, y, val, multiple: int):
    """Pad the feature axis (the last) of host arrays to a multiple of
    `multiple`.

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
