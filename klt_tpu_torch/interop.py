"""Carrying state across from the JAX package without importing it.

The tests hand the same configuration, pyramids and features to
`klt_tpu` and to this port as plain dicts and numpy arrays, for one
sequence or for a batch of B.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import TrackingConfig

# TrackingConfig fields that only steer klt_tpu's TPU kernels (re-anchor
# rounds of the VMEM patch canvas) and have no counterpart here.
_TPU_ONLY_FIELDS = frozenset({"reanchor_unroll"})


def config_from_fields(d: dict) -> TrackingConfig:
    """A TrackingConfig from `dataclasses.asdict` of a
    `klt_tpu.TrackingConfig` (derived fields included)."""
    names = {f.name for f in dataclasses.fields(TrackingConfig)}
    unknown = set(d) - names - _TPU_ONLY_FIELDS
    if unknown:
        raise ValueError(f"unknown TrackingConfig fields: {sorted(unknown)}")
    return TrackingConfig(**{k: v for k, v in d.items() if k in names})


def stacks_from_numpy(stacks, device="cpu") -> list[torch.Tensor]:
    """Finest-first f32 stacks on `device`, in the shape given: one
    frame's [3, H_l, W_l], or B sequences' [B, 3, H_l, W_l] (klt_tpu's
    `build_pyramid_stacks_batched`)."""
    return [torch.from_numpy(np.array(s, dtype=np.float32)).to(device)
            for s in stacks]


def features_from_numpy(x, y, val, device="cpu"):
    """(x f32, y f32, val i32) tensors on `device`, in the shape given:
    one sequence's [N], or B sequences' [B, N] (klt_tpu's batched state,
    e.g. `pad_features_for_mesh` output)."""
    return (torch.from_numpy(np.array(x, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(y, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(val, dtype=np.int32)).to(device))
