"""Carrying state across from the JAX package without importing it.

The tests hand the same configuration, pyramids and features to
`klt_tpu` and to this port as plain dicts and numpy arrays.
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
    """Finest-first [3, H_l, W_l] f32 stacks on `device`."""
    return [torch.from_numpy(np.array(s, dtype=np.float32)).to(device)
            for s in stacks]


def features_from_numpy(x, y, val, device="cpu"):
    """(x f32 [N], y f32 [N], val i32 [N]) tensors on `device`."""
    return (torch.from_numpy(np.array(x, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(y, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(val, dtype=np.int32)).to(device))
