"""Carrying state across from the JAX package without importing it.

The tests hand the same configuration, pyramids, features and SLAM
problems (bundle adjustment, pose graph) to `klt_tpu` and to this port as
plain dicts and numpy arrays, for one sequence or for a batch of B.  klt_tpu's exact tier keeps a pyramid as
three tuples (imgs, gxs, gys) of [H_l, W_l] maps; the port as its usual
finest-first [3, H_l, W_l] stacks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import TrackingConfig
from .ops.affine import AffineState
from .slam.ba import BAProblem
from .slam.pose_graph import PoseGraph

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


def exact_pyramids_from_numpy(pyr, device="cpu") -> list[torch.Tensor]:
    """klt_tpu's exact pyramid (imgs, gxs, gys), tuples of [H_l, W_l]
    maps finest first, as the port's f32 [3, H_l, W_l] stacks on
    `device`."""
    imgs, gxs, gys = pyr
    if not len(imgs) == len(gxs) == len(gys):
        raise ValueError("imgs, gxs, gys hold different numbers of levels")
    return [torch.from_numpy(np.stack([np.asarray(a, np.float32)
                                       for a in level])).to(device)
            for level in zip(imgs, gxs, gys)]


def exact_pyramids_to_numpy(stacks) -> tuple:
    """The port's [3, H_l, W_l] stacks as klt_tpu's (imgs, gxs, gys)
    tuples of numpy maps."""
    planes = [s.cpu().numpy() for s in stacks]
    return tuple(tuple(p[c] for p in planes) for c in range(3))


def features_from_numpy(x, y, val, device="cpu"):
    """(x f32, y f32, val i32) tensors on `device`, in the shape given:
    one sequence's [N], or B sequences' [B, N] (klt_tpu's batched state,
    e.g. `pad_features_for_mesh` output)."""
    return (torch.from_numpy(np.array(x, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(y, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(val, dtype=np.int32)).to(device))


_AFFINE_FIELDS = ("valid", "img", "gradx", "grady", "x", "y", "axx", "ayx",
                  "axy", "ayy")


def affine_state_from_numpy(fields: dict, device="cpu") -> AffineState:
    """An AffineState on `device` from numpy arrays of the ten fields of
    klt_tpu's `AffineState` (valid bool [N]; img, gradx, grady f32
    [N, ph, pw]; x, y, axx, ayx, axy, ayy f32 [N])."""
    if set(fields) != set(_AFFINE_FIELDS):
        raise ValueError(f"expected the fields {_AFFINE_FIELDS}, got "
                         f"{sorted(fields)}")
    f32 = lambda name: torch.from_numpy(
        np.array(fields[name], dtype=np.float32)).to(device)
    return AffineState(
        valid=torch.from_numpy(np.array(fields["valid"], dtype=bool))
        .to(device),
        patches=torch.stack([f32("img"), f32("gradx"), f32("grady")]),
        **{k: f32(k) for k in ("x", "y", "axx", "ayx", "axy", "ayy")})


def affine_state_to_numpy(state: AffineState) -> dict:
    """The ten fields of klt_tpu's `AffineState` as numpy arrays."""
    return {k: getattr(state, k).cpu().numpy() for k in _AFFINE_FIELDS}


_BA_TENSORS = ("R", "t", "landmarks", "cam_idx", "lm_idx", "uv", "weight")
_BA_CONSTS = ("fx", "fy", "cx", "cy")
_PG_TENSORS = ("R", "t", "ei", "ej", "Rz", "tz", "weight")


def _tensor_of(a, device):
    a = np.array(a)
    dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
    return torch.from_numpy(a.astype(dtype)).to(device)


def ba_problem_from_numpy(fields: dict, device="cpu") -> BAProblem:
    """A BAProblem on `device` from numpy arrays (or jax
    arrays) and floats named as the fields of klt_tpu's `BAProblem`
    (`dataclasses.asdict` of one, or `vars`)."""
    if set(fields) != set(_BA_TENSORS + _BA_CONSTS):
        raise ValueError(f"expected the fields {_BA_TENSORS + _BA_CONSTS}, "
                         f"got {sorted(fields)}")
    return BAProblem(**{k: _tensor_of(fields[k], device)
                        for k in _BA_TENSORS},
                     **{k: float(fields[k]) for k in _BA_CONSTS})


def ba_problem_to_numpy(prob: BAProblem) -> dict:
    """The fields of a BAProblem as numpy arrays and floats, as klt_tpu's
    `BAProblem(**fields)` takes them."""
    return {k: getattr(prob, k).cpu().numpy() for k in _BA_TENSORS} | {
        k: float(getattr(prob, k)) for k in _BA_CONSTS}


def pose_graph_from_numpy(fields: dict, device="cpu") -> PoseGraph:
    """A PoseGraph on `device` from the seven arrays of
    klt_tpu's `PoseGraph`."""
    if set(fields) != set(_PG_TENSORS):
        raise ValueError(f"expected the fields {_PG_TENSORS}, got "
                         f"{sorted(fields)}")
    return PoseGraph(**{k: _tensor_of(fields[k], device)
                        for k in _PG_TENSORS})


def pose_graph_to_numpy(pg: PoseGraph) -> dict:
    """The fields of a PoseGraph as numpy arrays."""
    return {k: getattr(pg, k).cpu().numpy() for k in _PG_TENSORS}
