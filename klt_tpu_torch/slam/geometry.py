"""Batched SE(3) and pinhole-camera primitives (plain torch, f32).

Counterpart of klt_tpu/slam/geometry.py.  Everything is written for dense
batches: poses [P, 6] (axis-angle + translation twists), landmarks
[L, 3], observations indexed by dense int tensors.  The functions take
any leading batch shape and work under `torch.func.vmap` and
`torch.func.jacfwd`, which the solvers use for their Jacobians.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation.

    Taylor-guarded so that forward-mode derivatives at w = 0 are exact:
    both branches of every `where` stay finite there (a plain
    norm-and-divide gives NaN tangents at zero)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2s)
    K = skew(w)  # unnormalized
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def se3_exp(xi: torch.Tensor):
    """[..., 6] twist (omega, t) -> (R [..., 3, 3], t [..., 3]).

    Uses the first-order translation (the retraction only needs to be a
    chart around identity for Gauss-Newton refinement)."""
    return so3_exp(xi[..., :3]), xi[..., 3:]


def se3_apply(R: torch.Tensor, t: torch.Tensor,
              p: torch.Tensor) -> torch.Tensor:
    """Apply [..., 3, 3] + [..., 3] to points [..., 3]."""
    return (R @ p[..., None])[..., 0] + t


def project(p_cam: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pinhole projection of camera-frame points [..., 3] -> [..., 2]:
    u = fx * x / z + cx, v = fy * y / z + cy.  Written on [..., 1]
    slices: a Python float times a 0-dim tensor gets an f64 tangent under
    torch.func.jacfwd."""
    z = torch.clamp(p_cam[..., 2:3], min=_EPS)
    u = fx * p_cam[..., 0:1] / z + cx
    v = fy * p_cam[..., 1:2] / z + cy
    return torch.cat([u, v], -1)


def reproject(pose_xi, base_R, base_t, landmark, fx, fy, cx, cy):
    """Residual helper: world landmark -> pixel under pose = exp(xi)∘base.

    pose_xi [..., 6] local update; base_R/base_t the current pose
    estimate; landmark [..., 3]."""
    dR, dt = se3_exp(pose_xi)
    p = se3_apply(base_R, base_t, landmark)
    p = se3_apply(dR, dt, p)
    return project(p, fx, fy, cx, cy)
