"""Batched small-matrix solves in plain tensor operations.

Counterpart of klt_tpu/utils/linalg.py: an unrolled Gauss-Jordan for
small symmetric positive-definite systems (diagonal pivots suffice;
mirrors the reference's Numerical-Recipes elimination,
src/V1/trackFeatures.c:546-602, including its zero-pivot detection) and a
closed-form adjugate inverse for 3x3.  Every operation is elementwise f32
in the order written here, which is the order the affine kernel
(csrc/affine.cu) keeps, so the two agree bit for bit.
"""

from __future__ import annotations

import torch


def gj_solve_spd(T: torch.Tensor, B: torch.Tensor):
    """Solve T X = B for batched small SPD T.

    T: [..., n, n]; B: [..., n, m].  Returns (X [..., n, m], small [...])
    with small=True where a diagonal pivot was exactly 0 (the pivot is
    then taken as 1).  Column by column: the pivot row divided by the
    pivot, its multiple subtracted from every row (the pivot row
    included), then the pivot row overwritten by the divided row."""
    n = T.shape[-1]
    A = torch.cat([T, B], dim=-1)
    small = torch.zeros(T.shape[:-2], dtype=torch.bool, device=T.device)
    for col in range(n):
        piv = A[..., col, col]
        zero = piv == 0.0
        small = small | zero
        piv_safe = torch.where(zero, torch.ones_like(piv), piv)
        arow = A[..., col, :] / piv_safe[..., None]
        A = A - A[..., :, col:col + 1] * arow[..., None, :]
        A[..., col, :] = arow
    return A[..., :, n:], small


def inv3(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det).

    M: [..., 3, 3].  Callers are expected to have damped M so det is
    bounded away from zero; `eps` adds a safety floor to |det|."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < eps,
                      torch.sign(det) * eps + (det == 0).to(det.dtype) * eps,
                      det)
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    adj = torch.stack([
        torch.stack([A, D, G], -1),
        torch.stack([B, E, H], -1),
        torch.stack([C, F, I], -1),
    ], -2)
    return adj / det[..., None, None]
