"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full power limit of 700 W), and the least time they allow
for a piece of work."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # f32 outside the tensor cores


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the f32 peak."""
    by, op = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS
    return (by, "bytes") if by >= op else (op, "operations")
