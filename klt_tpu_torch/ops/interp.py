"""Batched bilinear interpolation / window sampling.

The reference interpolates one scalar at a time (_interpolate,
src/V1/trackFeatures.c:31-57).  Here all N features sample their whole
window at once: coordinates are truncated toward zero (C `(int)` cast),
each feature reads one integer-aligned (height+1, width+1) patch, and the
bilinear blend runs as four shifted multiplies, in the same f32 order as
the LK kernels (csrc/lk_level.cu).  The lanes of B sequences sample the
[B, 3, H, W] stacks through a per-lane sequence index.

Boundary semantics: the CPU reference *asserts* in-bounds.  Patch starts
are clamped to the image, which is exact for every in-bounds access and
keeps samples at an out-of-bounds final position finite (the feature is
then classified OOB anyway).
"""

from __future__ import annotations

import numpy as np
import torch


def window_offsets(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """Integer window offsets (dx, dy), row-major like the reference's
    `for j ... for i ...` window walks — each f32 [height*width]."""
    hw, hh = width // 2, height // 2
    dy, dx = np.mgrid[-hh:hh + 1, -hw:hw + 1]
    return dx.ravel().astype(np.float32), dy.ravel().astype(np.float32)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample img[y, x] bilinearly for arbitrary-shaped coordinate tensors.

    img: [H, W] float32; x, y: f32 tensors (same shape); returns same shape.
    """
    h, w = img.shape[-2], img.shape[-1]
    xt = x.to(torch.int32)  # trunc toward zero; in-bounds coords are >= 0
    yt = y.to(torch.int32)
    ax = x - xt.to(torch.float32)
    ay = y - yt.to(torch.float32)

    x0 = xt.clamp(0, w - 2).long()
    y0 = yt.clamp(0, h - 2).long()

    p00 = img[..., y0, x0]
    p01 = img[..., y0, x0 + 1]
    p10 = img[..., y0 + 1, x0]
    p11 = img[..., y0 + 1, x0 + 1]

    return ((1 - ax) * (1 - ay) * p00 + ax * (1 - ay) * p01 +
            (1 - ax) * ay * p10 + ax * ay * p11)


def sample_stack_windows(stack: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, width: int, height: int,
                         seq: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear (width x height) windows around each center, for C images
    at once.

    stack: [C, H, W] f32 with x, y [N] window centers; or the stacks of B
    sequences, [B, C, H, W], with seq [N] (int64) the sequence of each
    lane.  Returns [C, N, height*width] samples at (x+i, y+j) for the
    row-major integer window offsets.  The patch start is clamped to
    [0, W-(width+1)] x [0, H-(height+1)] of the lane's own image
    (klt_tpu's dynamic_slice first wraps a negative start from the end;
    the tracker samples there only at positions it classifies OOB, so no
    result depends on the difference).
    """
    c, h_img, w_img = stack.shape[-3:]
    hw, hh = width // 2, height // 2
    xt = x.to(torch.int32)
    yt = y.to(torch.int32)
    ax = (x - xt.to(torch.float32))[None, :, None, None]
    ay = (y - yt.to(torch.float32))[None, :, None, None]
    x0 = (xt - hw).clamp(0, w_img - (width + 1)).long()
    y0 = (yt - hh).clamp(0, h_img - (height + 1)).long()

    dev = stack.device
    rows = y0[:, None, None] + torch.arange(height + 1, device=dev)[:, None]
    cols = x0[:, None, None] + torch.arange(width + 1, device=dev)[None, :]
    if seq is None:
        p = stack[:, rows, cols]  # [C, N, height+1, width+1]
    else:  # [N, height+1, width+1, C] -> [C, N, height+1, width+1]
        p = stack[seq[:, None, None], :, rows, cols].permute(3, 0, 1, 2)
    p00 = p[..., :-1, :-1]
    p01 = p[..., :-1, 1:]
    p10 = p[..., 1:, :-1]
    p11 = p[..., 1:, 1:]
    out = ((1 - ax) * (1 - ay) * p00 + ax * (1 - ay) * p01 +
           (1 - ax) * ay * p10 + ax * ay * p11)
    return out.reshape(c, x.shape[0], height * width)


def sample_stack_at(stack: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor,
                    seq: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear samples of C images at arbitrary coordinates of the full
    image: the sampler of the affine consistency check, whose windows are
    warped (klt_tpu's `make_exact_samplers`, the reference's _interpolate,
    src/V1/trackFeatures.c:31-57).

    stack: [C, H, W] f32; xs, ys: f32 of one shape S.  Or the stacks of B
    sequences, [B, C, H, W], with seq (int64, broadcastable to S) the
    sequence each coordinate samples.  Returns [C, *S].
    The integer corner is the truncated coordinate clamped to
    [0, W - 2] x [0, H - 2], the fractions are taken from that corner
    (so a coordinate outside the image extrapolates from the border
    cells and every read stays in bounds), and the blend is
    ((1-ax)(1-ay)) p00 + (ax(1-ay)) p01 + ((1-ax)ay) p10 + (ax ay) p11,
    added in that order, as csrc/affine.cu does."""
    c, nr, nc = stack.shape[-3:]
    # clamped before the cast too: a float beyond int32 converts
    # differently on the CPU and on the card
    xt = xs.clamp(0.0, float(nc - 2)).to(torch.int32).clamp(0, nc - 2)
    yt = ys.clamp(0.0, float(nr - 2)).to(torch.int32).clamp(0, nr - 2)
    ax = xs - xt.to(torch.float32)
    ay = ys - yt.to(torch.float32)
    base = (yt * nc + xt).long()
    if seq is None:
        flat = stack.reshape(c, nr * nc)
        taps = [flat[:, base + d] for d in (0, 1, nc, nc + 1)]
    else:  # [*S, C] -> [C, *S]
        flat = stack.reshape(stack.shape[0], c, nr * nc)
        seq = seq.expand(base.shape)
        taps = [flat[seq, :, base + d].movedim(-1, 0)
                for d in (0, 1, nc, nc + 1)]
    p00, p01, p10, p11 = taps
    return (((1 - ax) * (1 - ay)) * p00 + (ax * (1 - ay)) * p01 +
            ((1 - ax) * ay) * p10 + (ax * ay) * p11)
