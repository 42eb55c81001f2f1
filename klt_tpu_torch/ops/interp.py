"""Batched bilinear interpolation / window sampling.

The reference interpolates one scalar at a time (_interpolate,
src/V1/trackFeatures.c:31-57).  Here all N features sample their whole
window at once: coordinates are truncated toward zero (C `(int)` cast),
each feature reads one integer-aligned (height+1, width+1) patch, and the
bilinear blend runs as four shifted multiplies, in the same f32 order as
the LK kernel (csrc/lk_level.cu).

Boundary semantics: the CPU reference *asserts* in-bounds.  Patch starts
are clamped to the image, which is exact for every in-bounds access and
keeps samples at an out-of-bounds final position finite (the feature is
then classified OOB anyway).
"""

from __future__ import annotations

import torch


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
                         y: torch.Tensor, width: int,
                         height: int) -> torch.Tensor:
    """Bilinear (width x height) windows around each center, for C images
    at once.

    stack: [C, H, W] f32; x, y: [N] window centers.
    Returns [C, N, height*width] samples at (x+i, y+j) for the row-major
    integer window offsets.  The patch start is clamped to
    [0, W-(width+1)] x [0, H-(height+1)] (klt_tpu's dynamic_slice first
    wraps a negative start from the end; the tracker samples there only at
    positions it classifies OOB, so no result depends on the difference).
    """
    c, h_img, w_img = stack.shape
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
    p = stack[:, rows, cols]  # [C, N, height+1, width+1]
    p00 = p[..., :-1, :-1]
    p01 = p[..., :-1, 1:]
    p10 = p[..., 1:, :-1]
    p11 = p[..., 1:, 1:]
    out = ((1 - ax) * (1 - ay) * p00 + ax * (1 - ay) * p01 +
           (1 - ax) * ay * p10 + ax * ay * p11)
    return out.reshape(c, x.shape[0], height * width)
