"""Batched pyramidal Lucas-Kanade tracking.

The reference's per-feature Newton loops (_trackFeature
src/V1/trackFeatures.c:381-486, driver KLTTrackFeatures :1234-1529).
One pyramid level of all N features is `lk_level`, kernel B's wrapper: a
CUDA level goes to the LK kernel (csrc/lk_level.cu, one thread per
feature, the whole Newton loop in one launch, windows sampled straight
from the level stacks in device memory), a CPU level to
`lk_level_plain`, the same loop written with masked torch ops.  The
coarse-to-fine level loop and the post-loop status checks stay in torch.

Semantics preserved exactly (the check order of klt_tpu/ops/lk.py):
* the do/while runs >= 1 iteration and <= max_iterations updates;
* OOB is checked (with the 1.001 epsilon margin) against the first
  image's window and the current position before every update, and once
  more after the loop, and overrides any other status;
* SMALL_DET aborts before the update; convergence is |dx|<th AND |dy|<th;
* MAX_ITERATIONS is reported whenever the update budget was exhausted,
  even if the last step converged (src/V1/trackFeatures.c:483);
* SMALL_DET / OOB at a coarse level aborts the remaining levels and — like
  the C break — leaves the output coordinates at that level's scale for
  the final border classification (src/V1/trackFeatures.c:1378-1394);
* the lighting-insensitive variant replicates the reference's two distinct
  gain estimates (src/V1/trackFeatures.c:133-220, including the
  mislabeled accumulators).

Window sums accumulate sequentially over the window in row-major order,
as the C loops do, in both the kernel and the plain version, so the two
agree bit for bit on the same device inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (TrackingConfig, TRACKED, SMALL_DET, MAX_ITERATIONS,
                      OOB, LARGE_RESIDUE)
from .interp import sample_stack_windows

_EPS = float(np.float32(1.001))  # rounding margin (src/V1/trackFeatures.c:409)


def _f32(v) -> float:
    """A Python float holding the f32 rounding of v, so comparisons and
    products with f32 tensors see the reference's f32 constant."""
    return float(np.float32(v))


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b, correctly rounded.  PyTorch's CUDA division by a host scalar
    multiplies by the reciprocal instead, which can differ from IEEE
    division (the kernel's) by an ulp; a device scalar keeps the true
    division on every device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _window_oob(x, y, hw, hh, nc, nr):
    """Window-out-of-bounds test, f32 arithmetic like the reference."""
    return ((x - hw < 0.0) | (nc - (x + hw) < _EPS) |
            (y - hh < 0.0) | (nr - (y + hh) < _EPS))


def _window_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last (row-major window) axis, accumulated cell by
    cell like the reference's window loops."""
    acc = v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _gain_bias_diff(g1, g2, area):
    """Gain/bias-normalized intensity difference
    (src/V1/trackFeatures.c:133-169)."""
    mean1 = _div(_window_sum(g1 * g1), area)
    mean2 = _div(_window_sum(g2 * g2), area)
    alpha = torch.sqrt(mean1 / mean2)
    m1 = _div(_window_sum(g1), area)
    m2 = _div(_window_sum(g2), area)
    beta = m1 - alpha * m2
    return g1 - g2 * alpha[:, None] - beta[:, None]


def _gain_grad_sum(gx1w, gy1w, gx2w, gy2w, g1, g2, area):
    """Gain-normalized gradient sum.  The reference estimates this gain
    from plain-intensity means (src/V1/trackFeatures.c:180-220 — its
    accumulators are misnamed *_squared but sum raw values); replicated
    for behavioural parity."""
    mean1 = _div(_window_sum(g1), area)
    mean2 = _div(_window_sum(g2), area)
    alpha = torch.sqrt(mean1 / mean2)[:, None]
    return gx1w + gx2w * alpha, gy1w + gy2w * alpha


def _newton_step(g1, gx1w, gy1w, g2, gx2w, gy2w, cfg: TrackingConfig):
    """One 2x2 normal-equation solve from sampled [N, h*w] windows.

    Returns (dx, dy, small) — reference: _compute2by2GradientMatrix /
    _compute2by1ErrorVector / _solveEquation
    (src/V1/trackFeatures.c:227-307)."""
    area = float(cfg.window_width * cfg.window_height)
    if cfg.lighting_insensitive:
        diff = _gain_bias_diff(g1, g2, area)
        gradx, grady = _gain_grad_sum(gx1w, gy1w, gx2w, gy2w, g1, g2, area)
    else:
        diff = g1 - g2
        gradx = gx1w + gx2w
        grady = gy1w + gy2w

    gxx, gxy, gyy, ex, ey = _window_sum(torch.stack(
        [gradx * gradx, gradx * grady, grady * grady,
         diff * gradx, diff * grady]))
    step = _f32(cfg.step_factor)
    ex = ex * step
    ey = ey * step

    det = gxx * gyy - gxy * gxy
    small = det < _f32(cfg.min_determinant)
    det_safe = torch.where(small, torch.ones_like(det), det)
    dx = (gyy * ex - gxy * ey) / det_safe
    dy = (gxx * ey - gxy * ex) / det_safe
    return dx, dy, small


def _final_status(status, iters, x2f, y2f, residue, hw, hh, ncf, nrf,
                  cfg: TrackingConfig):
    """Post-loop checks (src/V1/trackFeatures.c:459-484)."""
    status = torch.where(_window_oob(x2f, y2f, hw, hh, ncf, nrf), OOB,
                         status)
    status = torch.where((status == TRACKED) &
                         (residue > _f32(cfg.max_residue)),
                         LARGE_RESIDUE, status)
    status = torch.where((status == TRACKED) &
                         (iters >= cfg.max_iterations),
                         MAX_ITERATIONS, status)
    return status


def lk_level_plain(stack1, stack2, x1, y1, x2, y2, active,
                   cfg: TrackingConfig, want_residue: bool = True):
    """Plain torch version of kernel B, on any device: the Newton loop of
    one level for every feature, masked where the reference `break`s.

    stack1/stack2 [3, H, W] f32; x1, y1 (first-image positions), x2, y2
    (initial guesses) f32 [F]; active bool [F].  Returns (x2, y2, status,
    iters, residue), each [F]; inactive lanes pass through with status
    TRACKED, iters 0 and residue 0.  The residue (mean |difference| at the
    final position) is computed only with want_residue, else 0.
    """
    w, h = cfg.window_width, cfg.window_height
    hw, hh = float(w // 2), float(h // 2)
    nr, nc = stack1.shape[-2], stack1.shape[-1]
    ncf, nrf = float(nc), float(nr)
    th = _f32(cfg.min_displacement)

    g1, gx1w, gy1w = sample_stack_windows(stack1, x1, y1, w, h)
    oob1 = _window_oob(x1, y1, hw, hh, ncf, nrf)

    x2c, y2c = x2, y2
    status = torch.full_like(x2, TRACKED, dtype=torch.int32)
    iters = torch.zeros_like(status)
    done = ~active
    for _ in range(cfg.max_iterations):
        if not bool((~done).any()):
            break
        oob = oob1 | _window_oob(x2c, y2c, hw, hh, ncf, nrf)
        status = torch.where(~done & oob, OOB, status)
        done = done | oob

        g2, gx2w, gy2w = sample_stack_windows(stack2, x2c, y2c, w, h)
        dx, dy, small = _newton_step(g1, gx1w, gy1w, g2, gx2w, gy2w, cfg)
        status = torch.where(~done & small, SMALL_DET, status)
        done = done | small

        upd = ~done
        x2c = torch.where(upd, x2c + dx, x2c)
        y2c = torch.where(upd, y2c + dy, y2c)
        iters = iters + upd.to(torch.int32)
        done = done | (upd & (dx.abs() < th) & (dy.abs() < th))

    residue = torch.zeros_like(x2)
    if want_residue:
        g2, _, _ = sample_stack_windows(stack2, x2c, y2c, w, h)
        if cfg.lighting_insensitive:
            diff = _gain_bias_diff(g1, g2, float(w * h))
        else:
            diff = g1 - g2
        residue = torch.where(active,
                              _div(_window_sum(diff.abs()), float(w * h)),
                              residue)
    x2c = torch.where(active, x2c, x2)
    y2c = torch.where(active, y2c, y2)
    status = torch.where(active, status, TRACKED)
    return x2c, y2c, status, iters, residue


def lk_level(stack1, stack2, x1, y1, x2, y2, active, cfg: TrackingConfig,
             want_residue: bool = True):
    """Kernel B's wrapper (contract of `lk_level_plain`).  CUDA: one
    launch of the LK kernel.  CPU: the plain version."""
    if stack1.device.type == "cuda":
        from ..cuda.lk_level import lk_level_cuda
        return lk_level_cuda(stack1, stack2, x1, y1, x2, y2, active, cfg,
                             want_residue)
    if stack1.device.type != "cpu":
        raise ValueError(f"no LK level path for device {stack1.device}")
    return lk_level_plain(stack1, stack2, x1, y1, x2, y2, active, cfg,
                          want_residue)


def track_level(stack1, stack2, x1, y1, x2, y2, active,
                cfg: TrackingConfig, want_residue: bool = True,
                plain: bool = False):
    """One pyramid level of batched LK (semantics of klt_tpu's
    `_track_level_gather`).

    stack1/stack2: [3, H, W] f32 (intensity, gradx, grady) of the two
    frames at this level.  Lanes with active=False pass through untouched
    with status TRACKED.  Returns (x2_out, y2_out, status, iters).
    plain=True runs the plain version on any device (the reference the
    kernel is held against); otherwise `lk_level` picks by device.
    """
    w, h = cfg.window_width, cfg.window_height
    nr, nc = stack1.shape[-2], stack1.shape[-1]
    if nr < h + 1 or nc < w + 1:
        # level smaller than the tracking window: every window is
        # out of bounds before the first iteration (the reference's
        # first _window_oob check fails for all positions)
        status = torch.where(active, OOB, TRACKED).to(torch.int32)
        return x2, y2, status, torch.zeros_like(status)

    level_fn = lk_level_plain if plain else lk_level
    x2f, y2f, status, iters, residue = level_fn(
        stack1, stack2, x1, y1, x2, y2, active, cfg, want_residue)
    status = _final_status(status, iters, x2f, y2f, residue,
                           float(w // 2), float(h // 2), float(nc),
                           float(nr), cfg)
    status = torch.where(active, status, TRACKED)
    return x2f, y2f, status, iters


def track_features_pyramid(pyr1, gradx1, grady1, pyr2, gradx2, grady2,
                           x, y, val, cfg: TrackingConfig):
    """Coarse-to-fine tracking of all features between two pyramids.

    pyr*/grad* are finest-first lists of [H_l, W_l] f32 images.  x, y are
    f32[N] positions in frame 1; val i32[N] (lost features val<0 are
    skipped).  Returns (x_new, y_new, val_new) with the reference's
    classification (src/V1/trackFeatures.c:1343-1437): lost features get
    x = y = -1 and the failure code.
    """
    stacks1 = [torch.stack([p, a, b])
               for p, a, b in zip(pyr1, gradx1, grady1)]
    stacks2 = [torch.stack([p, a, b])
               for p, a, b in zip(pyr2, gradx2, grady2)]
    return track_features_pyramid_stacks(stacks1, stacks2, x, y, val, cfg)


def track_features_pyramid_stacks(stacks1, stacks2, x, y, val,
                                  cfg: TrackingConfig, plain: bool = False):
    """Same driver on finest-first [3, H_l, W_l] stacks (the pyramid
    kernel's output layout).  plain=True runs every level through the
    plain version (see `track_level`)."""
    if len(stacks1) != cfg.n_pyramid_levels or \
            len(stacks2) != cfg.n_pyramid_levels:
        raise ValueError("stacks must hold n_pyramid_levels levels")
    if stacks1[0].shape != stacks2[0].shape:
        raise ValueError(f"frame pair mismatch: {tuple(stacks1[0].shape)} "
                         f"vs {tuple(stacks2[0].shape)}")
    s = _f32(cfg.subsampling)
    nlev = cfg.n_pyramid_levels
    nr0, nc0 = stacks1[0].shape[-2], stacks1[0].shape[-1]
    alive = val >= 0

    # repeated f32 division, level by level, like the reference
    xloc, yloc = x, y
    for _ in range(nlev):
        xloc = _div(xloc, s)
        yloc = _div(yloc, s)
    xout, yout = xloc, yloc

    aborted = torch.zeros_like(alive)
    last_status = torch.full_like(val, TRACKED)

    for r in range(nlev - 1, -1, -1):
        in_loop = alive & ~aborted  # lanes still in the C level loop
        xloc = torch.where(in_loop, xloc * s, xloc)
        yloc = torch.where(in_loop, yloc * s, yloc)
        xout = torch.where(in_loop, xout * s, xout)
        yout = torch.where(in_loop, yout * s, yout)

        x2, y2, st, _ = track_level(stacks1[r], stacks2[r], xloc, yloc,
                                    xout, yout, in_loop, cfg,
                                    want_residue=(r == 0), plain=plain)

        xout = torch.where(in_loop, x2, xout)
        yout = torch.where(in_loop, y2, yout)
        last_status = torch.where(in_loop, st, last_status)
        aborted = aborted | (in_loop & ((st == SMALL_DET) | (st == OOB)))

    # Final classification (src/V1/trackFeatures.c:1382-1437): a feature
    # that lands outside the border margin is recorded as OOB even if its
    # level status was something else.
    bx = np.float32(cfg.borderx)
    by = np.float32(cfg.bordery)
    out_of_border = ((xout < float(bx)) |
                     (xout > float(np.float32(nc0 - 1) - bx)) |
                     (yout < float(by)) |
                     (yout > float(np.float32(nr0 - 1) - by)))
    final = torch.where((last_status != OOB) & out_of_border, OOB,
                        last_status)

    lost = final != TRACKED
    minus1 = torch.full_like(xout, -1.0)
    x_new = torch.where(alive, torch.where(lost, minus1, xout), x)
    y_new = torch.where(alive, torch.where(lost, minus1, yout), y)
    val_new = torch.where(alive, final, val)
    return x_new, y_new, val_new
