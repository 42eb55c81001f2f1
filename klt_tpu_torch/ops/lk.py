"""Batched pyramidal Lucas-Kanade tracking.

The reference's per-feature Newton loops (_trackFeature
src/V1/trackFeatures.c:381-486, called from KLTTrackFeatures :1234-1529),
on the kernels of csrc/lk_level.cu: kernel B replaces klt_tpu's
pallas/lk2.py, kernel C its pallas/lk.py (the batched tier's
[B, 3, H, W] stacks and [B, F] features).  On an H100 LK is bound by latency, the
dependent Newton chain of a feature and the launches around it, not by
bytes or operations, so the kernels give a feature a warp and the frame
pair one launch.

* A frame pair: `track_features_pyramid_stacks`.  On CUDA tensors it is
  one launch of a pyramid entry (cuda/lk_level.py::lk_pyramid_cuda for
  [3, H, W] stacks, lk_pyramid_batched_cuda for [B, 3, H, W]): the
  division chain, the coarse-to-fine loop, each level's Newton loop and
  status checks and the final border classification all run in the
  kernel.  On the CPU, or with plain=True, it is
  `track_features_pyramid_levels`, the same steps as a torch loop over the
  levels: the plain version of the pyramid entries.
* A level: `lk_level` (and `track_level`, which adds the status checks).
  A CUDA level is one launch of a level entry (lk_level_cuda,
  lk_level_batched_cuda), a CPU level `lk_level_plain` /
  `lk_level_batched_plain`, the same Newton loop written with masked
  torch ops.

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

Window sums run in the order of the kernels' warp (`_window_sum`), in the
kernels and in the plain versions alike, so the two agree bit for bit on
the same inputs, on the card and between the card and the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (TrackingConfig, TRACKED, SMALL_DET, MAX_ITERATIONS,
                      OOB, LARGE_RESIDUE)
from ..utils.checks import (check_in_bounds, check_same_shape,
                            debug_enabled)
from .ieee import sqrt_rn
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


WARP = 32  # threads that share a window in csrc/lk_level.cu


def _window_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last (row-major window) axis in the order of the LK
    kernels, where a warp owns a window: the axis is padded with +0.0 to
    a multiple of 32 cells; partial t starts from cell t and adds cells
    t + 32, t + 64, ... in that order (thread t of the warp); then the 32
    partials fold 32 -> 16 -> 8 -> 4 -> 2 -> 1, partial i + half added to
    partial i (the warp's xor butterfly with offsets 16, 8, 4, 2, 1)."""
    pad = -v.shape[-1] % WARP
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    chunks = v.reshape(v.shape[:-1] + (-1, WARP))
    acc = chunks[..., 0, :]
    for k in range(1, chunks.shape[-2]):
        acc = acc + chunks[..., k, :]
    half = WARP // 2
    while half:
        acc = acc[..., :half] + acc[..., half:]
        half //= 2
    return acc[..., 0]


def _gain_bias_diff(g1, g2, area):
    """Gain/bias-normalized intensity difference
    (src/V1/trackFeatures.c:133-169)."""
    mean1 = _div(_window_sum(g1 * g1), area)
    mean2 = _div(_window_sum(g2 * g2), area)
    alpha = sqrt_rn(mean1 / mean2)
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
    alpha = sqrt_rn(mean1 / mean2)[:, None]
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


def _lk_lanes(stack1, stack2, seq, x1, y1, x2, y2, active,
              cfg: TrackingConfig, want_residue: bool):
    """The Newton loop of one level over flat lanes [N]: stacks [3, H, W]
    with seq None, or [B, 3, H, W] with seq [N] the lanes' sequences."""
    w, h = cfg.window_width, cfg.window_height
    hw, hh = float(w // 2), float(h // 2)
    nr, nc = stack1.shape[-2], stack1.shape[-1]
    ncf, nrf = float(nc), float(nr)
    th = _f32(cfg.min_displacement)

    g1, gx1w, gy1w = sample_stack_windows(stack1, x1, y1, w, h, seq)
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

        g2, gx2w, gy2w = sample_stack_windows(stack2, x2c, y2c, w, h, seq)
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
        g2, _, _ = sample_stack_windows(stack2, x2c, y2c, w, h, seq)
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
    return _lk_lanes(stack1, stack2, None, x1, y1, x2, y2, active, cfg,
                     want_residue)


def lk_level_batched_plain(stack1, stack2, x1, y1, x2, y2, active,
                           cfg: TrackingConfig, want_residue: bool = True):
    """Plain torch version of kernel C, on any device: `lk_level_plain`
    for B sequences at once.

    stack1/stack2 [B, 3, H, W] f32; x1, y1, x2, y2 f32 [B, F]; active bool
    [B, F].  Returns (x2, y2, status, iters, residue), each [B, F]; lane
    (b, f) equals `lk_level_plain` on sequence b bit for bit.
    """
    b, f = x1.shape
    seq = torch.arange(b, device=x1.device).repeat_interleave(f)
    out = _lk_lanes(stack1, stack2, seq,
                    *[t.reshape(b * f) for t in (x1, y1, x2, y2, active)],
                    cfg, want_residue)
    return tuple(t.reshape(b, f) for t in out)


def _plain_level(stack):
    """The plain version for [3, H, W] (B) or [B, 3, H, W] (C) stacks."""
    return lk_level_batched_plain if stack.dim() == 4 else lk_level_plain


def lk_level(stack1, stack2, x1, y1, x2, y2, active, cfg: TrackingConfig,
             want_residue: bool = True):
    """The level entries' wrapper (contract of `lk_level_plain`, or with
    [B, 3, H, W] stacks and [B, F] lanes of `lk_level_batched_plain`).
    CUDA: one launch of kernel B's level entry, or of kernel C's for B
    sequences.  CPU: the plain version."""
    if stack1.device.type == "cuda":
        from ..cuda.lk_level import lk_level_batched_cuda, lk_level_cuda
        fn = lk_level_batched_cuda if stack1.dim() == 4 else lk_level_cuda
        return fn(stack1, stack2, x1, y1, x2, y2, active, cfg, want_residue)
    if stack1.device.type != "cpu":
        raise ValueError(f"no LK level path for device {stack1.device}")
    return _plain_level(stack1)(stack1, stack2, x1, y1, x2, y2, active, cfg,
                                want_residue)


def track_level(stack1, stack2, x1, y1, x2, y2, active,
                cfg: TrackingConfig, want_residue: bool = True,
                plain: bool = False):
    """One pyramid level of batched LK (semantics of klt_tpu's
    `_track_level_gather`).

    stack1/stack2: [3, H, W] f32 (intensity, gradx, grady) of the two
    frames at this level, with lanes [F]; or B sequences' [B, 3, H, W]
    with lanes [B, F].  Lanes with active=False pass through untouched
    with status TRACKED.  Returns (x2_out, y2_out, status, iters).
    plain=True runs the plain version on any device (the reference the
    kernels are held against); otherwise `lk_level` picks by device.
    """
    w, h = cfg.window_width, cfg.window_height
    nr, nc = stack1.shape[-2], stack1.shape[-1]
    if nr < h + 1 or nc < w + 1:
        # level smaller than the tracking window: every window is
        # out of bounds before the first iteration (the reference's
        # first _window_oob check fails for all positions)
        status = torch.where(active, OOB, TRACKED).to(torch.int32)
        return x2, y2, status, torch.zeros_like(status)

    level_fn = _plain_level(stack1) if plain else lk_level
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


def _check_frame_pair(stacks1, stacks2, x, cfg: TrackingConfig) -> None:
    if len(stacks1) != cfg.n_pyramid_levels or \
            len(stacks2) != cfg.n_pyramid_levels:
        raise ValueError("stacks must hold n_pyramid_levels levels")
    if stacks1[0].shape != stacks2[0].shape:
        raise ValueError(f"frame pair mismatch: {tuple(stacks1[0].shape)} "
                         f"vs {tuple(stacks2[0].shape)}")
    if stacks1[0].shape[:-3] != x.shape[:-1]:
        raise ValueError(f"stacks {tuple(stacks1[0].shape)} do not fit "
                         f"features {tuple(x.shape)}")


def _debug_checks(stacks1, stacks2, x, y, val) -> None:
    """klt_tpu's debug-mode checks of a frame pair (utils/checks.py):
    nothing at all unless KLT_TPU_DEBUG=1."""
    if not debug_enabled() or not len(stacks1):
        return
    check_same_shape(stacks1[0], stacks2[0], "frame pair")
    alive = val >= 0
    check_in_bounds(torch.where(alive, x, 0.0), torch.where(alive, y, 0.0),
                    stacks1[0].shape[-1], stacks1[0].shape[-2],
                    "input feature positions")


def track_features_pyramid_stacks(stacks1, stacks2, x, y, val,
                                  cfg: TrackingConfig, plain: bool = False):
    """Coarse-to-fine tracking of all features between two frames, on
    finest-first [3, H_l, W_l] stacks (the pyramid kernel's output layout)
    with features [N]; or on B sequences' [B, 3, H_l, W_l] stacks (the
    batched pyramid kernel's) with features [B, N], where every lane runs
    as it would in its sequence alone.  Returns (x_new, y_new, val_new).

    CUDA stacks: one launch of kernel B's pyramid entry, or of kernel C's
    for B sequences.  CPU stacks, or plain=True on any device:
    `track_features_pyramid_levels`, the plain version."""
    _debug_checks(stacks1, stacks2, x, y, val)
    if not plain and len(stacks1) and stacks1[0].is_cuda:
        # the wrapper checks what `_check_frame_pair` checks, and more
        from ..cuda.lk_level import lk_pyramid_batched_cuda, lk_pyramid_cuda
        fn = lk_pyramid_batched_cuda if stacks1[0].dim() == 4 \
            else lk_pyramid_cuda
        return fn(stacks1, stacks2, x, y, val, cfg)
    _check_frame_pair(stacks1, stacks2, x, cfg)
    if not plain and stacks1[0].device.type != "cpu":
        raise ValueError(f"no LK path for device {stacks1[0].device}")
    return track_features_pyramid_levels(stacks1, stacks2, x, y, val, cfg,
                                         plain=plain)


def track_features_pyramid_levels(stacks1, stacks2, x, y, val,
                                  cfg: TrackingConfig, plain: bool = False,
                                  stats: list | None = None):
    """The coarse-to-fine tracker as a torch loop over the levels: the
    plain version of the LK pyramid entries (contract of
    `track_features_pyramid_stacks`).  Every step is elementwise over the
    lanes, so the one loop serves [N] and [B, N] features.  Each level
    goes through `track_level`: with plain=True its plain version on any
    device, else the level entry of kernel B or C on CUDA stacks.  With a
    list for `stats`, every level appends (level, lanes in the loop [..]
    bool, iterations [..] i32)."""
    _check_frame_pair(stacks1, stacks2, x, cfg)
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

        x2, y2, st, iters = track_level(stacks1[r], stacks2[r], xloc, yloc,
                                        xout, yout, in_loop, cfg,
                                        want_residue=(r == 0), plain=plain)
        if stats is not None:
            stats.append((r, in_loop, iters))

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
