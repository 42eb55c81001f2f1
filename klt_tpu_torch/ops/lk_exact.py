"""The bit-exact (golden-replay) translation LK tier.

The counterpart of klt_tpu/ops/lk_exact.py.  With per-frame replacement,
one borderline kill decision (a residue within ulps of max_residue, a
determinant or bounds test at the margin) makes two runs refill a
different number of slots, and the first-lost-slot walk then permutes
every later binding.  This tier rounds every f32 operation as the
reference's _trackFeature loop does (src/V1/trackFeatures.c:381-486), so
kill decisions, positions and, with ops/replace_exact, replacement picks
all match it to the bit:

* pyramids and gradients by the C-order separable passes
  (`build_pyramids_exact`: kernel A's, which keeps that order);
* the lane program of csrc/lk_exact_lane.h: window samples at x + i with a
  truncating int cast, the bilinear blend grouped
  ((w00*c00 + w01*c01) + w10*c10) + w11*c11, each window sum one
  sequential row-major chain, IEEE division, the reference's bounds test,
  residue check and status precedence, and the coarse-to-fine walk with
  its /= subsampling then *= subsampling scalings
  (`track_features_exact`; kernel G on the card, a warp per feature).

`track_features_exact_plain` is G's plain version: masked torch ops over
the [N] lanes, each lane rounding in the lane program's order (window
samples by direct gathers).  The scalar host oracle
(native/lk_exact_ref.c) compiles the lane program itself with cc, so the
tests hold three implementations against each other.

Limits, as klt_tpu's: square windows only (lk_exact.py:224) and no
lighting-insensitive variant; both raise ValueError here.
"""

from __future__ import annotations

import torch

from ..config import (TrackingConfig, TRACKED, SMALL_DET, MAX_ITERATIONS,
                      OOB, LARGE_RESIDUE)
from .lk import _div, _f32
from .pyramid import build_pyramid_stacks, build_pyramid_stacks_plain

_EPS = _f32(1.001)  # the bounds test's margin (src/V1/trackFeatures.c:409)


def check_exact_config(cfg: TrackingConfig) -> None:
    """Raise ValueError on what the exact tier does not take."""
    if cfg.window_width != cfg.window_height:
        raise ValueError(f"the exact tier takes square windows only, got "
                         f"{cfg.window_width}x{cfg.window_height}")
    if cfg.lighting_insensitive:
        raise ValueError("the exact tier has no lighting-insensitive variant")


def build_pyramids_exact(frame: torch.Tensor, cfg: TrackingConfig,
                         plain: bool = False) -> list[torch.Tensor]:
    """The exact-order pyramid of one uint8/f32 [H, W] frame
    (src/V1/trackFeatures.c:1296-1321, pyramid.c:87-131): finest-first
    f32 [3, H_l, W_l] stacks (intensity, gradx, grady), the port's usual
    layout (interop.exact_pyramids_to_numpy gives klt_tpu's tuples).
    Kernel A (ops/pyramid.py) already sums every pass in the C order, so
    this is its pyramid: one call of kernel A on CUDA, its plain version
    on the CPU or with plain=True."""
    return (build_pyramid_stacks_plain if plain
            else build_pyramid_stacks)(frame, cfg)


def exact_constants(cfg: TrackingConfig, rows0: int, cols0: int) -> dict:
    """The lane program's configuration, its float fields as the f32
    values the reference compares with (KltExactArgs of
    csrc/lk_exact_lane.h)."""
    return dict(
        win=cfg.window_width, max_iterations=int(cfg.max_iterations),
        check_residue=int(cfg.max_residue > 0),
        subsampling=_f32(cfg.subsampling),
        min_determinant=_f32(cfg.min_determinant),
        min_displacement=_f32(cfg.min_displacement),
        step_factor=_f32(cfg.step_factor), max_residue=_f32(cfg.max_residue),
        border_x0=_f32(cfg.borderx), border_x1=_f32(cols0 - 1 - cfg.borderx),
        border_y0=_f32(cfg.bordery), border_y1=_f32(rows0 - 1 - cfg.bordery))


def _oob(x, y, hw: int, rows: int, cols: int):
    """The reference's bounds test, f32 arithmetic in its order."""
    return ((x - hw < 0.0) | (cols - (x + hw) < _EPS) |
            (y - hw < 0.0) | (rows - (y + hw) < _EPS))


def _cell_weights(x, y, offs_i, offs_j, rows: int, cols: int):
    """Flat indices of the top-left corners [N, K] and the four bilinear
    weights of the K = win*win window cells (row-major) at (x, y).  Lanes
    outside the level get clamped indices; no result of theirs is used."""
    cx = x[:, None] + offs_i
    cy = y[:, None] + offs_j
    # a position far outside the level only needs a safe int cast
    cx = cx.clamp(-2.0, cols + 2.0)
    cy = cy.clamp(-2.0, rows + 2.0)
    xt = cx.to(torch.int32)  # truncation toward zero, as (int)
    yt = cy.to(torch.int32)
    ax = cx - xt.to(torch.float32)
    ay = cy - yt.to(torch.float32)
    bx, by = 1.0 - ax, 1.0 - ay
    idx = (yt.clamp(0, max(rows - 2, 0)).to(torch.int64) * cols +
           xt.clamp(0, max(cols - 2, 0)))
    return idx, (bx * by, ax * by, bx * ay, ax * ay)


def _blend(planes, idx, w, cols: int):
    """[P, N, K] bilinear samples of P flattened planes [P, H*W]."""
    w00, w01, w10, w11 = w
    c = [planes[:, idx], planes[:, idx + 1], planes[:, idx + cols],
         planes[:, idx + cols + 1]]
    return ((w00 * c[0] + w01 * c[1]) + w10 * c[2]) + w11 * c[3]


def _chain_sum(terms):
    """Sequential row-major f32 sum over the last axis, from the first
    term: `for k: acc = acc + term[k]`."""
    acc = terms[..., 0]
    for k in range(1, terms.shape[-1]):
        acc = acc + terms[..., k]
    return acc


def _track_level_plain(st1, st2, x1, y1, x2, y2, active,
                       cfg: TrackingConfig, stats: list | None = None):
    """One level of the lane program for all lanes: returns (x2, y2,
    status) with the inactive lanes' values meaningless.  With a list for
    `stats`, appends (lanes that entered the loop, iterations they ran,
    lanes whose residue was taken, the most iterations a lane ran)."""
    rows, cols = st1.shape[-2:]
    win = cfg.window_width
    hw = win // 2
    dev = x1.device
    max_iter = int(cfg.max_iterations)
    th = _f32(cfg.min_displacement)
    small = _f32(cfg.min_determinant)
    step = _f32(cfg.step_factor)
    status = torch.full(x1.shape, TRACKED, dtype=torch.int32, device=dev)
    iters = torch.zeros(x1.shape, dtype=torch.int32, device=dev)
    run = active & ~_oob(x1, y1, hw, rows, cols) & ~_oob(x2, y2, hw, rows,
                                                        cols)
    status = torch.where(active & ~run, OOB, status)
    if rows < win + 1 or cols < win + 1:  # no window fits: every lane OOB
        if stats is not None:
            stats.append((0, 0, 0, 0))
        return x2, y2, status
    entered = int(run.sum()) if stats is not None else 0
    offs = torch.arange(-hw, hw + 1, dtype=torch.float32, device=dev)
    offs_i = offs.repeat(win)[None, :]             # column offset of cell k
    offs_j = offs.repeat_interleave(win)[None, :]  # row offset of cell k
    p1 = st1.reshape(3, rows * cols)
    p2 = st2.reshape(3, rows * cols)
    idx1, w1 = _cell_weights(x1, y1, offs_i, offs_j, rows, cols)
    img1, gx1, gy1 = _blend(p1, idx1, w1, cols)
    dx = torch.zeros_like(x1)
    dy = torch.zeros_like(y1)
    for _ in range(max_iter):
        if not bool(run.any()):
            break
        idx2, w2 = _cell_weights(x2, y2, offs_i, offs_j, rows, cols)
        img2, gx2, gy2 = _blend(p2, idx2, w2, cols)
        diff = img1 - img2
        gx = gx1 + gx2
        gy = gy1 + gy2
        gxx, gxy, gyy, ex, ey = _chain_sum(torch.stack(
            [gx * gx, gx * gy, gy * gy, diff * gx, diff * gy]))
        ex = ex * step
        ey = ey * step
        det = gxx * gyy - gxy * gxy
        det_ok = det >= small
        det_safe = torch.where(det_ok, det, 1.0)
        ndx = (gyy * ex - gxy * ey) / det_safe
        ndy = (gxx * ey - gxy * ex) / det_safe
        status = torch.where(run & ~det_ok, SMALL_DET, status)
        upd = run & det_ok
        x2 = torch.where(upd, x2 + ndx, x2)
        y2 = torch.where(upd, y2 + ndy, y2)
        dx = torch.where(upd, ndx, dx)
        dy = torch.where(upd, ndy, dy)
        iters = torch.where(upd, iters + 1, iters)
        run = upd & ((dx.abs() >= th) | (dy.abs() >= th)) & (iters < max_iter)
        oob_next = run & _oob(x2, y2, hw, rows, cols)
        status = torch.where(oob_next, OOB, status)
        run = run & ~oob_next
    status = torch.where(active & _oob(x2, y2, hw, rows, cols), OOB, status)
    tracked = active & (status == TRACKED)
    if cfg.max_residue > 0 and bool(tracked.any()):
        idx2, w2 = _cell_weights(x2, y2, offs_i, offs_j, rows, cols)
        img2 = _blend(p2[:1], idx2, w2, cols)[0]
        resid = _div(_chain_sum((img1 - img2).abs()), float(win * win))
        status = torch.where(tracked & (resid > _f32(cfg.max_residue)),
                             LARGE_RESIDUE, status)
    status = torch.where(active & (status == TRACKED) & (iters >= max_iter),
                         MAX_ITERATIONS, status)
    if stats is not None:
        stats.append((entered, int(iters[active].sum()),
                      int(tracked.sum()) if cfg.max_residue > 0 else 0,
                      int(iters[active].max()) if bool(active.any()) else 0))
    return x2, y2, status


def track_features_exact_plain(stacks1, stacks2, x, y, val,
                               cfg: TrackingConfig,
                               stats: list | None = None):
    """Plain torch version of kernel G, on any device (contract of
    `track_features_exact`).  With a list for `stats`, every level appends
    (level, lanes that entered its loop, their iterations, lanes whose
    residue was taken, the most iterations a lane ran)."""
    check_exact_config(cfg)
    nlev = len(stacks1)
    ss = _f32(cfg.subsampling)
    rows0, cols0 = stacks1[0].shape[-2:]
    k = exact_constants(cfg, rows0, cols0)
    live = val >= 0
    xloc, yloc = x, y
    for _ in range(nlev):
        xloc = _div(xloc, ss)
        yloc = _div(yloc, ss)
    xout, yout = xloc, yloc
    status = torch.full_like(val, TRACKED)
    alive = live
    for r in range(nlev - 1, -1, -1):
        xloc, yloc, xout, yout = xloc * ss, yloc * ss, xout * ss, yout * ss
        level_stats = [] if stats is not None else None
        nx, ny, st = _track_level_plain(stacks1[r], stacks2[r], xloc, yloc,
                                        xout, yout, alive, cfg, level_stats)
        if stats is not None:
            stats.append((r, *level_stats[0]))
        xout = torch.where(alive, nx, xout)
        yout = torch.where(alive, ny, yout)
        status = torch.where(alive, st, status)
        # SMALL_DET or OOB ends the walk; other statuses go on to finer
        # levels and are overwritten there
        alive = alive & (st != SMALL_DET) & (st != OOB)
    border = ((xout < k["border_x0"]) | (xout > k["border_x1"]) |
              (yout < k["border_y0"]) | (yout > k["border_y1"]))
    is_oob = (status == OOB) | ((status != SMALL_DET) & border)
    killed = is_oob | (status < 0)
    new_val = torch.where(is_oob, OOB, status)
    x_out = torch.where(live, torch.where(killed, -1.0, xout), x)
    y_out = torch.where(live, torch.where(killed, -1.0, yout), y)
    v_out = torch.where(live, torch.where(killed, new_val, TRACKED), val)
    return x_out, y_out, v_out.to(torch.int32)


def track_features_exact(stacks1, stacks2, x, y, val, cfg: TrackingConfig,
                         plain: bool = False):
    """Bit-exact replica of KLTTrackFeatures' per-feature loop
    (src/V1/trackFeatures.c:1343-1501) for all lanes of a frame pair.

    stacks1, stacks2: finest-first [3, H_l, W_l] exact stacks
    (`build_pyramids_exact`) of the two frames; x, y f32 [N]; val i32
    [N].  Returns new (x, y, val): lost slots (val < 0) untouched, killed
    features at (-1, -1) with their status.  CUDA: one launch of kernel
    G.  CPU, or plain=True: the plain version."""
    check_exact_config(cfg)
    if len(stacks1) != len(stacks2) or not stacks1:
        raise ValueError(f"{len(stacks1)} and {len(stacks2)} levels")
    if not plain and x.is_cuda:
        from ..cuda.exact import track_exact_cuda
        return track_exact_cuda(stacks1, stacks2, x, y, val, cfg)
    if not plain and x.device.type != "cpu":
        raise ValueError(f"no exact LK path for device {x.device}")
    return track_features_exact_plain(stacks1, stacks2, x, y, val, cfg)
