"""The plain reference of the affine consistency check, in torch
operations alone: KLT 1.3's affineConsistencyCheck (Shi and Tomasi's
dissimilarity monitor, src/V1/trackFeatures.c:952-1220, called at
:1438-1496), following one clip from its start features.

A frozen copy of the port's plain versions (`save_patches_plain`,
`track_affine_plain`, `affine_consistency_step_plain` of
klt_tpu_torch/ops/affine.py, for one sequence) on top of
`benchmark.reference.klt`'s pyramid and Lucas-Kanade:

* a feature tracked for the first time saves a reference patch (the
  affine window and a margin of 2, integer-aligned around its truncated
  pre-track position, clamped into the frame: _am_getSubFloatImage) of
  image 1's intensity and gradients, its patch centre and an identity map;
* every later step verifies each feature tracked with a patch: a
  Gauss-Newton fit of the map (mode 0 translation, 1 similarity, 2 full
  affine) of the current frame's window against the saved patch, then
  the window's bounds, the drift and the residue; a feature that fails
  is killed (x = y = -1, its status as val) and forgets its patch;
* every sum runs in the order of the kernel's warp (klt._window_sum), the
  normal equations are built from explicit products and solved by
  Gauss-Jordan elimination, so on the same inputs these functions give
  the kernel's bits.

Departures from trackFeatures.c, kept from the port (and klt_tpu): the
drift kill compares the signed displacement (:1191 has no fabs) as the C
code does; a feature that passes keeps the translation tracker's
position (:1493-1494 discard the affine x2); the reference patch is
sampled at coordinates clipped to its interior and image 2 at a corner
clamped into the frame, where the C code asserts in-bounds reads; the
normal equations are eliminated on their diagonal pivots, where the C
code's Numerical Recipes elimination (:546-602) searches for each pivot
(the systems are symmetric positive definite, so the diagonal serves),
and a system is singular on a zero pivot, as there.

Nothing here imports the program.  `follow` computes its pyramid in a
lower precision when given `dtype`: the control, which the comparison
must refuse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import klt
from .klt import (LARGE_RESIDUE, OOB, SMALL_DET, TRACKED, _EPS, _div, _f32,
                  _oob, _window_sum)

PATCH_BORDER = 2


@dataclasses.dataclass(frozen=True)
class AffineConfig:
    """The check's settings, under the keys of a configuration file's
    "affine" object (KLT 1.3's defaults)."""

    affine_consistency_check: int = 2
    affine_window_width: int = 15
    affine_window_height: int = 15
    affine_max_iterations: int = 10
    affine_max_residue: float = 10.0
    affine_min_displacement: float = 0.02
    affine_max_displacement_differ: float = 1.5


@dataclasses.dataclass
class State:
    """Each feature's saved patch and map (the C aff_* fields)."""

    valid: torch.Tensor      # bool [N]
    patches: torch.Tensor    # f32 [3, N, ph, pw]
    x: torch.Tensor          # f32 [N] patch-frame centre
    y: torch.Tensor
    a: tuple                 # (axx, ayx, axy, ayy), f32 [N] each

    @classmethod
    def create(cls, n: int, acfg: AffineConfig, device) -> "State":
        ph = acfg.affine_window_height + PATCH_BORDER
        pw = acfg.affine_window_width + PATCH_BORDER
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return cls(torch.zeros(n, dtype=torch.bool, device=device),
                   torch.zeros((3, n, ph, pw), dtype=torch.float32,
                               device=device),
                   z, z.clone(), (z + 1.0, z.clone(), z.clone(), z + 1.0))


def _offsets(width: int, height: int, device):
    """Integer window offsets (dx, dy), f32 [height * width], row-major."""
    hw, hh = width // 2, height // 2
    dy, dx = np.mgrid[-hh:hh + 1, -hw:hw + 1]
    return (torch.from_numpy(dx.ravel().astype(np.float32)).to(device),
            torch.from_numpy(dy.ravel().astype(np.float32)).to(device))


def sample_at(stack: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
              ) -> torch.Tensor:
    """Bilinear samples [C, *S] of a [C, H, W] stack at coordinates of
    shape S: the corner truncated and clamped to [0, W - 2] x [0, H - 2],
    the four terms added in the order ((1-ax)(1-ay)) p00 + (ax(1-ay)) p01 +
    ((1-ax)ay) p10 + (ax ay) p11 (the C _interpolate)."""
    c, nr, nc = stack.shape
    xt = xs.clamp(0.0, float(nc - 2)).to(torch.int32).clamp(0, nc - 2)
    yt = ys.clamp(0.0, float(nr - 2)).to(torch.int32).clamp(0, nr - 2)
    ax = xs - xt.to(torch.float32)
    ay = ys - yt.to(torch.float32)
    base = (yt * nc + xt).long()
    flat = stack.reshape(c, nr * nc)
    p00, p01, p10, p11 = (flat[:, base + d] for d in (0, 1, nc, nc + 1))
    return (((1 - ax) * (1 - ay)) * p00 + (ax * (1 - ay)) * p01 +
            ((1 - ax) * ay) * p10 + (ax * ay) * p11)


def _sample_patches(patches, u, v):
    """patches [3, N, ph, pw] at patch coordinates u, v [N, K], clipped to
    [0, pw - 2] x [0, ph - 2] -> [3, N, K]."""
    c, n, ph, pw = patches.shape
    u = u.clamp(0.0, float(pw - 2))
    v = v.clamp(0.0, float(ph - 2))
    ui, vi = u.to(torch.int32), v.to(torch.int32)
    ax = u - ui.to(torch.float32)
    ay = v - vi.to(torch.float32)
    base = (vi * pw + ui).long().expand(c, -1, -1)
    flat = patches.reshape(c, n, ph * pw)
    p00, p01, p10, p11 = (flat.gather(2, base + d)
                          for d in (0, 1, pw, pw + 1))
    return (((1 - ax) * (1 - ay)) * p00 + (ax * (1 - ay)) * p01 +
            ((1 - ax) * ay) * p10 + (ax * ay) * p11)


def _corners(axx, ayx, axy, ayy, x2, y2, hw, hh):
    """The warped window's corners, x and y of the upper-left,
    lower-left, upper-right and lower-right (:1061-1068)."""
    return (axx * (-hw) + axy * hh + x2, ayx * (-hw) + ayy * hh + y2,
            axx * (-hw) + axy * (-hh) + x2, ayx * (-hw) + ayy * (-hh) + y2,
            axx * hw + axy * hh + x2, ayx * hw + ayy * hh + y2,
            axx * hw + axy * (-hh) + x2, ayx * hw + ayy * (-hh) + y2)


def _coord_oob(c, n):
    return (c < 0.0) | (n - c < _EPS)


def solve(T: torch.Tensor, B: torch.Tensor):
    """T X = B for small symmetric T [N, n, n], B [N, n, m], by
    Gauss-Jordan elimination without pivot search, column by column: the
    pivot row divided by the pivot, its multiple subtracted from every row
    (the pivot row too), then the pivot row overwritten by the divided
    row.  Returns (X, singular [N]): singular where a pivot was exactly 0
    (then taken as 1)."""
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


def track_affine(patches, stack2, x1, y1, x2_in, y2_in, a_in, active,
                 cfg: klt.Config, acfg: AffineConfig):
    """The verification of every active lane against its saved patch
    (_am_trackFeatureAffine, :952-1220): the Gauss-Newton loop, masked
    where the C code breaks, then the final checks.  stack2: level 0
    [3, H, W] of the frame tracked into; x1, y1 the patch centres; x2_in,
    y2_in the translation tracker's positions; a_in the maps.  Returns
    (x2, y2, a, status, iters), inactive lanes passing through TRACKED
    with 0 iterations; iters counts the iterations that sampled image 2."""
    mode = acfg.affine_consistency_check
    aw, ah = acfg.affine_window_width, acfg.affine_window_height
    hw, hh = float(aw // 2), float(ah // 2)
    pcf, prf = float(patches.shape[-1]), float(patches.shape[-2])
    ncf, nrf = float(stack2.shape[-1]), float(stack2.shape[-2])
    area = float(aw * ah)
    th = _f32(cfg.min_displacement)
    th_aff = _f32(acfg.affine_min_displacement)
    mdd = _f32(acfg.affine_max_displacement_differ)
    dxo, dyo = _offsets(aw, ah, x1.device)

    g1, gx1w, gy1w = _sample_patches(patches, x1[:, None] + dxo,
                                     y1[:, None] + dyo)
    src_oob = (_coord_oob(x1 - hw, pcf) | (pcf - (x1 + hw) < _EPS) |
               _coord_oob(y1 - hh, prf) | (prf - (y1 + hh) < _EPS))

    def warp(axx, ayx, axy, ayy, x2, y2):
        if mode == 0:
            return x2[:, None] + dxo, y2[:, None] + dyo
        return (x2[:, None] + (axx[:, None] * dxo + axy[:, None] * dyo),
                y2[:, None] + (ayx[:, None] * dxo + ayy[:, None] * dyo))

    axx, ayx, axy, ayy = a_in
    x2, y2 = x2_in, y2_in
    status = torch.full_like(x2, TRACKED, dtype=torch.int32)
    iters = torch.zeros_like(status)
    done = ~active
    for _ in range(acfg.affine_max_iterations):
        if not bool((~done).any()):
            break
        if mode == 0:
            oob = src_oob | _oob(x2, y2, hw, hh, ncf, nrf)
        else:
            cs = _corners(axx, ayx, axy, ayy, x2, y2, hw, hh)
            oob = src_oob
            for k in range(0, 8, 2):
                oob = oob | _coord_oob(cs[k], ncf) | _coord_oob(cs[k + 1],
                                                                nrf)
        status = torch.where(~done & oob, OOB, status)
        done = done | oob
        iters = iters + (~done).to(torch.int32)

        g2, gx2, gy2 = sample_at(stack2, *warp(axx, ayx, axy, ayy, x2, y2))
        diff = g1 - g2
        if mode == 0:
            gx, gy = gx1w + gx2, gy1w + gy2
            gxx, gxy, gyy, ex, ey = _window_sum(torch.stack(
                [gx * gx, gx * gy, gy * gy, diff * gx, diff * gy]))
            step = _f32(cfg.step_factor)
            ex, ey = ex * step, ey * step
            det = gxx * gyy - gxy * gxy
            small = det < _f32(cfg.min_determinant)
            det_safe = torch.where(small, torch.ones_like(det), det)
            dx = (gyy * ex - gxy * ey) / det_safe
            dy = (gxx * ey - gxy * ex) / det_safe
        else:
            if mode == 1:        # similarity: (s, r, dx, dy)
                cols = [dxo * gx2 + dyo * gy2, dxo * gy2 - dyo * gx2,
                        gx2, gy2]
            else:                # full affine
                cols = [dxo * gx2, dxo * gy2, dyo * gx2, dyo * gy2,
                        gx2, gy2]
            n = len(cols)
            pairs = [(p, q) for p in range(n) for q in range(p, n)]
            sums = list(_window_sum(torch.stack(
                [cols[p] * cols[q] for p, q in pairs] +
                [c * diff for c in cols])))
            T = x2.new_empty((x2.shape[0], n, n))
            for (p, q), s in zip(pairs, sums):
                T[:, p, q] = s
                T[:, q, p] = s
            e = torch.stack(sums[len(pairs):], dim=1) * 0.5
            sol, small = solve(T, e[:, :, None])
            a = sol[:, :, 0]
            old = cs
            if mode == 1:
                axx_n, ayx_n = axx + a[:, 0], ayx + a[:, 1]
                ayy_n, axy_n = axx_n, -ayx_n
                dx, dy = a[:, 2], a[:, 3]
            else:
                axx_n, ayx_n = axx + a[:, 0], ayx + a[:, 1]
                axy_n, ayy_n = axy + a[:, 2], ayy + a[:, 3]
                dx, dy = a[:, 4], a[:, 5]

        upd = ~done & ~small
        x2n = torch.where(upd, x2 + dx, x2)
        y2n = torch.where(upd, y2 + dy, y2)
        conv = (dx.abs() < th) & (dy.abs() < th)
        if mode != 0:
            axx = torch.where(upd, axx_n, axx)
            ayx = torch.where(upd, ayx_n, ayx)
            axy = torch.where(upd, axy_n, axy)
            ayy = torch.where(upd, ayy_n, ayy)
            new = _corners(axx, ayx, axy, ayy, x2n, y2n, hw, hh)
            for k in range(8):
                conv = conv & ((old[k] - new[k]).abs() < th_aff)
        status = torch.where(~done & small, SMALL_DET, status)
        x2, y2 = x2n, y2n
        done = done | small | conv

    # after the loop (:1185-1208): the window, the signed drift, the
    # residue sampled with the converged map
    drift = ((x2 - x2_in) > mdd) | ((y2 - y2_in) > mdd)
    status = torch.where(_oob(x2, y2, hw, hh, ncf, nrf) | drift, OOB,
                         status)
    g2 = sample_at(stack2[:1], *warp(axx, ayx, axy, ayy, x2, y2))[0]
    residue = _div(_window_sum((g1 - g2).abs()), area)
    status = torch.where((status == TRACKED) &
                         (residue > _f32(acfg.affine_max_residue)),
                         LARGE_RESIDUE, status)
    keep = lambda new, old: torch.where(active, new, old)
    a_out = tuple(keep(u, o) for u, o in zip((axx, ayx, axy, ayy), a_in))
    return (keep(x2, x2_in), keep(y2, y2_in), a_out,
            torch.where(active, status, TRACKED), iters)


def save_patches(patches, stack1, x_old, y_old, init):
    """patches [3, N, ph, pw] with the lanes of `init` replaced by the
    integer-aligned [ph, pw] windows of stack1 [3, H, W] around their
    truncated pre-track positions, clamped into the frame
    (_am_getSubFloatImage, :665-688)."""
    _, _, ph, pw = patches.shape
    nr, nc = stack1.shape[-2:]
    px0 = (x_old.to(torch.int32) - pw // 2).clamp(0, nc - pw)
    py0 = (y_old.to(torch.int32) - ph // 2).clamp(0, nr - ph)
    dev = stack1.device
    rows = py0.long()[:, None, None] + torch.arange(ph, device=dev)[:, None]
    cols = px0.long()[:, None, None] + torch.arange(pw, device=dev)[None, :]
    return torch.where(init[None, :, None, None], stack1[:, rows, cols],
                       patches)


def consistency_step(state: State, stack1, stack2, x_old, y_old, xn, yn,
                     vn, cfg: klt.Config, acfg: AffineConfig,
                     stats: list | None = None):
    """One step of the check after a translation track (:1438-1496),
    updating `state`: stack1, stack2 level 0 [3, H, W] of the two frames;
    x_old, y_old the positions before the track; xn, yn, vn after it.
    Returns the step's (x, y, val).  With a list for stats, appends
    (lanes that saved a patch, lanes verified, their iterations, lanes
    killed)."""
    ph = acfg.affine_window_height + PATCH_BORDER
    pw = acfg.affine_window_width + PATCH_BORDER
    tracked = vn == TRACKED
    init = tracked & ~state.valid
    active = tracked & state.valid
    frac_x = x_old - x_old.to(torch.int32).to(torch.float32)
    frac_y = y_old - y_old.to(torch.int32).to(torch.float32)
    one, zero = torch.ones_like(xn), torch.zeros_like(xn)
    a = (torch.where(init, one, state.a[0]), torch.where(init, zero,
                                                         state.a[1]),
         torch.where(init, zero, state.a[2]), torch.where(init, one,
                                                          state.a[3]))
    patches = save_patches(state.patches, stack1, x_old, y_old, init)
    cx = torch.where(init, frac_x + (pw // 2), state.x)
    cy = torch.where(init, frac_y + (ph // 2), state.y)
    _, _, a_r, st, iters = track_affine(patches, stack2, cx, cy, xn, yn, a,
                                        active, cfg, acfg)
    killed = active & (st != TRACKED)
    if stats is not None:
        stats.append((int(init.sum()), int(active.sum()), int(iters.sum()),
                      int(killed.sum())))
    passed = active & (st == TRACKED)
    minus1 = torch.full_like(xn, -1.0)
    state.patches = patches
    state.a = tuple(torch.where(passed, u, o) for u, o in zip(a_r, a))
    state.valid = tracked & (~state.valid | (st == TRACKED))
    state.x = torch.where(killed, minus1, cx)
    state.y = torch.where(killed, minus1, cy)
    return (torch.where(killed, minus1, xn), torch.where(killed, minus1, yn),
            torch.where(active, st, vn))


def follow(frames: torch.Tensor, x, y, val, cfg: klt.Config,
           acfg: AffineConfig, dtype: torch.dtype = torch.float32,
           lk_stats: list | None = None, affine_stats: list | None = None):
    """One clip u8 [T, H, W] from its start features [N]: each step the
    coarse-to-fine track (klt.track) then the consistency step, the
    pyramid computed in `dtype`.  Returns the tables (xs, ys, vals)
    [T - 1, N].  The stats lists, when given, gather klt.track's and
    consistency_step's counts of every step."""
    # the reference's arithmetic is float32 to the last bit: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = State.create(x.shape[0], acfg, x.device)
    s1 = klt.pyramid(frames[0], cfg, dtype)
    rows = []
    for t in range(1, frames.shape[0]):
        s2 = klt.pyramid(frames[t], cfg, dtype)
        xn, yn, vn = klt.track(s1, s2, x, y, val, cfg, lk_stats)
        x2, y2, v2 = consistency_step(state, s1[0], s2[0], x, y, xn, yn, vn,
                                      cfg, acfg, affine_stats)
        rows.append((x2, y2, v2))
        x, y, val = x2, y2, v2
        s1 = s2
    return tuple(torch.stack(r) for r in zip(*rows))
