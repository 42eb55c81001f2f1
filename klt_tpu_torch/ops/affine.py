"""Affine / similarity / translation consistency checking.

The reference's per-feature drift detector (_am_trackFeatureAffine and
helpers, src/V1/trackFeatures.c:506-1220; its use in the tracking loop
:1438-1497) as klt_tpu/ops/affine.py batches it: after each successful
translation track, a feature is compared against a reference patch saved
at its first successful track.  Drifting features are killed.

`track_affine` is kernel F's wrapper: on CUDA tensors one launch of
csrc/affine.cu (a warp per feature, every Gauss-Newton iteration and the
final checks inside), on the CPU or with plain=True `track_affine_plain`,
the same steps as masked torch operations over all features.

Semantics kept from klt_tpu (and through it from the reference):
* mode 0 = translation-only check, 1 = similarity (4 DoF), 2 = full
  affine (6 DoF), matching affineConsistencyCheck;
* per iteration: the bounds check first (mode 0: the axis-aligned window
  and the patch's window; modes 1, 2: the four warped corners), then the
  samples and the solve; the map and the position move only where the
  lane is live and the system was not singular; a lane stops for good on
  OOB, on a singular system (SMALL_DET) or once |dx|, |dy| <
  min_displacement and, in modes 1 and 2, all 8 corner coordinates moved
  by less than affine_min_displacement;
* mode 0 sums the gradients of both images, scales the error vector by
  step_factor and is singular when det < min_determinant; modes 1 and 2
  use the warped gradients of image 2 only, scale the error vector by 0.5
  (:836, :928) and are singular only on a pivot that is exactly 0;
* after the loop: the window OOB at the final position, the SIGNED drift
  kill against affine_max_displacement_differ (:1191, no fabs in the
  reference), then the residue, sampled with the converged warp without a
  second bounds check, against affine_max_residue;
* on success the feature KEEPS the translation tracker's position: the
  reference discards the affine tracker's x2 (:1493-1494).

Sampling.  Image 2 is sampled from the full level-0 image
(`ops.interp.sample_stack_at`: klt_tpu's `make_exact_samplers`, the
reference's _interpolate).  The reference patch is sampled at the patch
coordinates clipped to [0, pw - 2] x [0, ph - 2], with the same 4-term
blend ((1-ax)(1-ay)) p00 + (ax(1-ay)) p01 + ((1-ax)ay) p10 + (ax ay) p11
added in that order, in the kernel and in the plain version alike.
klt_tpu's resident patches, escape-repair pass, lane compaction and
one-hot sampling answer the TPU's lack of gathers and have no counterpart.

Sums over the window run in the order of the kernel's warp
(`ops.lk._window_sum`), the normal equations are built from explicit
products (no matmul) and solved by `utils.linalg.gj_solve_spd`, so kernel
and plain version agree bit for bit on the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import TrackingConfig, TRACKED, SMALL_DET, OOB, LARGE_RESIDUE
from ..utils.linalg import gj_solve_spd
from .interp import sample_stack_at
from .lk import _EPS, _div, _f32, _window_oob, _window_sum

_PATCH_BORDER = 2  # interpolation margin around the affine window (:1439)


def patch_shape(cfg: TrackingConfig) -> tuple[int, int]:
    """(ph, pw) of a reference patch: the affine window plus the margin."""
    return (cfg.affine_window_height + _PATCH_BORDER,
            cfg.affine_window_width + _PATCH_BORDER)


@dataclasses.dataclass
class AffineState:
    """Per-feature reference patches and affine parameters, tensors on one
    device (the reference's aff_* fields, src/V1/klt.h:96-105)."""

    valid: torch.Tensor   # bool[N]: patch saved (C: aff_img != NULL)
    patches: torch.Tensor  # f32[3, N, ph, pw]: img, gradx, grady (C aff_img*)
    x: torch.Tensor       # f32[N] patch-frame centre (C aff_x)
    y: torch.Tensor
    axx: torch.Tensor     # f32[N] affine map (C aff_Axx..aff_Ayy)
    ayx: torch.Tensor
    axy: torch.Tensor
    ayy: torch.Tensor

    @classmethod
    def create(cls, n: int, cfg: TrackingConfig,
               device: str | torch.device) -> "AffineState":
        ph, pw = patch_shape(cfg)
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
        return cls(valid=torch.zeros(n, dtype=torch.bool, device=device),
                   patches=z(3, n, ph, pw), x=z(n), y=z(n), axx=z(n) + 1.0,
                   ayx=z(n), axy=z(n), ayy=z(n) + 1.0)

    @property
    def img(self) -> torch.Tensor:
        return self.patches[0]

    @property
    def gradx(self) -> torch.Tensor:
        return self.patches[1]

    @property
    def grady(self) -> torch.Tensor:
        return self.patches[2]

    def invalidate(self, indices) -> None:
        """Forget the patches of the slots `indices` (int array)."""
        indices = np.asarray(indices)
        if indices.size:
            self.valid[torch.from_numpy(indices).to(self.valid.device)] = \
                False


def window_offsets(width: int, height: int, device):
    """Integer window offsets (dx, dy) as f32 [height*width], row-major
    like the reference's `for j ... for i ...` window walks."""
    hw, hh = width // 2, height // 2
    dy, dx = np.mgrid[-hh:hh + 1, -hw:hw + 1]
    return (torch.from_numpy(dx.ravel().astype(np.float32)).to(device),
            torch.from_numpy(dy.ravel().astype(np.float32)).to(device))


def _sample_patches(patches: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """patches [3, N, ph, pw], patch coordinates u, v [N, K] -> [3, N, K],
    coordinates clipped to [0, pw - 2] x [0, ph - 2]."""
    c, n, ph, pw = patches.shape
    u = u.clamp(0.0, float(pw - 2))
    v = v.clamp(0.0, float(ph - 2))
    ui = u.to(torch.int32)
    vi = v.to(torch.int32)
    ax = u - ui.to(torch.float32)
    ay = v - vi.to(torch.float32)
    base = (vi * pw + ui).long().expand(c, -1, -1)
    flat = patches.reshape(c, n, ph * pw)
    p00 = flat.gather(2, base)
    p01 = flat.gather(2, base + 1)
    p10 = flat.gather(2, base + pw)
    p11 = flat.gather(2, base + pw + 1)
    return (((1 - ax) * (1 - ay)) * p00 + (ax * (1 - ay)) * p01 +
            ((1 - ax) * ay) * p10 + (ax * ay) * p11)


def _corners(axx, ayx, axy, ayy, x2, y2, hw, hh):
    """Warped window corner coordinates (src/V1/trackFeatures.c:1061-1068):
    x and y of the upper-left, lower-left, upper-right, lower-right."""
    return (axx * (-hw) + axy * hh + x2, ayx * (-hw) + ayy * hh + y2,
            axx * (-hw) + axy * (-hh) + x2, ayx * (-hw) + ayy * (-hh) + y2,
            axx * hw + axy * hh + x2, ayx * hw + ayy * hh + y2,
            axx * hw + axy * (-hh) + x2, ayx * hw + ayy * (-hh) + y2)


def _coord_oob(c, n):
    return (c < 0.0) | (n - c < _EPS)


def stack_sequences(stack: torch.Tensor, n: int) -> int:
    """B of a level-0 stack [3, H, W] (1) or [B, 3, H, W] whose sequences
    share n lanes, flattened sequence-major; raises unless B divides n."""
    b = 1 if stack.dim() == 3 else stack.shape[0]
    if stack.dim() not in (3, 4) or stack.shape[-3] != 3 or b < 1 or n % b:
        raise ValueError(f"stacks must be [3, H, W] or [B, 3, H, W] with B "
                         f"dividing the {n} lanes, got {tuple(stack.shape)}")
    return b


def lane_sequences(stack: torch.Tensor, n: int):
    """The sequence of each of n lanes for batched stacks [B, 3, H, W]:
    lane l reads sequence l // (n / B).  None for one sequence's stack
    [3, H, W]."""
    b = stack_sequences(stack, n)
    if stack.dim() == 3:
        return None
    return torch.arange(n, device=stack.device) // (n // b)


def _sums(terms) -> list:
    """Window sums of a list of [N, K] tensors, in the warp's order."""
    return list(_window_sum(torch.stack(terms)))


def track_affine_plain(patches, stack2, x1, y1, x2_in, y2_in, a_in, active,
                       cfg: TrackingConfig):
    """Plain torch version of kernel F, on any device: the Gauss-Newton
    loop of every feature against its saved reference patch, masked where
    the reference `break`s, then the final checks.

    patches: f32 [3, N, ph, pw] (intensity, gradx, grady of the saved
    patches); stack2: f32 [3, H, W], level 0 of the frame tracked into, or
    [B, 3, H, W] of B sequences, lane l reading sequence l // (N / B);
    x1, y1 [N] the patch-frame centres; x2_in, y2_in [N] the start
    positions in image 2 (the translation tracker's); a_in = (axx, ayx,
    axy, ayy), each [N]; active bool [N].  Returns (x2, y2, (axx, ayx,
    axy, ayy), status i32 [N], iters i32 [N]): inactive lanes pass
    through with status TRACKED and 0 iterations; iters counts the
    iterations in which a lane sampled image 2."""
    mode = cfg.affine_consistency_check
    aw, ah = cfg.affine_window_width, cfg.affine_window_height
    hw, hh = float(aw // 2), float(ah // 2)
    ph, pw = patches.shape[-2:]
    nr2, nc2 = stack2.shape[-2:]
    seq = lane_sequences(stack2, x1.shape[0])
    seq = None if seq is None else seq[:, None]
    ncf, nrf, pcf, prf = float(nc2), float(nr2), float(pw), float(ph)
    area = float(aw * ah)
    th = _f32(cfg.min_displacement)
    th_aff = _f32(cfg.affine_min_displacement)
    mdd = _f32(cfg.affine_max_displacement_differ)
    dxo, dyo = window_offsets(aw, ah, x1.device)

    # the patch-side windows never change during the loop
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
    for _ in range(cfg.affine_max_iterations):
        if not bool((~done).any()):
            break
        if mode == 0:
            oob = src_oob | _window_oob(x2, y2, hw, hh, ncf, nrf)
        else:
            cs = _corners(axx, ayx, axy, ayy, x2, y2, hw, hh)
            oob = src_oob
            for k in range(0, 8, 2):
                oob = oob | _coord_oob(cs[k], ncf) | _coord_oob(cs[k + 1],
                                                                nrf)
        status = torch.where(~done & oob, OOB, status)
        done = done | oob
        iters = iters + (~done).to(torch.int32)

        g2, gx2, gy2 = sample_stack_at(
            stack2, *warp(axx, ayx, axy, ayy, x2, y2), seq)
        diff = g1 - g2
        if mode == 0:
            gx = gx1w + gx2
            gy = gy1w + gy2
            gxx, gxy, gyy, ex, ey = _sums(
                [gx * gx, gx * gy, gy * gy, diff * gx, diff * gy])
            step = _f32(cfg.step_factor)
            ex = ex * step
            ey = ey * step
            det = gxx * gyy - gxy * gxy
            small = det < _f32(cfg.min_determinant)
            det_safe = torch.where(small, torch.ones_like(det), det)
            dx = (gyy * ex - gxy * ey) / det_safe
            dy = (gxx * ey - gxy * ex) / det_safe
        else:
            if mode == 1:  # similarity: (s, r, dx, dy)
                cols = [dxo * gx2 + dyo * gy2, dxo * gy2 - dyo * gx2,
                        gx2, gy2]
            else:  # full affine
                cols = [dxo * gx2, dxo * gy2, dyo * gx2, dyo * gy2,
                        gx2, gy2]
            n = len(cols)
            pairs = [(p, q) for p in range(n) for q in range(p, n)]
            sums = _sums([cols[p] * cols[q] for p, q in pairs] +
                         [c * diff for c in cols])
            T = x2.new_empty((x2.shape[0], n, n))
            for (p, q), s in zip(pairs, sums):
                T[:, p, q] = s
                T[:, q, p] = s
            e = torch.stack(sums[len(pairs):], dim=1) * 0.5
            sol, small = gj_solve_spd(T, e[:, :, None])
            a = sol[:, :, 0]
            old = cs
            if mode == 1:
                axx_n = axx + a[:, 0]
                ayx_n = ayx + a[:, 1]
                ayy_n = axx_n
                axy_n = -ayx_n
                dx, dy = a[:, 2], a[:, 3]
            else:
                axx_n = axx + a[:, 0]
                ayx_n = ayx + a[:, 1]
                axy_n = axy + a[:, 2]
                ayy_n = ayy + a[:, 3]
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

    # post-loop checks (src/V1/trackFeatures.c:1185-1208)
    drift = ((x2 - x2_in) > mdd) | ((y2 - y2_in) > mdd)
    status = torch.where(_window_oob(x2, y2, hw, hh, ncf, nrf) | drift, OOB,
                         status)
    g2 = sample_stack_at(stack2[..., :1, :, :],
                         *warp(axx, ayx, axy, ayy, x2, y2), seq)[0]
    residue = _div(_window_sum((g1 - g2).abs()), area)
    status = torch.where((status == TRACKED) &
                         (residue > _f32(cfg.affine_max_residue)),
                         LARGE_RESIDUE, status)

    keep = lambda new, old: torch.where(active, new, old)
    a_out = tuple(keep(n, o) for n, o in zip((axx, ayx, axy, ayy), a_in))
    return (keep(x2, x2_in), keep(y2, y2_in), a_out,
            torch.where(active, status, TRACKED), iters)


def _check_track_affine(patches, stack2, lanes, cfg: TrackingConfig) -> None:
    ph, pw = patch_shape(cfg)
    n = lanes[0].shape[0]
    if patches.dim() != 4 or tuple(patches.shape) != (3, n, ph, pw):
        raise ValueError(f"patches must be [3, {n}, {ph}, {pw}], got "
                         f"{tuple(patches.shape)}")
    if stack2.dim() not in (3, 4) or stack2.shape[-3] != 3 or \
            min(stack2.shape[-2:]) < 2:
        raise ValueError(f"stack2 must be [3, H, W] or [B, 3, H, W], got "
                         f"{tuple(stack2.shape)}")
    stack_sequences(stack2, n)
    if any(t.shape != (n,) for t in lanes):
        raise ValueError("the lanes' tensors must all be [N]")
    if cfg.affine_consistency_check not in (0, 1, 2):
        raise ValueError("affine_consistency_check must be 0, 1 or 2, got "
                         f"{cfg.affine_consistency_check}")


def track_affine(patches, stack2, x1, y1, x2_in, y2_in, a_in, active,
                 cfg: TrackingConfig, plain: bool = False):
    """Gauss-Newton of every active feature against its saved reference
    patch (contract of `track_affine_plain`, without the iteration
    counts): returns (x2, y2, (axx, ayx, axy, ayy), status).  CUDA
    tensors: one launch of kernel F.  CPU tensors, or plain=True on any
    device: the plain version."""
    _check_track_affine(patches, stack2, (x1, y1, x2_in, y2_in, *a_in,
                                          active), cfg)
    if not plain and patches.is_cuda:
        from ..cuda.affine import track_affine_cuda
        return track_affine_cuda(patches, stack2, x1, y1, x2_in, y2_in,
                                 a_in, active, cfg)[:4]
    if not plain and patches.device.type != "cpu":
        raise ValueError(f"no affine path for device {patches.device}")
    return track_affine_plain(patches, stack2, x1, y1, x2_in, y2_in, a_in,
                              active, cfg)[:4]


def patch_starts(x_old, y_old, nr: int, nc: int, ph: int, pw: int):
    """Integer corner (px0, py0) of the [ph, pw] patch saved around each
    pre-track position: centred on the truncated position, clamped into
    the image (klt_tpu/ops/affine.py:882-885)."""
    px0 = (x_old.to(torch.int32) - pw // 2).clamp(0, nc - pw)
    py0 = (y_old.to(torch.int32) - ph // 2).clamp(0, nr - ph)
    return px0, py0


def save_patches_plain(patches, stack1, x_old, y_old, init_mask):
    """Plain torch version of kernel F's patch save: [3, N, ph, pw] with
    the patches of the lanes of init_mask replaced by integer-aligned
    copies of the three planes of stack1 [3, H, W], or of the lane's own
    sequence's in [B, 3, H, W]
    (reference: _am_getSubFloatImage, src/V1/trackFeatures.c:665-688)."""
    _, n, ph, pw = patches.shape
    nr, nc = stack1.shape[-2:]
    px0, py0 = patch_starts(x_old, y_old, nr, nc, ph, pw)
    dev = stack1.device
    rows = py0.long()[:, None, None] + torch.arange(ph, device=dev)[:, None]
    cols = px0.long()[:, None, None] + torch.arange(pw, device=dev)[None, :]
    seq = lane_sequences(stack1, n)
    if seq is None:
        saved = stack1[:, rows, cols]
    else:  # [N, ph, pw, 3] -> [3, N, ph, pw]
        saved = stack1[seq[:, None, None], :, rows, cols].permute(
            3, 0, 1, 2).contiguous()
    return torch.where(init_mask[None, :, None, None], saved, patches)


def affine_consistency_step(state: AffineState, stack1, stack2, x_old, y_old,
                            val_old, xn, yn, vn, cfg: TrackingConfig,
                            plain: bool = False):
    """Post-translation-track consistency pass, mutating `state` (the
    contract of `affine_consistency_step_plain`, which is its plain
    version).  CUDA tensors: one launch of kernel F's step entry, which
    saves the new patches, verifies the others and updates the state's
    tensors in place.  CPU tensors, or plain=True on any device: the plain
    version."""
    if not plain and stack1.is_cuda:
        from ..cuda.affine import affine_step_cuda_
        return affine_step_cuda_(state, stack1, stack2, x_old, y_old, xn, yn,
                                 vn, cfg)[:3]
    if not plain and stack1.device.type != "cpu":
        raise ValueError(f"no affine path for device {stack1.device}")
    return affine_consistency_step_plain(state, stack1, stack2, x_old, y_old,
                                         val_old, xn, yn, vn, cfg)


def verification_inputs(state: AffineState, stack1, x_old, y_old, xn, yn, vn,
                        cfg: TrackingConfig):
    """What a step verifies, from the state before it (which is left as it
    is): features tracked for the first time (vn TRACKED, no patch yet)
    save a reference patch of stack1 at their pre-track position, take the
    patch centre frac(position) + pw // 2 and the identity map; features
    tracked with a patch are the active lanes.  Returns the arguments of
    `track_affine` but stack2 and cfg: (patches, x1, y1, x2_in, y2_in,
    (axx, ayx, axy, ayy), active)."""
    ph, pw = patch_shape(cfg)
    tracked = vn == TRACKED
    init_mask = tracked & ~state.valid
    frac_x = x_old - x_old.to(torch.int32).to(torch.float32)
    frac_y = y_old - y_old.to(torch.int32).to(torch.float32)
    one, zero = torch.ones_like(xn), torch.zeros_like(xn)
    a = (torch.where(init_mask, one, state.axx),
         torch.where(init_mask, zero, state.ayx),
         torch.where(init_mask, zero, state.axy),
         torch.where(init_mask, one, state.ayy))
    return (save_patches_plain(state.patches, stack1, x_old, y_old,
                               init_mask),
            torch.where(init_mask, frac_x + (pw // 2), state.x),
            torch.where(init_mask, frac_y + (ph // 2), state.y),
            xn, yn, a, tracked & state.valid)


def affine_consistency_step_plain(state: AffineState, stack1, stack2, x_old,
                                  y_old, val_old, xn, yn, vn,
                                  cfg: TrackingConfig):
    """The consistency pass as torch operations on any device, mutating
    `state`: the plain version of kernel F's step entry.

    Mirrors the tracking loop's logic at src/V1/trackFeatures.c:1438-1497 as
    klt_tpu/ops/affine.py:867-971 batches it: features tracked for the
    first time save a reference patch of image 1 at their pre-track
    position (x_old, y_old) and reset their map to the identity; features
    with a patch are verified against it in image 2 (`track_affine_plain`)
    and killed on drift (x = y = -1, the status as val, the patch centre
    -1).  A feature that passes keeps the translation tracker's position
    (xn, yn).

    stack1, stack2: f32 [3, H, W], level 0 of the two frames' pyramids
    (intensity, gradx, grady), or [B, 3, H, W] of B sequences whose lanes
    are flattened sequence-major (lane l of sequence l // (N / B));
    x_old, y_old, xn, yn f32 [N]; val_old, vn i32 [N] (val_old is not
    read, as in klt_tpu).  Returns the updated (x, y, val)."""
    ph, pw = patch_shape(cfg)
    nr1, nc1 = stack1.shape[-2:]
    if stack1.shape != stack2.shape or stack1.dim() not in (3, 4) or \
            stack1.shape[-3] != 3 or nr1 < ph or nc1 < pw:
        raise ValueError(f"stacks must both be [3, H, W] or [B, 3, H, W] "
                         f"of at least {pw}x{ph}, got {tuple(stack1.shape)} "
                         f"and {tuple(stack2.shape)}")
    stack_sequences(stack1, xn.shape[0])
    valid = state.valid
    tracked = vn == TRACKED
    patches, ax_c, ay_c, _, _, a, run_mask = verification_inputs(
        state, stack1, x_old, y_old, xn, yn, vn, cfg)
    _, _, a_r, st, _ = track_affine_plain(patches, stack2, ax_c, ay_c, xn, yn,
                                          a, run_mask, cfg)
    state.patches = patches

    killed = run_mask & (st != TRACKED)
    minus1 = torch.full_like(xn, -1.0)
    x_out = torch.where(killed, minus1, xn)
    y_out = torch.where(killed, minus1, yn)
    val_out = torch.where(run_mask, st, vn)

    keep = run_mask & (st == TRACKED)
    state.axx, state.ayx, state.axy, state.ayy = (
        torch.where(keep, new, old) for new, old in zip(a_r, a))
    state.valid = torch.where(tracked,
                              torch.where(valid, st == TRACKED,
                                          torch.ones_like(valid)),
                              torch.zeros_like(valid))
    state.x = torch.where(killed, minus1, ax_c)
    state.y = torch.where(killed, minus1, ay_c)
    return x_out, y_out, val_out
