"""The plain reference of the KLT front end, in torch operations alone.

A frozen copy of the port's plain versions (the pyramid, the Newton loop
of pyramidal Lucas-Kanade, the min-eigenvalue response and the truncated
candidate map of replacement), which follow the reference C tracker
(src/V1/convolve.c, pyramid.c, trackFeatures.c, selectGoodFeatures.c):

* every sum accumulates in the order the C code and the port's kernels
  use (taps one after another; an LK window as a warp of 32 folds it), so
  on the same inputs these functions give the kernels' bits;
* nothing here imports the program: a later change to the program cannot
  move the yardstick.

`pyramid_dtype` computes the pyramid in a lower precision: the control,
which the comparison must refuse.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

TRACKED, NOT_FOUND, SMALL_DET, MAX_ITERATIONS, OOB, LARGE_RESIDUE = \
    0, -1, -2, -3, -4, -5
MAX_KERNEL_WIDTH = 71
WARP = 32
_EPS = float(np.float32(1.001))
_INT_LIMIT = float(np.float32(2147483583.0))


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class Config:
    """The tracker's settings that the front end reads, with the
    reference's derivation of the pyramid and the border
    (src/V1/klt.c:288-431)."""

    mindist: int = 10
    window_width: int = 7
    window_height: int = 7
    min_eigenvalue: int = 1
    min_determinant: float = 0.01
    min_displacement: float = 0.1
    max_iterations: int = 10
    max_residue: float = 10.0
    grad_sigma: float = 1.0
    smooth_sigma_fact: float = 0.1
    pyramid_sigma_fact: float = 0.9
    step_factor: float = 1.0
    n_skipped_pixels: int = 0
    search_range: int = 15
    n_pyramid_levels: int = -1
    subsampling: int = -1
    borderx: int = -1
    bordery: int = -1

    def __post_init__(self):
        for k in ("window_width", "window_height"):
            v = getattr(self, k)
            object.__setattr__(self, k, max(v + (v % 2 == 0), 3))
        if self.n_pyramid_levels < 0 or self.subsampling < 0:
            half = min(self.window_width, self.window_height) / 2.0
            ratio = float(self.search_range) / half
            if ratio < 1.0:
                lv = (1, 2)
            elif ratio <= 3.0:
                lv = (2, 2)
            elif ratio <= 5.0:
                lv = (2, 4)
            elif ratio <= 9.0:
                lv = (2, 8)
            else:
                lv = (int(math.log(7.0 * ratio + 1.0) / math.log(8.0) + 0.99),
                      8)
            object.__setattr__(self, "n_pyramid_levels", lv[0])
            object.__setattr__(self, "subsampling", lv[1])
        if self.borderx < 0 or self.bordery < 0:
            whw = max(self.window_width, self.window_height) // 2
            n_inv = len(gaussian_kernels(self.smooth_sigma)[0]) // 2
            p_hw = len(gaussian_kernels(self.pyramid_sigma)[0]) // 2
            for _ in range(1, self.n_pyramid_levels):
                n_inv = int((float(n_inv) + p_hw) / self.subsampling + 0.99)
            border = (n_inv + whw) * self.subsampling ** (
                self.n_pyramid_levels - 1)
            object.__setattr__(self, "borderx", border)
            object.__setattr__(self, "bordery", border)

    @property
    def smooth_sigma(self) -> float:
        return self.smooth_sigma_fact * max(self.window_width,
                                            self.window_height)

    @property
    def pyramid_sigma(self) -> float:
        return self.pyramid_sigma_fact * self.subsampling


def gaussian_kernels(sigma: float):
    """(gauss, derivative) f32 taps, the reference's _computeKernels
    (src/V1/convolve.c:60-114) in f32 arithmetic."""
    f32 = np.float32
    sigma = f32(sigma)
    hw = MAX_KERNEL_WIDTH // 2
    i = np.arange(-hw, hw + 1, dtype=np.int32)
    t = (-(i * i)).astype(f32) / (f32(2) * sigma * sigma)
    gauss = np.exp(t.astype(np.float64)).astype(f32)
    deriv = (-i).astype(f32) * gauss
    max_deriv = f32(float(sigma) * np.exp(-0.5))
    gw = dw = MAX_KERNEL_WIDTH
    k = 0
    while abs(np.float64(gauss[k] / f32(1.0))) < 0.01:
        k, gw = k + 1, gw - 2
    k = 0
    while abs(np.float64(deriv[k] / max_deriv)) < 0.01:
        k, dw = k + 1, dw - 2
    gauss = gauss[(MAX_KERNEL_WIDTH - gw) // 2:][:gw].copy()
    deriv = deriv[(MAX_KERNEL_WIDTH - dw) // 2:][:dw].copy()
    den = f32(0.0)
    for v in gauss:
        den = den + v
    gauss = gauss / den
    dhw = dw // 2
    den = f32(0.0)
    for idx in range(-dhw, dhw + 1):
        den = den - f32(idx) * deriv[idx + dhw]
    return gauss, deriv / den


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (torch's CPU sqrt may be an ulp
    off; numpy's and the card's are not)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b correctly rounded (a device scalar, not a reciprocal)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


# ----------------------------------------------------------------- pyramid

def convolve_1d(img: torch.Tensor, taps: np.ndarray, dim: int
                ) -> torch.Tensor:
    """Reversed taps along dim, each output summed from its first tap on,
    borders within the radius zeroed (src/V1/convolve.c:137-242)."""
    width = len(taps)
    radius = width // 2
    n = img.shape[dim]
    out = torch.zeros_like(img)
    if n < width:
        return out
    m = n - 2 * radius
    t = [float(v) for v in np.asarray(taps, np.float32)]
    acc = img.narrow(dim, 0, m) * t[width - 1]
    for k in range(1, width):
        acc = acc + img.narrow(dim, k, m) * t[width - 1 - k]
    out.narrow(dim, radius, m).copy_(acc)
    return out


def convolve_separable(img, horiz, vert):
    return convolve_1d(convolve_1d(img, horiz, -1), vert, -2)


def pyramid_shapes(ncols: int, nrows: int, cfg: Config):
    shapes = []
    for _ in range(cfg.n_pyramid_levels):
        shapes.append((ncols, nrows))
        ncols //= cfg.subsampling
        nrows //= cfg.subsampling
    return shapes


def pyramid(img: torch.Tensor, cfg: Config,
            dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """u8 [H, W] -> finest-first f32 [3, H_l, W_l] stacks (intensity,
    gradient x, gradient y), computed in `dtype`."""
    g_s, _ = gaussian_kernels(cfg.smooth_sigma)
    gauss, deriv = gaussian_kernels(cfg.grad_sigma)
    g_p, _ = gaussian_kernels(cfg.pyramid_sigma)
    s = cfg.subsampling
    sh = s // 2
    shapes = pyramid_shapes(img.shape[-1], img.shape[-2], cfg)
    level = convolve_separable(img.to(dtype), g_s, g_s)
    stacks = []
    for lvl in range(cfg.n_pyramid_levels):
        gx = convolve_separable(level, deriv, gauss)
        gy = convolve_separable(level, gauss, deriv)
        stacks.append(torch.stack([level, gx, gy]).to(torch.float32))
        if lvl < cfg.n_pyramid_levels - 1:
            sm = convolve_separable(level, g_p, g_p)
            ncols, nrows = shapes[lvl + 1]
            level = sm[sh::s, sh::s][:nrows, :ncols].contiguous()
    return stacks


# ----------------------------------------------------------------- LK

def _window_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a warp folds a window: partial t adds
    cells t, t + 32, ...; then 32 -> 16 -> ... -> 1."""
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


def _windows(stack, x, y, width, height):
    """[3, N, height*width] bilinear windows of a [3, H, W] stack; the
    patch start truncated toward zero and clamped to the image."""
    _, h_img, w_img = stack.shape
    hw, hh = width // 2, height // 2
    xt, yt = x.to(torch.int32), y.to(torch.int32)
    ax = (x - xt.to(torch.float32))[None, :, None, None]
    ay = (y - yt.to(torch.float32))[None, :, None, None]
    x0 = (xt - hw).clamp(0, w_img - (width + 1)).long()
    y0 = (yt - hh).clamp(0, h_img - (height + 1)).long()
    dev = stack.device
    rows = y0[:, None, None] + torch.arange(height + 1, device=dev)[:, None]
    cols = x0[:, None, None] + torch.arange(width + 1, device=dev)[None, :]
    p = stack[:, rows, cols]
    out = ((1 - ax) * (1 - ay) * p[..., :-1, :-1] +
           ax * (1 - ay) * p[..., :-1, 1:] +
           (1 - ax) * ay * p[..., 1:, :-1] + ax * ay * p[..., 1:, 1:])
    return out.reshape(3, x.shape[0], height * width)


def _oob(x, y, hw, hh, nc, nr):
    return ((x - hw < 0.0) | (nc - (x + hw) < _EPS) |
            (y - hh < 0.0) | (nr - (y + hh) < _EPS))


def _level(stack1, stack2, x1, y1, x2, y2, active, cfg: Config,
           want_residue: bool):
    """The Newton loop of one level (src/V1/trackFeatures.c:381-486)."""
    w, h = cfg.window_width, cfg.window_height
    hw, hh = float(w // 2), float(h // 2)
    nr, nc = stack1.shape[-2], stack1.shape[-1]
    if nr < h + 1 or nc < w + 1:
        status = torch.where(active, OOB, TRACKED).to(torch.int32)
        return x2, y2, status, torch.zeros_like(status)
    th = _f32(cfg.min_displacement)
    g1, gx1, gy1 = _windows(stack1, x1, y1, w, h)
    oob1 = _oob(x1, y1, hw, hh, float(nc), float(nr))
    xc, yc = x2, y2
    status = torch.full_like(x2, TRACKED, dtype=torch.int32)
    iters = torch.zeros_like(status)
    done = ~active
    for _ in range(cfg.max_iterations):
        if not bool((~done).any()):
            break
        oob = oob1 | _oob(xc, yc, hw, hh, float(nc), float(nr))
        status = torch.where(~done & oob, OOB, status)
        done = done | oob
        g2, gx2, gy2 = _windows(stack2, xc, yc, w, h)
        diff = g1 - g2
        gx, gy = gx1 + gx2, gy1 + gy2
        gxx, gxy, gyy, ex, ey = _window_sum(torch.stack(
            [gx * gx, gx * gy, gy * gy, diff * gx, diff * gy]))
        step = _f32(cfg.step_factor)
        ex, ey = ex * step, ey * step
        det = gxx * gyy - gxy * gxy
        small = det < _f32(cfg.min_determinant)
        det_safe = torch.where(small, torch.ones_like(det), det)
        dx = (gyy * ex - gxy * ey) / det_safe
        dy = (gxx * ey - gxy * ex) / det_safe
        status = torch.where(~done & small, SMALL_DET, status)
        done = done | small
        upd = ~done
        xc = torch.where(upd, xc + dx, xc)
        yc = torch.where(upd, yc + dy, yc)
        iters = iters + upd.to(torch.int32)
        done = done | (upd & (dx.abs() < th) & (dy.abs() < th))
    residue = torch.zeros_like(x2)
    if want_residue:
        g2, _, _ = _windows(stack2, xc, yc, w, h)
        residue = torch.where(active, _div(_window_sum((g1 - g2).abs()),
                                           float(w * h)), residue)
    xc = torch.where(active, xc, x2)
    yc = torch.where(active, yc, y2)
    status = torch.where(active, status, TRACKED)
    status = torch.where(_oob(xc, yc, hw, hh, float(nc), float(nr)), OOB,
                         status)
    status = torch.where((status == TRACKED) &
                         (residue > _f32(cfg.max_residue)),
                         LARGE_RESIDUE, status)
    status = torch.where((status == TRACKED) &
                         (iters >= cfg.max_iterations), MAX_ITERATIONS,
                         status)
    return xc, yc, torch.where(active, status, TRACKED), iters


def track(stacks1, stacks2, x, y, val, cfg: Config,
          stats: list | None = None):
    """Coarse-to-fine tracking of features [N] from frame 1 to frame 2
    (src/V1/trackFeatures.c:1234-1437).  Returns (x, y, val); a lost
    feature gets x = y = -1 and its status.  With a list for stats, each
    level appends (level, lanes in the loop, iterations)."""
    s = _f32(cfg.subsampling)
    nlev = cfg.n_pyramid_levels
    nr0, nc0 = stacks1[0].shape[-2], stacks1[0].shape[-1]
    alive = val >= 0
    xloc, yloc = x, y
    for _ in range(nlev):
        xloc, yloc = _div(xloc, s), _div(yloc, s)
    xout, yout = xloc, yloc
    aborted = torch.zeros_like(alive)
    last = torch.full_like(val, TRACKED)
    for r in range(nlev - 1, -1, -1):
        in_loop = alive & ~aborted
        xloc = torch.where(in_loop, xloc * s, xloc)
        yloc = torch.where(in_loop, yloc * s, yloc)
        xout = torch.where(in_loop, xout * s, xout)
        yout = torch.where(in_loop, yout * s, yout)
        x2, y2, st, iters = _level(stacks1[r], stacks2[r], xloc, yloc, xout,
                                   yout, in_loop, cfg, r == 0)
        if stats is not None:
            stats.append((r, in_loop, iters))
        xout = torch.where(in_loop, x2, xout)
        yout = torch.where(in_loop, y2, yout)
        last = torch.where(in_loop, st, last)
        aborted = aborted | (in_loop & ((st == SMALL_DET) | (st == OOB)))
    bx, by = np.float32(cfg.borderx), np.float32(cfg.bordery)
    outside = ((xout < float(bx)) | (xout > float(np.float32(nc0 - 1) - bx)) |
               (yout < float(by)) | (yout > float(np.float32(nr0 - 1) - by)))
    final = torch.where((last != OOB) & outside, OOB, last)
    lost = final != TRACKED
    minus1 = torch.full_like(xout, -1.0)
    return (torch.where(alive, torch.where(lost, minus1, xout), x),
            torch.where(alive, torch.where(lost, minus1, yout), y),
            torch.where(alive, final, val))


# ----------------------------------------------------------- replacement

def corner_response(gx: torch.Tensor, gy: torch.Tensor, cfg: Config):
    """Min-eigenvalue map of the windowed structure tensor, zero where
    the window leaves the frame (src/V1/selectGoodFeatures.c:394-424)."""
    ones_w = np.ones(cfg.window_width, np.float32)
    ones_h = np.ones(cfg.window_height, np.float32)

    def box(img):
        return convolve_1d(convolve_1d(img, ones_w, -1), ones_h, -2)

    gxx, gxy, gyy = box(gx * gx), box(gx * gy), box(gy * gy)
    lam = (gxx + gyy - sqrt_rn((gxx - gyy) * (gxx - gyy) +
                               4.0 * gxy * gxy)) / 2.0
    return torch.clamp(lam, max=_INT_LIMIT)


def candidate_map(resp: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The candidates' truncated int32 values (the C (int) cast), -1
    outside the border, off the sampling step and under the floor."""
    h, w = resp.shape
    floor = max(1, int(cfg.min_eigenvalue))
    ri = resp.to(torch.int32)
    bx = max(cfg.borderx, cfg.window_width // 2)
    by = max(cfg.bordery, cfg.window_height // 2)
    step = cfg.n_skipped_pixels + 1
    yi = torch.arange(h, device=resp.device)[:, None]
    xi = torch.arange(w, device=resp.device)[None, :]
    valid = (yi >= by) & (yi < h - by) & (xi >= bx) & (xi < w - bx)
    if step > 1:
        valid &= (((yi - by) % step) == 0) & (((xi - bx) % step) == 0)
    return torch.where(valid & (ri >= floor), ri, -1)


def stamp(m: torch.Tensor, px: int, py: int, rad: int) -> None:
    """Suppress the Chebyshev square of radius rad around (px, py)."""
    m[max(py - rad, 0):py + rad + 1, max(px - rad, 0):px + rad + 1] = -1


def stamped_map(resp, x, y, val, cfg: Config) -> torch.Tensor:
    """candidate_map with every live feature's square suppressed."""
    m = candidate_map(resp, cfg)
    rad = max(int(cfg.mindist) - 1, 0)
    live = (val >= 0).nonzero().flatten().tolist()
    xs, ys = x.to(torch.int64).tolist(), y.to(torch.int64).tolist()
    h, w = m.shape
    for i in live:
        if 0 <= xs[i] < w and 0 <= ys[i] < h:
            stamp(m, xs[i], ys[i], rad)
    return m


def replace(resp, x, y, val, cfg: Config):
    """Greedy replacement (src/V1/selectGoodFeatures.c:514-541): each
    lost slot, in slot order, takes the best unsuppressed candidate (the
    first in scan order among equals).  Returns new (x, y, val)."""
    x, y, val = x.clone(), y.clone(), val.clone()
    m = stamped_map(resp, x, y, val, cfg)
    flat = m.view(-1)
    floor = max(1, int(cfg.min_eigenvalue))
    rad = max(int(cfg.mindist) - 1, 0)
    w = m.shape[1]
    for slot in (val < 0).nonzero().flatten().tolist():
        idx = int(torch.argmax(flat))
        v = int(flat[idx])
        if v < floor:
            x[slot], y[slot], val[slot] = -1.0, -1.0, NOT_FOUND
            continue
        py, px = divmod(idx, w)
        x[slot], y[slot], val[slot] = float(px), float(py), v
        stamp(m, px, py, rad)
    return x, y, val
