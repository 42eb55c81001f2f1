"""Shi-Tomasi (min-eigenvalue) corner response and candidate extraction.

`corner_response` is kernel D's wrapper: CUDA gradients go to the
corner-response kernel (csrc/corner_response.cu; `corner_response_tiled`
is its tiling written out in plain torch), CPU gradients to
`corner_response_plain`, the dense structure-tensor scan of the reference
(src/V1/selectGoodFeatures.c:394-424) as two separable box filters over
the gradient products.  Both follow klt_tpu's Pallas kernel
(pallas/selection.py) and zero the box filter's borders; klt_tpu's XLA
path zero-pads instead, which differs only outside the candidate region.

`candidate_points` turns a response map into the reference's row-major
candidate list (src/V1/selectGoodFeatures.c:394-424), in one C pass into
a buffer the caller may own and reuse, which the native
host runtime (klt_tpu_torch/native) sorts tie-exactly and thins by
minimum distance.  The selection prefilter (`cell_topk`,
`candidate_points_topk`, `selection_prefilter_audit`) keeps only the best
few candidates of each (mindist x mindist) cell, on the response's
device, and certifies per call that the reduced list selects what the
full one would.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..config import TrackingConfig
from .convolve import convolve_1d
from .ieee import sqrt_rn

# int-capacity clamp (src/V1/selectGoodFeatures.c:415-420): the largest
# f32 below 2^31 - 1
_INT_LIMIT = float(np.float32(2147483583.0))
_INT_MIN = -2 ** 31


def corner_response_plain(gradx: torch.Tensor, grady: torch.Tensor,
                          window_width: int, window_height: int
                          ) -> torch.Tensor:
    """Plain torch version of kernel D, on any device: f32 [H, W]
    gradients -> f32 [H, W] min-eigenvalue map, zero where the window
    leaves the frame."""
    ones_w = np.ones(window_width, np.float32)
    ones_h = np.ones(window_height, np.float32)

    def box(img):
        return convolve_1d(convolve_1d(img, ones_w, -1), ones_h, -2)

    gxx = box(gradx * gradx)
    gxy = box(gradx * grady)
    gyy = box(grady * grady)
    # reference: _minEigenvalue, src/V1/selectGoodFeatures.c:289-292
    lam = (gxx + gyy -
           sqrt_rn((gxx - gyy) * (gxx - gyy) + 4.0 * gxy * gxy)) / 2.0
    return torch.clamp(lam, max=_INT_LIMIT)


# The tiling of csrc/corner_response.cu (kTileW, kTall, kFlat, kMinBlocks,
# kDefaultShared, kMaxShared there).
_TILE_W, _TALL, _FLAT, _MIN_BLOCKS = 32, 32, 8, 264
_DEFAULT_SHARED, _MAX_SHARED = 48 * 1024, 227 * 1024


def response_tile_rows(window_width: int, window_height: int,
                       rows: int, cols: int) -> int:
    """Output rows of a tile of kernel D's tiled entry on a [rows, cols]
    map: 32 (tall) when its shared memory leaves room for several blocks
    on an SM and the map has enough tiles to fill the card, else 8
    (flat), or 0 when no tile holds the window (the global-memory
    entry)."""
    def shared(th):
        pitch = (_TILE_W + window_width - 1) | 1
        return 3 * (th + window_height - 1) * (pitch + _TILE_W + 1) * 4

    if shared(_TALL) <= _DEFAULT_SHARED:
        tiles = -(-cols // _TILE_W) * -(-rows // _TALL)
        return _TALL if tiles >= _MIN_BLOCKS else _FLAT
    return _FLAT if shared(_FLAT) <= _MAX_SHARED else 0


def corner_response_tiled(gradx: torch.Tensor, grady: torch.Tensor,
                          window_width: int, window_height: int):
    """Kernel D's tiled entry written out in plain torch, tile by tile as
    a block runs it: the crop of both gradients with a halo of
    window_width - 1 columns and window_height - 1 rows (pixels outside
    the map are zeros, which feed only zeroed outputs), the three products
    once per pixel, their horizontal sums on every row of the crop, the
    vertical sums of those and the eigenvalue; each sum in sequence from
    the first term, zeroing by global coordinates.  Returns the [H, W]
    response, bit-equal to `corner_response_plain`, or None when no tile
    holds the window."""
    rows, cols = gradx.shape
    ww, wh = window_width, window_height
    th = response_tile_rows(ww, wh, rows, cols)
    if th == 0:
        return None
    rx, ry = ww // 2, wh // 2
    ih, iw = th + wh - 1, _TILE_W + ww - 1
    out = torch.full((rows, cols), float("nan"), device=gradx.device)
    zero = torch.zeros((), device=gradx.device)
    ar_x = torch.arange(_TILE_W, device=gradx.device)
    ar_y = torch.arange(th, device=gradx.device)
    for i0 in range(0, rows, th):
        for j0 in range(0, cols, _TILE_W):
            gy0, gx0 = i0 - ry, j0 - rx
            crops = []
            for g in (gradx, grady):
                crop = torch.zeros((ih, iw), device=gradx.device)
                ys = slice(max(gy0, 0), min(gy0 + ih, rows))
                xs = slice(max(gx0, 0), min(gx0 + iw, cols))
                if ys.start < ys.stop and xs.start < xs.stop:
                    crop[ys.start - gy0:ys.stop - gy0,
                         xs.start - gx0:xs.stop - gx0] = g[ys, xs]
                crops.append(crop)
            cx, cy = crops
            x_in = ((j0 + ar_x >= rx) & (j0 + ar_x < cols - rx))[None, :]
            y_in = ((i0 + ar_y >= ry) & (i0 + ar_y < rows - ry))[:, None]
            sums = []
            for prod in (cx * cx, cx * cy, cy * cy):
                mid = prod[:, 0:_TILE_W]
                for m in range(1, ww):
                    mid = mid + prod[:, m:m + _TILE_W]
                mid = torch.where(x_in, mid, zero)
                acc = mid[0:th]
                for m in range(1, wh):
                    acc = acc + mid[m:m + th]
                sums.append(torch.where(y_in, acc, zero))
            gxx, gxy, gyy = sums
            lam = (gxx + gyy - sqrt_rn((gxx - gyy) * (gxx - gyy) +
                                       4.0 * gxy * gxy)) / 2.0
            n_i, n_j = min(th, rows - i0), min(_TILE_W, cols - j0)
            out[i0:i0 + n_i, j0:j0 + n_j] = \
                torch.clamp(lam, max=_INT_LIMIT)[:n_i, :n_j]
    return out


def corner_response(gradx: torch.Tensor, grady: torch.Tensor,
                    window_width: int, window_height: int) -> torch.Tensor:
    """Min-eigenvalue map of the windowed structure tensor.  CUDA: one
    call of the corner-response kernel.  CPU: the plain version."""
    if gradx.device.type == "cuda":
        from ..cuda.corner_response import corner_response_cuda
        return corner_response_cuda(gradx, grady, window_width,
                                    window_height)
    if gradx.device.type != "cpu":
        raise ValueError(f"no corner-response path for device "
                         f"{gradx.device}")
    return corner_response_plain(gradx, grady, window_width, window_height)


def _candidate_borders(cfg: TrackingConfig):
    window_hw = cfg.window_width // 2
    window_hh = cfg.window_height // 2
    return (max(cfg.borderx, window_hw), max(cfg.bordery, window_hh),
            cfg.n_skipped_pixels + 1)


def candidate_count(cfg: TrackingConfig, ncols: int, nrows: int) -> int:
    """The length of `candidate_points`' list for an nrows x ncols map."""
    return native.candidate_count(ncols, nrows, *_candidate_borders(cfg))


def candidate_points(response: np.ndarray, cfg: TrackingConfig,
                     ncols: int, nrows: int,
                     out: np.ndarray | None = None) -> np.ndarray:
    """Host-side pointlist [(x, y, int(val)), ...] in the reference's
    row-major scan order (src/V1/selectGoodFeatures.c:394-424), written by
    one C pass (native.candidate_list).

    response: float32 [nrows, ncols] on the host.  out: an int32
    [candidate_count(cfg, ncols, nrows), 3] buffer to write every row of
    the list into, reused from call to call; a fresh one when None.
    Returns the list.  Truncation toward zero matches the C cast.
    """
    if out is None:
        out = np.empty((candidate_count(cfg, ncols, nrows), 3), np.int32)
    return native.candidate_list(np.ascontiguousarray(response), ncols,
                                 nrows, *_candidate_borders(cfg), out)


def cell_topk(response: torch.Tensor, cell: int, k: int, borderx: int,
              bordery: int, step: int):
    """Per-cell top-(k+1) of the truncated response over aligned
    (cell x cell) tiles, on the response's device.

    The response is cast to int32 as C does (truncation toward zero);
    border and off-step pixels carry INT_MIN; the map is padded with
    INT_MIN to whole cells.  Returns (vals int32 [nCells, kk], in-cell flat
    index int32 [nCells, kk]), kk = min(k + 1, cell * cell), cells in
    row-major order, each row in descending value with the lower index
    first among equal values (a stable sort, as jax.lax.top_k orders
    ties).  The extra rank feeds `selection_prefilter_audit`: the best
    value each cell dropped."""
    h, w = response.shape
    dev = response.device
    vals = response.to(torch.int32)
    yi = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xi = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    valid = ((yi >= bordery) & (yi < h - bordery) &
             (xi >= borderx) & (xi < w - borderx))
    if step > 1:
        valid &= (((yi - bordery) % step) == 0) & \
                 (((xi - borderx) % step) == 0)
    vals = torch.where(valid, vals, torch.full_like(vals, _INT_MIN))
    ph, pw = (-h) % cell, (-w) % cell
    if ph or pw:
        vals = torch.nn.functional.pad(vals, (0, pw, 0, ph),
                                       value=_INT_MIN)
    ncy, ncx = (h + ph) // cell, (w + pw) // cell
    cells = vals.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    kk = min(k + 1, cell * cell)
    top, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    return top[:, :kk], idx[:, :kk].to(torch.int32)


def candidate_points_topk(response, cfg: TrackingConfig, ncols: int,
                          nrows: int, k: int = 4):
    """The selection prefilter: the k best candidates of each aligned
    (mindist x mindist) cell, computed on the response's device (a numpy
    response is taken on the CPU), so that O(k * nCells) values come back
    to the host instead of the whole map.

    The suppression stamp covers Chebyshev radius mindist-1 (reference:
    _fillFeaturemap after the mindist-- at
    src/V1/selectGoodFeatures.c:162-168), so at most one candidate a cell
    can be accepted; k > 1 covers candidates whose cell-mates were stamped
    from neighbouring cells.  `selection_prefilter_audit` certifies each
    call; callers fall back to `candidate_points` when it fails.

    Returns (pts int32 [m, 3] of (x, y, val) with val >= 1,
    dropped_cells int32 [d, 3] of (cell_x0, cell_y0, best dropped value)
    for every cell that left out at least one addable candidate)."""
    if isinstance(response, np.ndarray):
        response = torch.from_numpy(response)
    cell = max(int(cfg.mindist), 1)
    borderx, bordery, step = _candidate_borders(cfg)
    top, idx = cell_topk(response, cell, k, borderx, bordery, step)
    top = top.cpu().numpy()
    idx = idx.cpu().numpy()
    kk = top.shape[1]
    use = min(k, kk)
    ncx = (ncols + (-ncols) % cell) // cell
    cy = (np.arange(top.shape[0], dtype=np.int32) // ncx) * cell
    cx = (np.arange(top.shape[0], dtype=np.int32) % ncx) * cell
    ys = idx[:, :use] // cell + cy[:, None]
    xs = idx[:, :use] % cell + cx[:, None]
    v = top[:, :use]
    keep = v >= 1  # sub-1 values can never be added (min_eig floor)
    pts = np.stack([xs[keep], ys[keep], v[keep]], axis=1).astype(np.int32)
    if kk > k:
        dmask = top[:, k] >= 1
        dropped_cells = np.stack(
            [cx[dmask], cy[dmask], top[:, k][dmask]],
            axis=1).astype(np.int32)
    else:
        dropped_cells = np.empty((0, 3), np.int32)
    return pts, dropped_cells


def selection_prefilter_audit(pts: np.ndarray, dropped_cells: np.ndarray,
                              added_vals: np.ndarray,
                              added_x: np.ndarray, added_y: np.ndarray,
                              exist_x: np.ndarray, exist_y: np.ndarray,
                              n_unfilled: int, cfg: TrackingConfig) -> bool:
    """True iff the reduced-list selection outcome provably equals the
    full-list one.

    Let floor = max(1, min_eigenvalue), stamp = mindist-1 (the Chebyshev
    suppression radius), and v_boundary = the value of the LAST slot
    filled (selections happen in descending value order), or floor when
    slots stayed empty.  Exactness holds when:

      1. every cell that dropped an addable candidate with best dropped
         value m >= v_boundary is COVERED: it contains a pre-existing
         feature, or an accepted point with value > m.  A cell's side
         equals mindist, so any in-cell point stamps the entire cell —
         the dropped candidates were dead before their turn.
      2. among kept candidates >= v_boundary that are NOT provably dead
         on arrival (stamped by a pre-existing feature or by an accepted
         point of strictly larger value), equal-valued groups must be
         pairwise non-interacting (Chebyshev > stamp) and a group at
         exactly v_boundary must be fully accepted — otherwise the
         reference's tie order (a full-array quicksort permutation the
         reduced array cannot reproduce) could pick different members.
    """
    floor = max(1, int(cfg.min_eigenvalue))
    stamp = max(int(cfg.mindist) - 1, 0)
    if n_unfilled > 0:
        v_boundary = floor
    else:
        v_boundary = int(added_vals.min()) if added_vals.size else floor

    def covered_by_existing(x, y):
        if exist_x.size == 0:
            return np.zeros(x.shape, bool)
        dx = np.abs(x[:, None] - exist_x[None, :])
        dy = np.abs(y[:, None] - exist_y[None, :])
        return (np.maximum(dx, dy) <= stamp).any(axis=1)

    # 1. dropped-cell coverage
    hotc = dropped_cells[dropped_cells[:, 2] >= v_boundary]
    if hotc.shape[0]:
        cell = max(int(cfg.mindist), 1)
        in_cell_exist = np.zeros(hotc.shape[0], bool)
        if exist_x.size:
            in_cell_exist = (
                (exist_x[None, :] >= hotc[:, 0][:, None]) &
                (exist_x[None, :] < hotc[:, 0][:, None] + cell) &
                (exist_y[None, :] >= hotc[:, 1][:, None]) &
                (exist_y[None, :] < hotc[:, 1][:, None] + cell)
            ).any(axis=1)
        in_cell_added = np.zeros(hotc.shape[0], bool)
        if added_x.size:
            in_cell_added = (
                (added_x[None, :] >= hotc[:, 0][:, None]) &
                (added_x[None, :] < hotc[:, 0][:, None] + cell) &
                (added_y[None, :] >= hotc[:, 1][:, None]) &
                (added_y[None, :] < hotc[:, 1][:, None] + cell) &
                (added_vals[None, :] > hotc[:, 2][:, None])
            ).any(axis=1)
        if not (in_cell_exist | in_cell_added).all():
            return False

    # 2. tie safety among live kept candidates
    hot = pts[pts[:, 2] >= v_boundary]
    if hot.shape[0] <= 1:
        return True
    doa = covered_by_existing(hot[:, 0], hot[:, 1])
    if added_x.size:
        dx = np.abs(hot[:, 0][:, None] - added_x[None, :])
        dy = np.abs(hot[:, 1][:, None] - added_y[None, :])
        doa |= ((np.maximum(dx, dy) <= stamp) &
                (added_vals[None, :] > hot[:, 2][:, None])).any(axis=1)
    live = hot[~doa]
    if live.shape[0] <= 1:
        return True
    uniq, counts = np.unique(live[:, 2], return_counts=True)
    added_set = {(int(x), int(y)) for x, y in zip(added_x, added_y)}
    for v in uniq[counts > 1]:
        grp = live[live[:, 2] == v]
        dx = np.abs(grp[:, 0][:, None] - grp[:, 0][None, :])
        dy = np.abs(grp[:, 1][:, None] - grp[:, 1][None, :])
        cheb = np.maximum(dx, dy)
        np.fill_diagonal(cheb, stamp + 1)
        if (cheb <= stamp).any():
            return False
        if v == v_boundary and n_unfilled == 0:
            if not all((int(x), int(y)) in added_set
                       for x, y in zip(grp[:, 0], grp[:, 1])):
                return False
    return True
