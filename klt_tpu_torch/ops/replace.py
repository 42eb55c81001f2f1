"""Lost-feature replacement on the device.

The counterpart of klt_tpu/ops/replace.py and of the reference's
KLTReplaceLostFeatures (src/V1/selectGoodFeatures.c:514-541): compute the
min-eigenvalue response from the current frame's finest-level gradients
(the reference reuses the cached pyramid gradients in sequential mode,
src/V1/selectGoodFeatures.c:342-348), then greedily accept the best
candidate outside every live feature's suppression square, one per lost
slot.  Slots still lost when the candidates run out become NOT_FOUND at
(-1, -1), whatever their tracking code was.

The reference sorts all candidates descending and walks them, skipping
stamped ones, which is the same as repeatedly taking the masked argmax.
At equal truncated values the argmax takes the first candidate in
row-major order, where the reference takes whichever its quicksort put
first: both are valid greedy outcomes.  The host path
(runtime.tracker.KLTracker with klt_tpu_torch.native) keeps the
reference's order.

`replace_lost_` is kernel R's wrapper: CUDA tensors go to the replacement
kernel (csrc/replace.cu), which runs the whole pick loop in one launch and
never tells the host how many slots were lost; CPU tensors go to
`replace_lost_plain_`, which asks the host before every pick.

Suppression geometry: a Chebyshev square of radius mindist-1 (the
`mindist--` before _fillFeaturemap, src/V1/selectGoodFeatures.c:158-168).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import TrackingConfig, NOT_FOUND
from .selection import (corner_response, corner_response_plain,
                        _candidate_borders)


def _masked_response_int(resp: torch.Tensor, cfg: TrackingConfig
                         ) -> torch.Tensor:
    """Truncated int32 response with border / step / floor masking.
    Invalid pixels carry -1 (all valid candidates are >= floor >= 1).
    klt_tpu's function of this name takes the gradients; here the
    response arrives computed, by kernel D or its plain version."""
    h, w = resp.shape
    floor = max(1, int(cfg.min_eigenvalue))
    ri = resp.to(torch.int32)  # C (int) cast: truncation toward zero
    borderx, bordery, step = _candidate_borders(cfg)
    yi = torch.arange(h, device=resp.device)[:, None]
    xi = torch.arange(w, device=resp.device)[None, :]
    valid = ((yi >= bordery) & (yi < h - bordery) &
             (xi >= borderx) & (xi < w - borderx))
    if step > 1:
        valid &= (((yi - bordery) % step) == 0) & \
                 (((xi - borderx) % step) == 0)
    return torch.where(valid & (ri >= floor), ri, -1)


def _stamp_live_features(masked: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, val: torch.Tensor,
                         cfg: TrackingConfig) -> torch.Tensor:
    """Kill every candidate within the suppression square of a live
    feature: its truncated position scattered into a point map (centres
    outside the map stamp nothing), dilated by two 1-D max-pools."""
    h, w = masked.shape
    stamp = max(int(cfg.mindist) - 1, 0)
    fx = x.to(torch.int64)  # truncation toward zero, as (int)
    fy = y.to(torch.int64)
    inside = (val >= 0) & (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    flat = torch.where(inside, fy * w + fx, h * w)  # h*w: a spare cell
    pm = torch.zeros(h * w + 1, dtype=torch.float32, device=masked.device)
    pm[flat] = 1.0
    k = 2 * stamp + 1
    dil = F.max_pool2d(pm[:h * w].view(1, 1, h, w), (1, k), stride=1,
                       padding=(0, stamp))
    dil = F.max_pool2d(dil, (k, 1), stride=1, padding=(stamp, 0))[0, 0]
    return torch.where(dil > 0.5, -1, masked)


def replace_lost_plain_(resp: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor, val: torch.Tensor,
                        cfg: TrackingConfig) -> bool:
    """Plain torch version of kernel R, on any device: fill the lost
    slots of x, y, val in place from the f32 [H, W] response.  Reads the
    map's maximum and the lost slots back to the host before each pick.
    Returns True when at some pick more than one cell held the maximum
    (what the tie entry of kernel R reports)."""
    h, w = resp.shape
    floor = max(1, int(cfg.min_eigenvalue))
    stamp = max(int(cfg.mindist) - 1, 0)
    m = _stamp_live_features(_masked_response_int(resp, cfg), x, y, val,
                             cfg)
    flat = m.view(-1)
    tie = False
    while bool((val < 0).any()):
        idx = int(torch.argmax(flat))  # ties: the first in scan order
        v = int(flat[idx])
        if v < floor:
            break
        tie = tie or int((flat == v).sum()) > 1
        py, px = divmod(idx, w)
        slot = int(torch.argmax((val < 0).to(torch.uint8)))  # first lost
        x[slot] = float(px)
        y[slot] = float(py)
        val[slot] = v
        m[max(py - stamp, 0):py + stamp + 1,
          max(px - stamp, 0):px + stamp + 1] = -1
    lost = val < 0
    x.masked_fill_(lost, -1.0)
    y.masked_fill_(lost, -1.0)
    val.masked_fill_(lost, NOT_FOUND)
    return tie


def replace_lost_(resp: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  val: torch.Tensor, cfg: TrackingConfig,
                  plain: bool = False) -> None:
    """Kernel R's wrapper (contract of `replace_lost_plain_`).  CUDA: one
    launch of the replacement kernel.  CPU, or plain=True: the plain
    version."""
    if not plain and resp.device.type == "cuda":
        from ..cuda.replace import replace_lost_cuda_
        replace_lost_cuda_(resp, x, y, val, cfg)
        return
    if not plain and resp.device.type != "cpu":
        raise ValueError(f"no replacement path for device {resp.device}")
    replace_lost_plain_(resp, x, y, val, cfg)


def replace_lost_features_device(gx: torch.Tensor, gy: torch.Tensor,
                                 x: torch.Tensor, y: torch.Tensor,
                                 val: torch.Tensor, cfg: TrackingConfig,
                                 plain: bool = False):
    """Fill lost slots (val < 0) with fresh features, on the gradients'
    device.

    gx, gy: f32 [H, W] finest-level gradient maps of the CURRENT frame;
    x, y f32 [N]; val i32 [N].  Returns new (x, y, val): each lost slot
    either refilled (val = truncated response, like the reference's
    stored candidate value) or NOT_FOUND with x = y = -1 when no
    candidate of at least max(1, min_eigenvalue) survives suppression
    (src/V1/selectGoodFeatures.c:180-195).  plain=True runs the plain
    versions of kernels D and R on any device.
    """
    respond = corner_response_plain if plain else corner_response
    resp = respond(gx, gy, cfg.window_width, cfg.window_height)
    x, y, val = x.clone(), y.clone(), val.clone()
    replace_lost_(resp, x, y, val, cfg, plain=plain)
    return x, y, val
