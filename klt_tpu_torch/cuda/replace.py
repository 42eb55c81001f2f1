"""Wrappers of kernel R (csrc/replace.cu): greedy lost-feature replacement
from a response map, in place, and its tie entry, which also reports
whether a pick's maximum was not unique.

The plain torch version of both is `ops.replace.replace_lost_plain_`
(through `ops.replace_exact.replace_lost_exact_` for the tie entry).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..config import TrackingConfig
from ..ops.selection import _candidate_borders
from . import (REPLACE_LOST, REPLACE_LOST_TIE, REPLACE_MAX_TILES,
               REPLACE_TILE, check_cuda_tensor)

# The kernel's ticket (the count of finished blocks, by which the last one
# knows itself): one zeroed int per stream, which every call leaves 0.
# Calls on one stream run in order, so they can share it.
_tickets: dict[tuple[int, int], torch.Tensor] = {}

# Under a CUDA graph's capture, the ticket of the graph's program
# (cuda/graph.py), made and zeroed before the capture: one made inside it
# would be zeroed only by a node of the graph and would live in the
# graph's pool, and graphs replayed on other streams would share it.
_graph_ticket: contextvars.ContextVar = contextvars.ContextVar(
    "klt_replace_graph_ticket", default=None)


@contextlib.contextmanager
def graph_ticket(ticket: torch.Tensor):
    """Kernel R (both entries) takes `ticket`, a zeroed one-element int32
    tensor, while this context captures a graph."""
    token = _graph_ticket.set(ticket)
    try:
        yield
    finally:
        _graph_ticket.reset(token)


def _launch(kernel, resp, x, y, val, cfg: TrackingConfig, tie=None) -> None:
    check_cuda_tensor(resp, "resp", torch.float32, 2)
    check_cuda_tensor(x, "x", torch.float32, 1)
    check_cuda_tensor(y, "y", torch.float32, 1)
    check_cuda_tensor(val, "val", torch.int32, 1)
    n = x.shape[0]
    if y.shape[0] != n or val.shape[0] != n:
        raise ValueError(f"x, y, val hold {n}, {y.shape[0]}, "
                         f"{val.shape[0]} features")
    group = (resp, x, y, val) if tie is None else (resp, x, y, val, tie)
    devs = {t.device for t in group}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    h, w = resp.shape
    borderx, bordery, step = _candidate_borders(cfg)
    dev = resp.device
    n_tiles = -(-h // REPLACE_TILE) * -(-w // REPLACE_TILE)
    if n_tiles > REPLACE_MAX_TILES or h > 0x7fff or w > 0xffff:
        raise ValueError(f"a {w}x{h} map has {n_tiles} tiles; kernel R takes "
                         f"{REPLACE_MAX_TILES}, at most 65535 columns and "
                         f"32767 rows")
    # the int map, then each tile's best value, its position and, in the
    # tie entry, its count
    per_tile = 2 if tie is None else 3
    scratch = torch.empty(h * w + per_tile * n_tiles, dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ticket = _graph_ticket.get()
        if ticket is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("kernel R captured without its graph's "
                                   "ticket (cuda.replace.graph_ticket)")
            ticket = _tickets.get((dev.index, stream))
            if ticket is None:
                ticket = _tickets[dev.index, stream] = torch.zeros(
                    1, dtype=torch.int32, device=dev)
        args = [resp.data_ptr(), h, w, x.data_ptr(), y.data_ptr(),
                val.data_ptr(), n, borderx, bordery, step,
                max(1, int(cfg.min_eigenvalue)),
                max(int(cfg.mindist) - 1, 0), scratch.data_ptr(),
                ticket.data_ptr()]
        if tie is not None:
            args.append(tie.data_ptr())
        kernel(*args, stream)


def replace_lost_cuda_(resp: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       val: torch.Tensor, cfg: TrackingConfig) -> None:
    """Fill the lost slots (val < 0) of x, y, val from the f32 [H, W]
    response, one kernel call, on the stream: nothing is read back."""
    _launch(REPLACE_LOST, resp, x, y, val, cfg)


def replace_lost_tie_cuda_(resp: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor, val: torch.Tensor,
                           cfg: TrackingConfig, tie: torch.Tensor) -> None:
    """`replace_lost_cuda_` through kernel R's tie entry, which also sets
    the int32 `tie` (one element, any offset into a CUDA tensor) to 1 when
    at some pick more than one cell held the map's maximum, else to 0."""
    if not isinstance(tie, torch.Tensor) or tie.device.type != "cuda" or \
            tie.dtype != torch.int32 or tie.numel() != 1:
        raise ValueError("tie must be a one-element int32 CUDA tensor")
    _launch(REPLACE_LOST_TIE, resp, x, y, val, cfg, tie)
