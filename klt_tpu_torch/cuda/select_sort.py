"""Wrappers of kernel S (csrc/select_sort.cu): a selection's candidate list
from a response map on the card, and the lazy quicksort's large
partitions of it, both enqueued on the current stream with no host wait.

The plain torch version of both is in `ops.select_sort`
(`candidate_list_plain`, `head_partitions_plain`).
"""

from __future__ import annotations

import torch

from .. import native
from ..config import TrackingConfig
from ..ops.selection import _candidate_borders
from . import SELECT_LIST, SELECT_PARTITIONS, check_cuda_tensor, load_library


def _check_list(rows: torch.Tensor, state: torch.Tensor) -> None:
    check_cuda_tensor(rows, "rows", torch.int32, 2)
    check_cuda_tensor(state, "state", torch.int64, 1)
    if rows.shape[1] != 3 or rows.device != state.device:
        raise ValueError(f"rows {tuple(rows.shape)} on {rows.device} and "
                         f"state on {state.device}: expected [n, 3] rows "
                         f"on the state's device")
    if state.numel() != 3 + 2 * native.LAZY_PENDING:
        raise ValueError(f"state holds {state.numel()} ints, expected "
                         f"{3 + 2 * native.LAZY_PENDING}")


def _enqueue(kernel, dev: torch.device, *args) -> None:
    """kernel(*args, stream) on dev's current stream.  Every live
    replacement enqueues both entries, so this takes the raw stream handle
    (torch.cuda.current_stream makes a Stream object: 7-10 us of host time
    beside an H100) and enters dev only when it is not current."""
    if torch.cuda.current_device() == dev.index:
        kernel(*args, torch._C._cuda_getCurrentRawStream(dev.index))
        return
    with torch.cuda.device(dev):
        kernel(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def scratch_for(n: int, device: torch.device) -> torch.Tensor:
    """The partition entry's scratch for lists of up to n rows, zeroed (its
    grid barrier starts at zero, and every call leaves it there)."""
    ints = load_library().klt_select_scratch_ints(n)
    return torch.zeros(ints, dtype=torch.int32, device=device)


def candidate_list_cuda(resp: torch.Tensor, cfg: TrackingConfig,
                        out: torch.Tensor, state: torch.Tensor) -> None:
    """The list of native.candidate_list from the f32 [H, W] map on the
    card into out (int32 [n, 3] there), and state (int64 [3 + 2 *
    native.LAZY_PENDING]) started with the range [0, n) pending; one
    launch."""
    check_cuda_tensor(resp, "resp", torch.float32, 2)
    _check_list(out, state)
    h, w = resp.shape
    borderx, bordery, step = _candidate_borders(cfg)
    nx = len(range(borderx, w - borderx, step))
    ny = len(range(bordery, h - bordery, step))
    if out.shape[0] != nx * ny or out.device != resp.device:
        raise ValueError(f"out is [{out.shape[0]}, 3] on {out.device}; the "
                         f"{w}x{h} map on {resp.device} has {nx * ny} rows")
    _enqueue(SELECT_LIST, resp.device, resp.data_ptr(), w, nx, ny, borderx,
             bordery, step, out.data_ptr(), state.data_ptr(),
             native.LAZY_PENDING)


def head_partitions_cuda(rows: torch.Tensor, state: torch.Tensor,
                         scratch: torch.Tensor, k0: int, s_min: int,
                         rounds: int) -> None:
    """`ops.select_sort.head_partitions_plain` on the card: the partitions
    of the pending ranges that meet rows [0, k0) and hold more than s_min
    rows, at most `rounds`, in one cooperative launch; scratch from
    `scratch_for` (at least this list's rows)."""
    _check_list(rows, state)
    check_cuda_tensor(scratch, "scratch", torch.int32, 1)
    if scratch.device != rows.device:
        raise ValueError("scratch lies on another device than the rows")
    _enqueue(SELECT_PARTITIONS, rows.device, rows.data_ptr(), rows.shape[0],
             state.data_ptr(), k0, s_min, rounds, scratch.data_ptr(),
             scratch.numel())
