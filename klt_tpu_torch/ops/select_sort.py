"""The head of the selection chain on the card: the plain torch version of
kernel S (csrc/select_sort.cu, wrapped by cuda/select_sort.py), which the
tests hold the kernel and lazy_select.c against, and the constants the
tracker runs the kernel with.

A replacement's walk (native.LazySort) reads a few thousand rows of the
reference's candidate list of 255,744 (640x480), but the host chain builds
the whole list and partitions all of it before the walk reads its head.
Kernel S does that O(n) part where the response already lies:

* its list entry (`candidate_list_plain`) writes the list of
  lazy_select.c::klt_candidate_list into an int32 [n, 3] buffer and starts
  a lazy sort's state (lazy_select.c layout) with the one range [0, n)
  pending;
* its partition entry (`head_partitions_plain`) makes
  klt_sort_points_desc's partitions of every pending range that meets rows
  [0, K0) and holds more than S_MIN rows, leftmost first, with the same
  swaps, so that the host resumes the sort from the state
  (`native.LazySort.resume`) on a prefix of the list.

Ranges are partitioned where the full quicksort partitions them, and a
range's partition depends only on its own rows, so the list and the state
are those that the host's own partitions of the same ranges leave.

One partition of rows [lo, hi), n = hi - lo, in the pairing form that runs
in parallel: swap row n/2 to the front (its value P is the pivot); L are
the positions in [1, n) with value <= P, ascending, R those with value >=
P, descending; Hoare's loop swaps L[k] with R[k] for each k below m, the
number of leading k with L[k] < R[k], and stops at j = R[m] where R[m]
exists and lies beyond L[m - 1], else at L[m - 1] (0 when m = 0); then rows
j and 0 swap.  A position p of L is swapped exactly when more positions of
R lie after it than of L before it (its rank k = #L before p, and L[k] <
R[k]), and a position of R likewise: each row finds its own destination
from two prefix counts.
"""

from __future__ import annotations

import torch

from .. import native
from ..config import TrackingConfig
from .selection import _candidate_borders

# The walk reads at most K0 rows at the tail of a live replacement; the
# card partitions every range that meets them and holds more than S_MIN
# rows, at most ROUNDS ranges a call (a quicksort that degenerates leaves
# the rest to the host).  Chosen from measurements on an H100 (PERF.md):
# a partition on the card costs what the host's of about 4,300 rows does,
# and of the live cell's walks only a selection into all-lost slots reads
# past the head that comes back.
K0 = 8192
S_MIN = 4096
ROUNDS = 64

_INT_MIN = -2 ** 31


def prefix_rows(n: int) -> int:
    """The rows of a list of n that come back after the partition entry:
    every range that meets rows [0, K0) then ends before K0 + S_MIN, unless
    the cap on pending ranges or ROUNDS stopped the card."""
    return min(n, K0 + S_MIN)


def truncate_plain(resp: torch.Tensor) -> torch.Tensor:
    """C's (int) cast of f32 values as lazy_select.c::truncate_value makes
    it: toward zero in range, INT32_MIN for NaN and beyond int32."""
    ok = (resp >= -2147483648.0) & (resp < 2147483648.0)
    return torch.where(ok, torch.where(ok, resp, 0.0).to(torch.int32),
                       _INT_MIN)


def start_state(state: torch.Tensor, n: int) -> None:
    """A lazy sort's state (int64 [3 + 2 * cap], state[0] the cap) with
    the one range [0, n) pending, as klt_lazy_sort_begin starts it."""
    if n < 2:
        state[1:3] = torch.tensor([0, n])
    else:
        state[1:5] = torch.tensor([1, 0, 0, n])


def candidate_list_plain(resp: torch.Tensor, cfg: TrackingConfig,
                         out: torch.Tensor, state: torch.Tensor) -> None:
    """Plain torch version of S's list entry: the rows (x, y, (int)resp[y,
    x]) of the grid inside the borders, row-major, into out (int32 [n, 3]);
    state (int64 [3 + 2 * cap]) gets the cap native.LAZY_PENDING and the
    range [0, n) pending."""
    h, w = resp.shape
    borderx, bordery, step = _candidate_borders(cfg)
    ys, xs = (torch.tensor(range(b, size - b, step), dtype=torch.int64,
                           device=resp.device)
              for b, size in ((bordery, h), (borderx, w)))
    n = ys.numel() * xs.numel()
    if out.shape != (n, 3) or state.numel() != 3 + 2 * native.LAZY_PENDING:
        raise ValueError(f"expected an int32 [{n}, 3] list and an int64 "
                         f"[{3 + 2 * native.LAZY_PENDING}] state")
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    out[:, 0] = gx.reshape(-1)
    out[:, 1] = gy.reshape(-1)
    out[:, 2] = truncate_plain(resp[gy, gx]).reshape(-1)
    state[0] = native.LAZY_PENDING
    start_state(state, n)


def partition_plain(rows: torch.Tensor, lo: int, hi: int) -> int:
    """One partition of klt_sort_points_desc on rows [lo, hi) (at least
    two) of the int32 [n, 3] list, in place, in the pairing form (module
    docstring).  Returns the pivot's final position, relative to lo."""
    seg = rows[lo:hi]
    n = hi - lo
    seg[[0, n // 2]] = seg[[n // 2, 0]]
    v = seg[:, 2]
    pos = torch.arange(n, device=rows.device)
    le = (v <= v[0]) & (pos >= 1)
    ge = (v >= v[0]) & (pos >= 1)
    le_before = le.cumsum(0) - le.long()        # #L before p
    ge_after = ge.sum() - ge.cumsum(0)          # #R after p
    swap_l = le & (ge_after > le_before)
    swap_r = ge & (le_before > ge_after)
    left, right = pos[swap_l], pos[swap_r].flip(0)
    seg[left], seg[right] = seg[right].clone(), seg[left].clone()
    l_last = int(left[-1]) if left.numel() else 0
    kept = pos[ge & ~swap_r]
    r_next = int(kept[-1]) if kept.numel() else -1
    j = r_next if r_next > l_last else l_last
    seg[[0, j]] = seg[[j, 0]]
    return j


def head_partitions_plain(rows: torch.Tensor, state: torch.Tensor,
                          k0: int = K0, s_min: int = S_MIN,
                          rounds: int = ROUNDS) -> int:
    """Plain torch version of S's partition entry: while some pending
    range of `state` meets rows [0, k0) and holds more than s_min rows,
    and partitioning it keeps at most state[0] ranges pending, partition
    the leftmost such range (`partition_plain`), at most `rounds` times;
    the state as lazy_select.c's finalize_through leaves it: the right side
    below the left, ranges of fewer than two rows final.  Returns the
    partitions made."""
    n = rows.shape[0]
    st = [int(a) for a in state.tolist()]
    for made in range(rounds):
        cap, count = st[0], st[1]
        pick = None
        for k in range(count - 1, -1, -1):       # leftmost first
            lo, hi = st[3 + 2 * k], st[4 + 2 * k]
            if lo >= k0:
                break
            if hi - lo > s_min:
                pick = k if count + 1 <= cap else None
                break
        if pick is None:
            break
        lo, hi = st[3 + 2 * pick], st[4 + 2 * pick]
        j = lo + partition_plain(rows, lo, hi)
        sides = [r for r in ((j + 1, hi), (lo, j)) if r[1] - r[0] >= 2]
        ranges = [tuple(st[3 + 2 * k:5 + 2 * k]) for k in range(count)]
        ranges[pick:pick + 1] = sides
        st[1] = len(ranges)
        st[3:3 + 2 * len(ranges)] = [a for r in ranges for a in r]
        st[2] = ranges[-1][0] if ranges else n
    else:
        made = rounds
    state[:len(st)] = torch.tensor(st, dtype=torch.int64)
    return made

