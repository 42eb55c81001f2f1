"""The comparison that decides `correct`.

A checked step is one frame pair of the timed path: the state the program
started the step from (x, y, val [N]), its two frames, and what the
program produced: the state after tracking (where the path hands it out)
and the state after replacement.  The reference follows the step from the
program's own starting state and holds the program to it:

* tracking: every feature that the reference tracks, and with the state
  after tracking every feature, must carry the reference's bits of x, y
  and val (the port's kernels sum in the reference's order, so the two
  agree bit for bit);
* replacement: the lost slots, in slot order, must be a greedy outcome of
  the reference's candidate map (each the best candidate left, any one of
  equal truncated values: the reference's quicksort and a scan order pick
  different members of a tie, and both are the reference's greedy walk);
  slots that stay lost must be NOT_FOUND at (-1, -1) once no candidate is
  left, and features that were not lost must be left as they are.

Both numbers are counts of slots, compared exactly: their limit is 0.
A loop may compare later stages of its path too (`compare()`); the map's
are in loops/map.py and reference/slam/solve.py.
"""

from __future__ import annotations

import dataclasses

import torch

from . import klt

# counts compared exactly have the limit 0.  The map's back end (a cell
# that waits on the program: benchmark/pending) is held to a float64 solve
# of the same problem; its gaps' limits lie between the few sound runs
# and the controls (that solve in bfloat16) read so far, and are to be
# set again from a dozen sound seeds when the cell is measured
LIMITS = {"track_mismatch": 0, "replace_faults": 0, "handoff_mismatch": 0,
          "pose_graph_gap": 1e-2, "ba_pose_gap": 1e-2,
          "ba_landmark_gap": 1e-2, "ba_loss_gap": 1e-2}


@dataclasses.dataclass
class Step:
    img1: torch.Tensor                 # u8 [H, W]
    img2: torch.Tensor
    pre: tuple                         # (x, y, val) the step started from
    out: tuple                         # (x, y, val) after replacement
    tracked: tuple | None = None       # (x, y, val) after tracking


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _differ(a: tuple, b: tuple) -> torch.Tensor:
    """bool [N]: a slot whose x, y or val bits differ."""
    d = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    for u, v in zip(a, b):
        d |= _bits(u) != _bits(v.to(u.device))
    return d


def replace_faults(resp, tracked: tuple, out: tuple, cfg: klt.Config
                   ) -> int:
    """Lost slots of `tracked` whose value in `out` no greedy walk of
    the reference's candidate map, from the state `tracked`, would give
    (module docstring)."""
    x, y, val = tracked
    ox, oy, ov = (t.to(x.device) for t in out)
    live = val >= 0
    faults = 0
    m = klt.stamped_map(resp, x, y, val, cfg)
    flat = m.view(-1)
    h, w = m.shape
    floor = max(1, int(cfg.min_eigenvalue))
    rad = max(int(cfg.mindist) - 1, 0)
    lost = (~live).nonzero().flatten().tolist()
    oxs, oys, ovs = ox.tolist(), oy.tolist(), ov.tolist()
    for slot in lost:
        best = int(flat.max())
        px, py, pv = oxs[slot], oys[slot], ovs[slot]
        if best < floor:
            faults += int(not (px == -1.0 and py == -1.0 and
                               pv == klt.NOT_FOUND))
            continue
        ok = (pv == best and float(px).is_integer() and
              float(py).is_integer() and 0 <= px < w and 0 <= py < h and
              int(m[int(py), int(px)]) == best)
        if ok:
            klt.stamp(m, int(px), int(py), rad)
        else:
            faults += 1
            ry, rx = divmod(int(torch.argmax(flat)), w)
            klt.stamp(m, rx, ry, rad)
    return faults


def reference_step(step: Step, cfg: klt.Config, stats: list | None = None,
                   dtype: torch.dtype = torch.float32):
    """The reference's (tracked state, response of frame 2) for a step;
    `dtype` is the precision of its pyramid."""
    s1 = klt.pyramid(step.img1, cfg, dtype)
    s2 = klt.pyramid(step.img2, cfg, dtype)
    x, y, val = step.pre
    tracked = klt.track(s1, s2, x, y, val, cfg, stats)
    return tracked, klt.corner_response(s2[0][1], s2[0][2], cfg)


def judge(steps: list[Step], cfg: klt.Config,
          stats: list | None = None) -> dict:
    """The compared numbers over `steps` (LIMITS gives their limits)."""
    mismatch = faults = 0
    for st in steps:
        tracked, resp = reference_step(st, cfg, stats)
        live = tracked[2] >= 0
        if st.tracked is None:
            # the path hands out the state after replacement alone
            mismatch += int((live & _differ(tracked, st.out)).sum())
        else:
            mismatch += int(_differ(tracked, st.tracked).sum())
            # replacement leaves the features it was handed as they are
            faults += int((live & _differ(st.tracked, st.out)).sum())
        faults += replace_faults(resp, tracked, st.out, cfg)
    return {"track_mismatch": mismatch, "replace_faults": faults}


def control_step(step: Step, cfg: klt.Config,
                 dtype: torch.dtype = torch.bfloat16) -> Step:
    """The control in the program's place: the reference with its
    pyramid computed in `dtype`, from the same starting state."""
    tracked, resp = reference_step(step, cfg, dtype=dtype)
    out = klt.replace(resp, *tracked, cfg)
    return dataclasses.replace(step, out=out,
                               tracked=tracked if step.tracked is not None
                               else None)


def summary(numbers: dict) -> dict:
    """{name: {"value", "limit"}} of the compared numbers."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}


def passed(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
