"""Feature-table parity metrics against a reference run.

The counterpart of klt_tpu/utils/parity.py.  With per-frame replacement,
an integer tie of the response (or a one-count difference in it) can make
two runs refill a lost slot with different features; from that frame on
the slot holds a different track in each run, and comparing its positions
says nothing about tracking.  The same-detection metrics therefore take
only the (slot, frame) entries whose current track began at the same
frame and the same detection position in both runs, and
same_detection_frac says how much of the table that covers.
"""

from __future__ import annotations

import numpy as np


def detection_epochs(val: np.ndarray) -> np.ndarray:
    """Per (slot, frame), the frame on which the slot's current track was
    detected.

    val: int [N, T] feature-table values (val > 0 marks a fresh detection
    in the slot; column 0 is the first selection).  Returns int [N, T];
    -1 before a slot's first occupation."""
    n, t = val.shape
    fresh = val > 0
    fresh[:, 0] = val[:, 0] >= 0
    idx = np.where(fresh, np.arange(t, dtype=np.int64)[None, :], -1)
    return np.maximum.accumulate(idx, axis=1)


def table_parity_stats(x_r, y_r, v_r, x_o, y_o, v_o,
                       horizon: int | None = None) -> dict:
    """Parity of a tracked table with a reference table (both [N, T],
    column-aligned, the first selection at column 0; `horizon` keeps the
    first frames only): status agreement, drift of the slots live in
    both, and the same over the same-detection entries."""
    x_r, y_r, v_r = (np.asarray(a) for a in (x_r, y_r, v_r))
    x_o, y_o, v_o = (np.asarray(a) for a in (x_o, y_o, v_o))
    if horizon is not None:
        x_r, y_r, v_r = x_r[:, :horizon], y_r[:, :horizon], v_r[:, :horizon]
        x_o, y_o, v_o = x_o[:, :horizon], y_o[:, :horizon], v_o[:, :horizon]
    n, t = v_r.shape
    live_r, live_o = v_r >= 0, v_o >= 0
    both = live_r & live_o
    ep_r = detection_epochs(v_r)
    ep_o = detection_epochs(v_o)
    rows = np.arange(n)[:, None]
    epc = np.clip(ep_r, 0, t - 1)
    same = ((ep_r == ep_o) & (ep_r >= 0) &
            (x_r[rows, epc] == x_o[rows, epc]) &
            (y_r[rows, epc] == y_o[rows, epc]))
    d = np.hypot(x_r - x_o, y_r - y_o)
    db = d[both]
    ds = d[same & both]
    nb = max(int(both.sum()), 1)
    return {
        "status_agreement": round(float((live_r == live_o).mean()), 4),
        "within_half_px": round(float((db <= 0.5).mean())
                                if db.size else 1.0, 4),
        "drift_px_median": float(np.median(db)) if db.size else 0.0,
        "drift_px_p99": float(np.percentile(db, 99)) if db.size else 0.0,
        "same_detection_frac": round(float((same & both).sum() / nb), 4),
        "within_half_px_same_detection": round(
            float((ds <= 0.5).mean()) if ds.size else 1.0, 4),
        "drift_px_p99_same_detection": float(
            np.percentile(ds, 99)) if ds.size else 0.0,
    }
