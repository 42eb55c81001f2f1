"""Feature-table post-processing: observation chains + keyframes.

Counterpart of klt_tpu/slam/chains.py, host code (numpy) with the same
results element for element.  The reference's FeatureTable is an
nFeatures x nFrames grid of (x, y, val) records
(src/V1/klt.c:210-236); a feature's *chain* is the maximal run of frames
where val >= 0 starting from a (re)selection event (val > 0 marks a fresh
detection, val == 0 a successful track — src/V1/klt.h:28-33 semantics as
used by storeFeatures).  These run once per sequence and feed the
bundle adjustment with dense index arrays.
"""

from __future__ import annotations

import numpy as np


def tracks_from_table(x, y, val, min_length: int = 2):
    """Extract observation chains from a feature table.

    x, y, val: [N, T] arrays (feature-major, like KLT_FeatureTable).
    Returns (track_id [M], frame [M], u [M], v [M]) observation lists
    where M spans every (feature, frame) with val >= 0, with a new
    track id opened at every fresh detection (val > 0) and tracks
    shorter than `min_length` dropped.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    val = np.asarray(val)
    n, t = val.shape
    obs = val >= 0
    # a track starts at a fresh detection, or at the first observation
    # of a row / after a gap; ids are assigned in row-major encounter
    # order (cumulative count of starts), constant within each run
    prev_gap = np.concatenate([np.ones((n, 1), bool), ~obs[:, :-1]],
                              axis=1)
    starts = obs & ((val > 0) | prev_gap)
    sid = (np.cumsum(starts.ravel()) - 1).reshape(n, t)
    tid = sid[obs].astype(np.int32)
    frame = np.broadcast_to(np.arange(t, dtype=np.int32),
                            (n, t))[obs]
    us = x[obs].astype(np.float32)
    vs = y[obs].astype(np.float32)
    # drop short tracks and renumber densely (ids appear in ascending
    # order, so unique's inverse is the dense renumbering)
    ids, counts = np.unique(tid, return_counts=True)
    keep = np.isin(tid, ids[counts >= min_length])
    tid, frame, us, vs = tid[keep], frame[keep], us[keep], vs[keep]
    _, tid = np.unique(tid, return_inverse=True)
    return tid.astype(np.int32), frame, us, vs


def ba_translation_prior(lm_idx, cam_idx, u, v, first, n_pose,
                         fx: float, fy: float):
    """Median-flow translation prior for identity-rotation BA
    initialization.

    With unit-depth back-projected landmarks and identity rotations, a
    camera translation t shifts every projection by approximately
    (fx*tx, fy*ty), so the per-keyframe median flow against each track's
    DEFINING observation gives a closed-form translation guess that puts
    Gauss-Newton inside its convergence basin.

    lm_idx, cam_idx: [M] i32; u, v: [M] pixel observations;
    first: [L] index of each landmark's defining observation.
    Returns t0 [n_pose, 3] f32 (tz = 0).
    """
    u = np.asarray(u)
    v = np.asarray(v)
    du = u - u[first[lm_idx]]
    dv = v - v[first[lm_idx]]
    t0 = np.zeros((n_pose, 3), np.float32)
    for p in range(n_pose):
        m = cam_idx == p
        if m.any():
            t0[p, 0] = np.median(du[m]) / fx
            t0[p, 1] = np.median(dv[m]) / fy
    return t0


def select_keyframes(val, overlap_thresh: float = 0.6,
                     min_gap: int = 1):
    """Greedy keyframe selection by tracked-feature overlap.

    val: [N, T].  Frame 0 is always a keyframe; a new keyframe is opened
    when the fraction of the last keyframe's live features still tracked
    drops below `overlap_thresh`, but never closer than `min_gap` frames
    to the previous keyframe.  Returns sorted frame indices.
    """
    val = np.asarray(val)
    n, t = val.shape
    keyframes = [0]
    ref_alive = val[:, 0] >= 0
    surviving = ref_alive.copy()
    for j in range(1, t):
        # a slot only SURVIVES while it keeps tracking (val == 0);
        # val > 0 is a fresh replacement occupying the slot — a
        # different feature, which must not count as overlap
        surviving &= val[:, j] == 0
        ref_count = max(int(ref_alive.sum()), 1)
        overlap = float(surviving.sum()) / ref_count
        if overlap < overlap_thresh and j - keyframes[-1] >= min_gap:
            keyframes.append(j)
            ref_alive = val[:, j] >= 0
            surviving = ref_alive.copy()
    return np.asarray(keyframes, np.int32)
