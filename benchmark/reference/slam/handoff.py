"""From a feature table to the bundle adjustment's observations, written
from the semantics of the reference's FeatureTable (src/V1/klt.h: val > 0
a fresh selection, val == 0 a feature tracked on, val < 0 lost) and of
the tracking-to-map hand-off (chains of 3 frames or more, keyframes by
feature overlap, the observations on keyframes of tracks that two
keyframes or more see).  Plain numpy, row by row."""

from __future__ import annotations

import numpy as np


def chains(x, y, val, min_length: int = 3):
    """The observation chains of a table x, y, val [N, T]: a chain is a
    run of a feature's frames with val >= 0, which a fresh selection
    (val > 0) or a gap ends.  Chains are numbered as they are met, row by
    row and frame by frame; chains of fewer than `min_length` frames are
    dropped and the rest numbered again from 0 in the same order.
    Returns (chain [M], frame [M], u [M], v [M]) in that order."""
    x, y, val = (np.asarray(a) for a in (x, y, val))
    ids, frames, us, vs = [], [], [], []
    n_chain = 0
    for row in range(val.shape[0]):
        seen = np.flatnonzero(val[row] >= 0)
        if seen.size == 0:
            continue
        # a chain opens at the row's first observation, after a gap, and
        # at every fresh selection
        opens = np.ones(seen.size, bool)
        opens[1:] = (np.diff(seen) > 1) | (val[row, seen[1:]] > 0)
        which = np.cumsum(opens) - 1
        length = np.bincount(which)
        keep = length[which] >= min_length
        kept = np.flatnonzero(length >= min_length)
        renum = np.full(length.size, -1, np.int64)
        renum[kept] = n_chain + np.arange(kept.size)
        n_chain += kept.size
        ids.append(renum[which[keep]])
        frames.append(seen[keep])
        us.append(x[row, seen[keep]])
        vs.append(y[row, seen[keep]])
    cat = (lambda a, dt: np.concatenate(a).astype(dt) if a
           else np.zeros(0, dt))
    return (cat(ids, np.int32), cat(frames, np.int32),
            cat(us, np.float32), cat(vs, np.float32))


def keyframes(val, overlap: float):
    """Frame 0, then each frame at which the share of the last
    keyframe's live features that have been tracked on (val == 0) on
    every frame since falls below `overlap`."""
    val = np.asarray(val)
    kfs = [0]
    base = val[:, 0] >= 0
    still = base.copy()
    for t in range(1, val.shape[1]):
        still = still & (val[:, t] == 0)
        if still.sum() / max(int(base.sum()), 1) < overlap:
            kfs.append(t)
            base = val[:, t] >= 0
            still = base.copy()
    return np.asarray(kfs, np.int32)


def observations(x, y, val, overlap: float, min_length: int = 3):
    """The hand-off: (keyframes, lm_idx, cam_idx, u, v).  Keyframes by
    overlap (evenly spaced, every T // 4 frames, where fewer than 3
    open); the observations on keyframes of the chains that two
    keyframes or more see, in the chains' order, each chain a landmark
    numbered in that order.  Raises ValueError when none is left."""
    chain, frame, u, v = chains(x, y, val, min_length)
    t = np.asarray(val).shape[1]
    kfs = keyframes(val, overlap)
    if len(kfs) < 3:
        kfs = np.arange(0, t, max(1, t // 4), dtype=np.int32)
    cam_of = np.full(t, -1, np.int64)
    cam_of[kfs] = np.arange(len(kfs))
    on_kf = cam_of[frame] >= 0
    chain, frame, u, v = chain[on_kf], frame[on_kf], u[on_kf], v[on_kf]
    count = np.bincount(chain) if chain.size else np.zeros(0, np.int64)
    seen2 = count[chain] >= 2 if chain.size else np.zeros(0, bool)
    chain, frame, u, v = chain[seen2], frame[seen2], u[seen2], v[seen2]
    if chain.size == 0:
        raise ValueError("no chain seen on two keyframes")
    landmark = np.full(count.size, -1, np.int64)
    used = np.flatnonzero(count >= 2)
    landmark[used] = np.arange(used.size)
    return (kfs, landmark[chain].astype(np.int32),
            cam_of[frame].astype(np.int32), u, v)


def first_observation(lm_idx) -> np.ndarray:
    """The index of each landmark's first observation."""
    lm_idx = np.asarray(lm_idx)
    first = np.full(int(lm_idx.max()) + 1, lm_idx.size, np.int64)
    np.minimum.at(first, lm_idx, np.arange(lm_idx.size))
    return first
