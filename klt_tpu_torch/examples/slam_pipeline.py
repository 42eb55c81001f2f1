"""Example: the tracking-to-mapping pipeline on the card.

Runs the KLT front end over a PGM sequence (or, when no dataset is found,
over synthetic frames: a seeded texture translated by a known sub-pixel
path), converts the feature table to observation chains, selects
keyframes by feature overlap, initializes the keyframe poses through
pairwise two-pose BAs and the SE(3) pose graph, and refines poses and
landmarks by bundle adjustment (dense Schur, or matrix-free Schur/CG when
n_pose * n_lm > 50,000).

Usage:
    python -m klt_tpu_torch.examples.slam_pipeline [dataset] [nFeatures]
        [nFrames] [--host] [--chunk N] [--device cpu]

The front end is `track_sequence_replace` in chunks on the device (kernels
A, B, D and R on the card), or the host `KLTracker` loop with --host.  It
runs on the card; --device cpu takes the plain torch versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import klt_tpu_torch as klt
from klt_tpu_torch.device import default_device
from klt_tpu_torch.io.dataset import ImageSequence, find_dataset
from klt_tpu_torch.runtime.pipeline import track_sequence_replace
from klt_tpu_torch.slam import (BAProblem, bundle_adjust, bundle_adjust_cg,
                                select_keyframes, tracks_from_table)
from klt_tpu_torch.slam.frontend import keyframe_pose_graph_init


def synthetic_sequence(n_frames: int, rows: int = 240, cols: int = 320,
                       seed: int = 0) -> np.ndarray:
    """uint8 [T, rows, cols]: a seeded texture (noise, box-smoothed
    twice) translated by (3.2 sin 0.3k, 2.1 sin 0.23k) px in frame k,
    sampled bilinearly."""
    rng = np.random.RandomState(seed)
    tex = rng.uniform(0.0, 255.0, (rows + 16, cols + 16))
    for axis in (0, 1, 0, 1):
        tex = sum(np.roll(tex, s, axis) for s in range(-2, 3)) / 5.0
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float64) + 8.0
    out = np.empty((n_frames, rows, cols), np.uint8)
    for k in range(n_frames):
        sx = xx - 3.2 * np.sin(0.3 * k)
        sy = yy - 2.1 * np.sin(0.23 * k)
        x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
        fx, fy = sx - x0, sy - y0
        img = ((1 - fx) * (1 - fy) * tex[y0, x0] + fx * (1 - fy) *
               tex[y0, x0 + 1] + (1 - fx) * fy * tex[y0 + 1, x0] +
               fx * fy * tex[y0 + 1, x0 + 1])
        out[k] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return out


def frontend_device(frames, n_features, cfg, chunk, dev):
    """track_sequence_replace in chunks of `chunk` frame pairs, frames and
    features on the device; returns (FeatureTable, frame pairs/s)."""
    n_frames = len(frames)
    fl = klt.FeatureList.create(n_features)
    klt.KLTracker(cfg, device=dev).select_good_features(frames[0], fl)
    ft = klt.FeatureTable.create(n_frames, n_features)
    ft.store_list(fl, 0)
    feats = [torch.from_numpy(a).to(dev) for a in (fl.x, fl.y, fl.val)]
    t0 = time.perf_counter()
    done = 1
    while done < n_frames:
        hi = min(done + chunk, n_frames)
        # a chunk carries its first frame for the pair step
        batch = torch.from_numpy(np.stack(
            [frames[i] for i in range(done - 1, hi)])).to(dev)
        xs, ys, vs = track_sequence_replace(batch, *feats, cfg)
        ft.x[:, done:hi] = xs.cpu().numpy().T
        ft.y[:, done:hi] = ys.cpu().numpy().T
        ft.val[:, done:hi] = vs.cpu().numpy().T
        feats = [xs[-1], ys[-1], vs[-1]]
        done = hi
    return ft, (n_frames - 1) / (time.perf_counter() - t0)


def frontend_host(frames, n_features, cfg, dev):
    """The reference-style loop: KLTracker track + replace per frame."""
    n_frames = len(frames)
    tracker = klt.KLTracker(cfg, device=dev)
    fl = klt.FeatureList.create(n_features)
    ft = klt.FeatureTable.create(n_frames, n_features)
    tracker.select_good_features(frames[0], fl)
    ft.store_list(fl, 0)
    t0 = time.perf_counter()
    for i in range(1, n_frames):
        tracker.track_features(frames[i - 1], frames[i], fl)
        tracker.replace_lost_features(frames[i], fl)
        ft.store_list(fl, i)
    return ft, (n_frames - 1) / (time.perf_counter() - t0)


def keyframe_observations(table):
    """klt_tpu's bench hand-off (bench_slam_e2e): chains of length >= 3,
    keyframes at overlap 0.8 (evenly spaced instead when fewer than 3
    open: a well-tracked clip), observations on keyframes of tracks seen
    on at least two of them.  table: a FeatureTable.  Returns (keyframes,
    lm_idx, cam_idx, u, v); raises ValueError when nothing is left to
    adjust."""
    tid, frame, u, v = tracks_from_table(table.x, table.y, table.val,
                                         min_length=3)
    if len(tid) == 0:
        raise ValueError("no tracks of length >= 3; nothing to adjust")
    n_frames = table.val.shape[1]
    kfs = select_keyframes(table.val, overlap_thresh=0.8)
    if len(kfs) < 3:
        kfs = np.arange(0, n_frames, max(1, n_frames // 4), dtype=np.int32)
    kf_set = {int(f): i for i, f in enumerate(kfs)}
    keep = np.isin(frame, kfs)
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    ids, counts = np.unique(tid, return_counts=True)
    keep = np.isin(tid, ids[counts >= 2])
    tid, frame, u, v = tid[keep], frame[keep], u[keep], v[keep]
    if len(tid) == 0:
        raise ValueError("no multi-keyframe tracks; nothing to adjust")
    _, lm_idx = np.unique(tid, return_inverse=True)
    cam_idx = np.asarray([kf_set[int(f)] for f in frame], np.int32)
    return kfs, lm_idx.astype(np.int32), cam_idx, u, v


def unit_depth_landmarks(lm_idx, u, v, fx, fy, cx, cy):
    """Each landmark back-projected at depth 1 from its first
    observation."""
    n_lm = int(lm_idx.max()) + 1
    first = np.full(n_lm, -1, np.int64)
    ids, idx = np.unique(lm_idx, return_index=True)
    first[ids] = idx
    lm0 = np.zeros((n_lm, 3), np.float32)
    lm0[:, 0] = (u[first] - cx) / fx
    lm0[:, 1] = (v[first] - cy) / fy
    lm0[:, 2] = 1.0
    return lm0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="KLT front end -> SLAM back "
                                 "end pipeline on the card")
    ap.add_argument("dataset", nargs="?", default="images_provided")
    ap.add_argument("n_features", nargs="?", type=int, default=150)
    ap.add_argument("n_frames", nargs="?", type=int, default=10)
    ap.add_argument("--host", action="store_true",
                    help="the KLTracker loop instead of the device run")
    ap.add_argument("--chunk", type=int, default=64,
                    help="frame pairs per track_sequence_replace call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu for the "
                         "plain torch versions)")
    ns = ap.parse_args(argv)
    dev = default_device(ns.device)
    klt.set_verbosity(0)

    path = find_dataset(ns.dataset)
    if path is not None:
        seq = ImageSequence(path)
        frames = [seq[i] for i in range(min(ns.n_frames, len(seq)))]
        source = ns.dataset
    else:
        frames = list(synthetic_sequence(ns.n_frames))
        source = "synthetic"
    n_frames = len(frames)
    if n_frames < 2:
        sys.exit("need at least two frames")

    cfg = klt.TrackingConfig(sequential_mode=True)
    if ns.host:
        ft, fps = frontend_host(frames, ns.n_features, cfg, dev)
    else:
        ft, fps = frontend_device(frames, ns.n_features, cfg, ns.chunk, dev)
    print(f"front end ({source}, {dev}): {n_frames - 1} frame pairs at "
          f"{fps:.1f} fps ({'host loop' if ns.host else 'device run'})")

    try:
        kfs, lm_idx, cam_idx, u, v = keyframe_observations(ft)
    except ValueError as e:
        sys.exit(str(e))
    n_pose, n_lm = len(kfs), int(lm_idx.max()) + 1
    print(f"{n_lm} landmarks / {len(lm_idx)} observations on "
          f"{n_pose} keyframes")
    h, w = frames[0].shape
    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    lm0 = unit_depth_landmarks(lm_idx, u, v, fx, fy, cx, cy)

    # front end -> pose graph -> BA: relative poses from tiny two-pose
    # BAs on shared tracks, chained through the SE(3) pose graph
    R_init, t_init, pg_costs = keyframe_pose_graph_init(
        lm_idx, cam_idx, u, v, n_pose, fx, fy, cx, cy, device=dev)
    print(f"pose graph: cost {float(pg_costs[0]):.3e} -> "
          f"{float(pg_costs[-1]):.3e}")
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    prob = BAProblem(
        R=on(R_init), t=on(t_init), landmarks=on(lm0), cam_idx=on(cam_idx),
        lm_idx=on(lm_idx), uv=on(np.stack([u, v], -1).astype(np.float32)),
        weight=torch.ones(len(cam_idx), dtype=torch.float32, device=dev),
        fx=fx, fy=fy, cx=cx, cy=cy)

    t0 = time.perf_counter()
    if n_pose * n_lm > 50_000:  # dense W would not scale
        R, t, lm, costs = bundle_adjust_cg(prob, iterations=20)
        solver = "schur-cg"
    else:
        R, t, lm, costs = bundle_adjust(prob, iterations=20)
        solver = "schur-dense"
    costs = costs.cpu().numpy()
    ba_s = time.perf_counter() - t0
    rms0 = float(np.sqrt(costs[0] / max(len(cam_idx), 1)))
    rms1 = float(np.sqrt(costs[-1] / max(len(cam_idx), 1)))
    print(f"BA ({solver}): {n_pose} keyframes x {n_lm} landmarks, "
          f"{len(cam_idx)} observations, {ba_s:.1f}s")
    print(f"reprojection rms: {rms0:.3f} -> {rms1:.3f} px")
    print(json.dumps({
        "dataset": source, "device": str(dev),
        "frontend_fps": round(fps, 1), "n_frames": n_frames,
        "n_features": ns.n_features, "n_keyframes": int(n_pose),
        "n_landmarks": int(n_lm), "n_observations": int(len(cam_idx)),
        "ba_solver": solver, "ba_seconds": round(ba_s, 2),
        "reproj_rms_px_before": round(rms0, 4),
        "reproj_rms_px_after": round(rms1, 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
