"""Front-end -> pose-graph -> bundle-adjustment assembly.

Counterpart of klt_tpu/slam/frontend.py.  Derives RELATIVE pose
measurements between keyframes from their shared tracks (each a tiny
two-pose bundle adjustment on padded, fixed shapes, all pairs solved at
once), chains them through the SE(3) pose graph (slam/pose_graph.py), and
hands the refined absolute poses to the full bundle adjustment as its
initialization.  All geometry comes from the tracked features themselves
— no external odometry.

The pairs are batched by hand rather than by `torch.func.vmap`: one plan
of segment sums over every pair's observations (ids offset by pair, the
padding left out), the dense Schur step on [n_pairs, 12, 12] systems and a
damping per pair.  As klt_tpu jits the pair solve, it runs as a program
of cuda/graph.py (`_PairSolve`): on the card every LM iteration after
the first replays a CUDA graph; `_pair_solve_eager` is the same loop
launch by launch, the reference it is held against.  The entry points
take numpy arrays and run on `default_device(device)`: the card unless
the caller names the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import default_device
from .ba import _Plan, _costs, _gn_step
from .chains import ba_translation_prior
from .pose_graph import PoseGraph, optimize_pose_graph
from .solvers import LMSolve


class _PairSolve(LMSolve):
    """`_pair_solve_eager` as a program (slam/solvers.py::LMSolve): the
    pairs' start, observations and weights copied into static buffers,
    an LM iteration (dense Schur step, accept test per pair) a step."""

    def __init__(self, t0, lm0, cam_idx, lm_idx, uv, weight, consts):
        super().__init__(t0.device)
        b, L = lm0.shape[0], lm0.shape[1]
        self.consts = consts
        self.plan = _Plan(cam_idx, lm_idx, 2, L, joint=True,
                          drop=weight == 0)
        self.uv, self.weight = uv.reshape(-1, 2).clone(), \
            weight.reshape(-1).clone()
        self.R = torch.eye(3, dtype=torch.float32,
                           device=t0.device).expand(b, 2, 3, 3).clone()
        self.t, self.lm = t0.clone(), lm0.clone()
        self.c = _costs(self.R, self.t, self.lm, self.plan, self.uv,
                        self.weight, consts)
        self.lam = torch.full((b,), 1e-2, dtype=torch.float32,
                              device=t0.device)

    def _iteration(self):
        new = _gn_step(self.R, self.t, self.lm, self.plan, self.uv,
                       self.weight, self.consts, self.lam, True)[:3]
        c_new = _costs(*new, self.plan, self.uv, self.weight, self.consts)
        ok = (c_new < self.c) & torch.isfinite(c_new)
        for a, b in zip(new, (self.R, self.t, self.lm)):
            torch.where(ok.reshape((-1,) + (1,) * (b.dim() - 1)), a, b,
                        out=b)
        torch.where(ok, torch.clamp(self.lam * 0.5, min=1e-6),
                    self.lam * 4.0, out=self.lam)
        torch.where(ok, c_new, self.c, out=self.c)


def _pair_solve(t0, lm0, cam_idx, lm_idx, uv, weight, fx, fy, cx, cy,
                iters: int):
    """Two-pose Levenberg-Marquardt solves of B pairs at once (tensors on
    one device): t0 [B, 2, 3], lm0 [B, L, 3], cam_idx, lm_idx [B, M],
    uv [B, M, 2], weight [B, M].  Returns (R [B, 2, 3, 3], t [B, 2, 3]),
    the caller's own.  The LM accept/reject is load-bearing: plain damped
    Gauss-Newton diverges (NaN) on real pairs with near-degenerate shared
    geometry."""
    solve = _PairSolve(t0, lm0, cam_idx, lm_idx, uv, weight,
                       (fx, fy, cx, cy))
    solve.lm_drive(iters)
    return solve.R.clone(), solve.t.clone()


def _pair_solve_eager(t0, lm0, cam_idx, lm_idx, uv, weight, fx, fy, cx, cy,
                      iters: int):
    """`_pair_solve` launch by launch: what its program is held
    against."""
    b, L = lm0.shape[0], lm0.shape[1]
    consts = (fx, fy, cx, cy)
    plan = _Plan(cam_idx, lm_idx, 2, L, joint=True, drop=weight == 0)
    uv, weight = uv.reshape(-1, 2), weight.reshape(-1)
    R = torch.eye(3, dtype=torch.float32,
                  device=t0.device).expand(b, 2, 3, 3)
    t, lm = t0, lm0
    c_cur = _costs(R, t, lm, plan, uv, weight, consts)
    lam = torch.full((b,), 1e-2, dtype=torch.float32, device=t0.device)
    for _ in range(iters):
        Rn, tn, lmn, _ = _gn_step(R, t, lm, plan, uv, weight, consts, lam,
                                  True)
        c_new = _costs(Rn, tn, lmn, plan, uv, weight, consts)
        ok = (c_new < c_cur) & torch.isfinite(c_new)
        R = torch.where(ok[:, None, None, None], Rn, R)
        t = torch.where(ok[:, None, None], tn, t)
        lm = torch.where(ok[:, None, None], lmn, lm)
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-6), lam * 4.0)
        c_cur = torch.where(ok, c_new, c_cur)
    return R, t


def _per_cam_sorted(lm_idx, cam_idx, u, v, n_pose):
    """Per-camera (landmark-sorted) observation slices.  One O(M log M)
    sort instead of per-pair O(M) scans over the full observation list."""
    order = np.argsort(cam_idx, kind="stable")
    cams, lms = cam_idx[order], lm_idx[order]
    us, vs = np.asarray(u)[order], np.asarray(v)[order]
    starts = np.searchsorted(cams, np.arange(n_pose))
    ends = np.searchsorted(cams, np.arange(n_pose) + 1)
    out = []
    for i in range(n_pose):
        sl = slice(int(starts[i]), int(ends[i]))
        li = lms[sl]
        o = np.argsort(li, kind="stable")
        out.append((li[o], us[sl][o], vs[sl][o]))
    return out


def _pair_arrays(per_cam, i, j, fx, fy, cx, cy, max_obs, t_prior):
    """Padded two-pose problem arrays over tracks seen by BOTH
    keyframes i and j (vectorised: intersect + searchsorted remap; a
    landmark appears at most once per camera).  Returns
    (t0, lm0, cam_idx, lm_idx, uv, weight, n_lm) as numpy arrays."""
    li_, ui_, vi_ = per_cam[i]
    lj_, uj_, vj_ = per_cam[j]
    shared = np.intersect1d(li_, lj_, assume_unique=True)
    n_lm = len(shared)
    mi = np.isin(li_, shared, assume_unique=True)
    mj = np.isin(lj_, shared, assume_unique=True)
    li_s = np.searchsorted(shared, li_[mi]).astype(np.int32)
    lj_s = np.searchsorted(shared, lj_[mj]).astype(np.int32)
    m = len(li_s) + len(lj_s)
    if n_lm and m > max_obs:
        # defensive only (max_obs is sized over every pair solved):
        # drop whole landmarks from the top so no pair is orphaned
        keep_lm = min(n_lm, max_obs // 2)
        li_keep, lj_keep = li_s < keep_lm, lj_s < keep_lm
        mi[mi] = li_keep
        mj[mj] = lj_keep
        li_s, lj_s = li_s[li_keep], lj_s[lj_keep]
        n_lm = keep_lm
        m = len(li_s) + len(lj_s)

    lm0 = np.zeros((max_obs, 3), np.float32)
    lm0[li_s, 0] = (ui_[mi] - cx) / fx
    lm0[li_s, 1] = (vi_[mi] - cy) / fy
    lm0[li_s, 2] = 1.0
    lm0[n_lm:, 2] = 1.0
    pad = max_obs - m
    cam = np.concatenate([np.zeros(len(li_s), np.int32),
                          np.ones(len(lj_s), np.int32),
                          np.zeros(pad, np.int32)])
    lm = np.concatenate([li_s, lj_s, np.zeros(pad, np.int32)])
    uu = np.concatenate([ui_[mi], uj_[mj],
                         np.zeros(pad, np.float32)]).astype(np.float32)
    vv = np.concatenate([vi_[mi], vj_[mj],
                         np.zeros(pad, np.float32)]).astype(np.float32)
    weight = np.concatenate([np.ones(m, np.float32),
                             np.zeros(pad, np.float32)])
    t0 = np.zeros((2, 3), np.float32)
    t0[1] = t_prior[j] - t_prior[i]
    return (t0, lm0, cam, lm, np.stack([uu, vv], -1), weight, n_lm)


def build_keyframe_pose_graph(lm_idx, cam_idx, u, v, n_pose,
                              fx, fy, cx, cy, pair_iters: int = 8,
                              device=None):
    """Construct the keyframe SE(3) pose graph (without optimizing it):
    a tiny two-pose BA per chain/skip keyframe pair — assembled
    vectorised on the host, solved all at once on the device — ->
    relative-pose edges, chained-integration absolute poses as the
    initial estimate.  Returns a PoseGraph on the device, ready for
    optimize_pose_graph."""
    dev = default_device(device)
    lm_idx = np.asarray(lm_idx)
    cam_idx = np.asarray(cam_idx)
    u, v = np.asarray(u), np.asarray(v)
    t_prior = ba_translation_prior(
        lm_idx, cam_idx, u, v, _first_obs(lm_idx), n_pose, fx, fy)
    per_cam = _per_cam_sorted(lm_idx, cam_idx, u, v, n_pose)

    # chain edges (i, i+1) plus redundant skip edges (i, i+2) so the
    # pose graph has over-determination to optimize, not a bare chain
    pairs = [(i, i + 1) for i in range(n_pose - 1)]
    pairs += [(i, i + 2) for i in range(n_pose - 2)]

    # one padded shape across pairs, sized by the shared-landmark
    # observation count of EVERY pair solved (skip edges included)
    def shared_obs(i, j):
        return 2 * len(np.intersect1d(per_cam[i][0], per_cam[j][0],
                                      assume_unique=True))

    max_obs = max([shared_obs(i, j) for i, j in pairs] + [1])
    max_obs = max(8, int(2 ** np.ceil(np.log2(max_obs))))

    # assemble every solvable pair, then solve them all in one batch
    solve_pairs, weak_chain = [], []
    for i, j in pairs:
        arrs = _pair_arrays(per_cam, i, j, fx, fy, cx, cy, max_obs,
                            t_prior)
        if arrs[-1] < 8:
            if j == i + 1:
                weak_chain.append((i, j))  # identity/prior edge
            continue  # drop weak skip edges entirely
        solve_pairs.append(((i, j), arrs[:-1]))

    edges = {}
    if solve_pairs:
        batch = [torch.from_numpy(np.stack([a[k] for _, a in solve_pairs]))
                 .to(dev) for k in range(6)]
        Rb, tb = (o.cpu().numpy() for o in _pair_solve(
            *batch, fx, fy, cx, cy, pair_iters))
        for k, ((i, j), _) in enumerate(solve_pairs):
            # Z_ij at the solved pair: (R_i R_j^T, t_i - R_i R_j^T t_j)
            Rrel = Rb[k, 0] @ Rb[k, 1].T
            edges[(i, j)] = (Rrel.astype(np.float32),
                             (tb[k, 0] - Rrel @ tb[k, 1]).astype(
                                 np.float32))
    for i, j in weak_chain:
        edges[(i, j)] = (np.eye(3, dtype=np.float32),
                         (t_prior[j] - t_prior[i]).astype(np.float32))

    Rz, tz, ei, ej = [], [], [], []
    for (i, j), (Rr, tr) in sorted(edges.items()):
        Rz.append(Rr)
        tz.append(tr)
        ei.append(i)
        ej.append(j)

    # chain integration (consecutive edges only) for the start point
    consec = {a: idx for idx, (a, b) in enumerate(zip(ei, ej))
              if b == a + 1}
    R0 = [np.eye(3, dtype=np.float32)]
    t0 = [np.zeros(3, np.float32)]
    for i in range(n_pose - 1):
        kk = consec[i]
        # T_j = Z_ij^-1 * T_i  (camera-from-world)
        Rj = Rz[kk].T @ R0[-1]
        tj = Rz[kk].T @ (t0[-1] - tz[kk])
        R0.append(Rj.astype(np.float32))
        t0.append(tj.astype(np.float32))

    f32 = lambda a: torch.from_numpy(np.stack(a).astype(np.float32)).to(dev)
    return PoseGraph(
        R=f32(R0), t=f32(t0),
        ei=torch.tensor(ei, dtype=torch.int32, device=dev),
        ej=torch.tensor(ej, dtype=torch.int32, device=dev),
        Rz=f32(Rz), tz=f32(tz),
        weight=torch.ones(len(ei), dtype=torch.float32, device=dev))


def keyframe_pose_graph_init(lm_idx, cam_idx, u, v, n_pose,
                             fx, fy, cx, cy, pair_iters: int = 8,
                             pg_iters: int = 10, device=None):
    """Absolute keyframe poses from tracked features only.

    1. build_keyframe_pose_graph: pairwise tiny BAs -> relative-pose
       edges + chained initial poses;
    2. SE(3) pose-graph optimization over chain + skip edges;
    3. returns numpy (R [P,3,3], t [P,3], costs [pg_iters]) for the full
       BA to start from."""
    pg = build_keyframe_pose_graph(lm_idx, cam_idx, u, v, n_pose,
                                   fx, fy, cx, cy, pair_iters, device)
    R, t, costs = optimize_pose_graph(pg, iterations=pg_iters)
    return R.cpu().numpy(), t.cpu().numpy(), costs.cpu().numpy()


def _first_obs(lm_idx):
    n_lm = int(lm_idx.max()) + 1 if len(lm_idx) else 0
    first = np.full(n_lm, -1, np.int64)
    ids, idx = np.unique(lm_idx, return_index=True)
    first[ids] = idx
    return first
