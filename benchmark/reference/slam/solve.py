"""The SLAM back end's plain reference, written from the math in float64:
keyframe poses from two-pose bundle adjustments on the tracks that each
pair of keyframes shares, chained and refined by an SE(3) pose graph,
then a robust bundle adjustment gated by reprojection error.

Conventions (those of the tracking-to-map pipeline): a pose (R, t) maps
world points into the camera, p = R X + t, seen at (fx x / z + cx,
fy y / z + cy).  An update (w, d) of a pose is R <- exp(w) R,
t <- exp(w) t + d; a landmark moves by dX.  Levenberg-Marquardt damps
each normal-equation block by lam times its diagonal plus a small
constant, keeps the first pose fixed, accepts a step that lowers the
cost (lam halves) and otherwise keeps the state (lam grows four times).
The bundle adjustment eliminates the landmarks (Schur complement) and
solves the pose system exactly; the pose graph's Jacobians are central
differences.  `dtype` runs it all in another precision (the control in
bfloat16); linear solves and inverses then run in float32, which torch
needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .handoff import first_observation


@dataclasses.dataclass
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b; a singular A gives a step that is not finite, which the
    cost test then refuses."""
    if A.dtype in (torch.float64, torch.float32):
        return torch.linalg.solve_ex(A, b)[0]
    return torch.linalg.solve_ex(A.float(), b.float())[0].to(A.dtype)


def _inv(A: torch.Tensor) -> torch.Tensor:
    if A.dtype in (torch.float64, torch.float32):
        return torch.linalg.inv_ex(A)[0]
    return torch.linalg.inv_ex(A.float())[0].to(A.dtype)


def skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, [..., 3] -> [..., 3, 3]."""
    th2 = (w * w).sum(-1)[..., None, None]
    small = th2 < 1e-10
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = th2s.sqrt()
    a = torch.where(small, 1 - th2 / 6, th.sin() / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - th.cos()) / th2s)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """The rotation vector of R [..., 3, 3] (angles below pi)."""
    c = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2).clamp(-1, 1)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2
    s = w.norm(dim=-1)
    th = torch.atan2(s, c)
    small = s < 1e-12
    scale = torch.where(small, 1 + th * th / 6,
                        th / torch.where(small, torch.ones_like(s), s))
    return w * scale[..., None]


def _update(R, t, dx):
    dR = so3_exp(dx[..., :3])
    return dR @ R, (dR @ t[..., None])[..., 0] + dx[..., 3:]


# ---- bundle adjustment -------------------------------------------------

@dataclasses.dataclass
class Observations:
    cam: torch.Tensor       # int64 [M]
    lm: torch.Tensor        # int64 [M]
    uv: torch.Tensor        # [M, 2]


def residuals(R, t, X, obs: Observations, k: Intrinsics):
    """(projection - observation [M, 2], camera points [M, 3]); a point
    at or behind the camera is taken at depth 1e-8."""
    pc = (R[obs.cam] @ X[obs.lm][..., None])[..., 0] + t[obs.cam]
    pc = torch.cat([pc[:, :2], pc[:, 2:].clamp(min=1e-8)], -1)
    u = k.fx * pc[:, 0] / pc[:, 2] + k.cx
    v = k.fy * pc[:, 1] / pc[:, 2] + k.cy
    return torch.stack([u, v], -1) - obs.uv, pc


def jacobians(R, pc, obs: Observations, k: Intrinsics):
    """d residual / d (w, d) of the pose [M, 2, 6] and / d X [M, 2, 3]."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zero = torch.zeros_like(z)
    jpi = torch.stack([torch.stack([k.fx / z, zero, -k.fx * x / (z * z)], -1),
                       torch.stack([zero, k.fy / z, -k.fy * y / (z * z)], -1)],
                      -2)
    # exp(w) p = p + w x p: d p / d w = -[p]x
    jp = torch.cat([jpi @ -skew(pc), jpi], -1)
    return jp, jpi @ R[obs.cam]


def huber_scale(norms: torch.Tensor, delta: float) -> torch.Tensor:
    """The square root of the Huber weight of each residual norm."""
    return torch.where(norms <= delta, torch.ones_like(norms),
                       (delta / norms.clamp(min=delta)).sqrt())


def huber_loss(norms: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(norms <= delta, norms * norms,
                       2 * delta * norms - delta * delta)


def _damped(A, lam):
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return A + lam * torch.diag_embed(torch.diagonal(A, 0, -2, -1)) + \
        1e-6 * eye


def _ba_step(R, t, X, obs: Observations, k: Intrinsics, scale, lam):
    """One damped Gauss-Newton step, the landmarks eliminated and the
    pose system (the first pose fixed) solved exactly."""
    P, L = R.shape[0], X.shape[0]
    r, pc = residuals(R, t, X, obs, k)
    jp, jl = jacobians(R, pc, obs, k)
    r = r * scale[:, None]
    jp = jp * scale[:, None, None]
    jl = jl * scale[:, None, None]
    jpT, jlT = jp.transpose(1, 2), jl.transpose(1, 2)
    U = R.new_zeros(P, 6, 6).index_add_(0, obs.cam, jpT @ jp)
    gp = R.new_zeros(P, 6).index_add_(0, obs.cam,
                                      -(jpT @ r[..., None])[..., 0])
    V = R.new_zeros(L, 3, 3).index_add_(0, obs.lm, jlT @ jl)
    gl = R.new_zeros(L, 3).index_add_(0, obs.lm, -(jlT @ r[..., None])[..., 0])
    U, V = _damped(U, lam), _damped(V, lam)
    Vinv = _inv(V)
    A = R.new_zeros(L, P, 6, 3)
    A.index_put_((obs.lm, obs.cam), jpT @ jl, accumulate=True)
    A = A.reshape(L, 6 * P, 3)
    Y = A @ Vinv
    S = torch.block_diag(*U) - Y.permute(1, 0, 2).reshape(6 * P, 3 * L) @ \
        A.permute(1, 0, 2).reshape(6 * P, 3 * L).T
    rhs = gp.reshape(-1) - torch.einsum("lik,lk->i", Y, gl)
    # the first pose fixed; the rest solved with Jacobi scaling
    Sf, bf = S[6:, 6:], rhs[6:]
    d = torch.diagonal(Sf).clamp(min=1e-30).sqrt()
    dp = R.new_zeros(6 * P)
    dp[6:] = _solve(Sf / d[:, None] / d[None, :], (bf / d)[:, None])[:, 0] / d
    dX = (Vinv @ (gl - torch.einsum("lik,i->lk", A, dp))[..., None])[..., 0]
    Rn, tn = _update(R, t, dp.reshape(P, 6))
    return Rn, tn, X + dX


def _cost(R, t, X, obs, k, scale):
    r, _ = residuals(R, t, X, obs, k)
    return ((r * scale[:, None]) ** 2).sum()


def levenberg_marquardt(R, t, X, obs: Observations, k: Intrinsics,
                        weight, iterations: int, damping: float,
                        delta: float | None = None):
    """Bundle adjustment by Levenberg-Marquardt; with `delta` the Huber
    weights are taken anew at the start of each iteration.  Returns
    (R, t, X)."""
    lam = damping
    for _ in range(iterations):
        if delta is None:
            scale = weight
        else:
            r, _ = residuals(R, t, X, obs, k)
            scale = weight * huber_scale(r.norm(dim=-1), delta)
        c_cur = _cost(R, t, X, obs, k, scale)
        Rn, tn, Xn = _ba_step(R, t, X, obs, k, scale, lam)
        c_new = _cost(Rn, tn, Xn, obs, k, scale)
        if bool(c_new < c_cur):
            R, t, X = Rn, tn, Xn
            lam = max(lam / 2, 1e-6)
        else:
            lam *= 4
    return R, t, X


def refit_landmarks(R, t, X, obs: Observations, k: Intrinsics,
                    iterations: int, delta: float):
    """The poses fixed, each landmark moved by damped Gauss-Newton steps
    on its own Huber-weighted observations (every observation fed)."""
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iterations):
        r, pc = residuals(R, t, X, obs, k)
        s = huber_scale(r.norm(dim=-1), delta)
        _, jl = jacobians(R, pc, obs, k)
        r, jl = r * s[:, None], jl * s[:, None, None]
        jlT = jl.transpose(1, 2)
        V = X.new_zeros(X.shape[0], 3, 3).index_add_(0, obs.lm, jlT @ jl)
        g = X.new_zeros(X.shape[0], 3).index_add_(
            0, obs.lm, -(jlT @ r[..., None])[..., 0])
        X = X + _solve(V + 1e-4 * eye, g[..., None])[..., 0]
    return X


def gated_bundle_adjustment(R, t, X, obs: Observations, k: Intrinsics,
                            rounds: int, iterations: int,
                            damping: float = 10.0, delta: float = 2.0,
                            gate_px: float = 2.0, min_obs: int = 2):
    """Rounds of robust Levenberg-Marquardt (each from lam = damping) on
    the active observations.  Between rounds: the landmarks refit (3
    steps), then the active set taken anew: observations whose
    reprojection error is at most gate_px * 2^(rounds - 2 - round), of
    landmarks that keep `min_obs` of them, unless fewer than 6 would be
    left.  Returns (R, t, X, active [M] bool)."""
    active = torch.ones(obs.cam.shape[0], dtype=torch.bool,
                        device=obs.cam.device)
    for rd in range(rounds):
        R, t, X = levenberg_marquardt(R, t, X, obs, k, active.to(R.dtype),
                                      iterations, damping, delta)
        if rd == rounds - 1:
            break
        X = refit_landmarks(R, t, X, obs, k, 3, delta)
        r, _ = residuals(R, t, X, obs, k)
        act = r.norm(dim=-1) <= gate_px * 2.0 ** (rounds - 2 - rd)
        count = torch.zeros(X.shape[0], dtype=torch.int64,
                            device=X.device).index_add_(0, obs.lm,
                                                        act.long())
        act &= count[obs.lm] >= min_obs
        if int(act.sum()) < 6:
            break
        active = act
    return R, t, X, active


# ---- pose graph --------------------------------------------------------

def edge_residuals(Ri, ti, Rj, tj, Rz, tz):
    """[E, 6]: the measured relative pose Z_ij = (Rz, tz) against
    T_i T_j^-1 = (Ri Rj^T, ti - Ri Rj^T tj): the rotation vector of
    Rz^T Ri Rj^T, then Rz^T (ti - Ri Rj^T tj - tz)."""
    Rrel = Ri @ Rj.transpose(-1, -2)
    trel = ti - (Rrel @ tj[..., None])[..., 0]
    rw = so3_log(Rz.transpose(-1, -2) @ Rrel)
    rt = (Rz.transpose(-1, -2) @ (trel - tz)[..., None])[..., 0]
    return torch.cat([rw, rt], -1)


def _edge_jacobians(R, t, ei, ej, Rz, tz):
    """Central differences of the edge residuals with respect to the
    updates of pose i and of pose j: ([E, 6, 6], [E, 6, 6])."""
    h = float(torch.finfo(R.dtype).eps) ** (1 / 3)
    Ri, ti, Rj, tj = R[ei], t[ei], R[ej], t[ej]
    cols_i, cols_j = [], []
    for c in range(6):
        dx = R.new_zeros(len(ei), 6)
        dx[:, c] = h
        a = edge_residuals(*_update(Ri, ti, dx), Rj, tj, Rz, tz)
        b = edge_residuals(*_update(Ri, ti, -dx), Rj, tj, Rz, tz)
        cols_i.append((a - b) / (2 * h))
        a = edge_residuals(Ri, ti, *_update(Rj, tj, dx), Rz, tz)
        b = edge_residuals(Ri, ti, *_update(Rj, tj, -dx), Rz, tz)
        cols_j.append((a - b) / (2 * h))
    return torch.stack(cols_i, -1), torch.stack(cols_j, -1)


def pose_graph(R, t, ei, ej, Rz, tz, iterations: int,
               damping: float = 1e-3):
    """Levenberg-Marquardt on the edges' squared residuals (the first
    pose fixed, lam at least 1e-8).  Returns (R, t)."""
    P = R.shape[0]

    def cost(R, t):
        return (edge_residuals(R[ei], t[ei], R[ej], t[ej], Rz, tz) ** 2).sum()

    lam = damping
    c_cur = cost(R, t)
    for _ in range(iterations):
        r = edge_residuals(R[ei], t[ei], R[ej], t[ej], Rz, tz)
        ji, jj = _edge_jacobians(R, t, ei, ej, Rz, tz)
        H = R.new_zeros(P, P, 6, 6)
        for a, ja in ((ei, ji), (ej, jj)):
            for b, jb in ((ei, ji), (ej, jj)):
                H.index_put_((a, b), ja.transpose(1, 2) @ jb,
                             accumulate=True)
        g = R.new_zeros(P, 6)
        g.index_add_(0, ei, -(ji.transpose(1, 2) @ r[..., None])[..., 0])
        g.index_add_(0, ej, -(jj.transpose(1, 2) @ r[..., None])[..., 0])
        H = H.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        H = H + lam * torch.diag(torch.diagonal(H)) + \
            1e-8 * torch.eye(6 * P, dtype=H.dtype, device=H.device)
        Hf, bf = H[6:, 6:], g.reshape(-1)[6:]
        d = torch.diagonal(Hf).clamp(min=1e-30).sqrt()
        dx = R.new_zeros(6 * P)
        dx[6:] = _solve(Hf / d[:, None] / d[None, :],
                        (bf / d)[:, None])[:, 0] / d
        Rn, tn = _update(R, t, dx.reshape(P, 6))
        c_new = cost(Rn, tn)
        if bool(c_new < c_cur):
            R, t, c_cur = Rn, tn, c_new
            lam = max(lam / 2, 1e-8)
        else:
            lam *= 4
    return R, t


def translation_prior(lm_idx, cam_idx, u, v, n_pose, k: Intrinsics):
    """[P, 3] float64: each keyframe's median image motion against each
    landmark's first observation, over the focal length (tz = 0)."""
    first = first_observation(lm_idx)
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    du, dv = u - u[first[lm_idx]], v - v[first[lm_idx]]
    prior = np.zeros((n_pose, 3))
    for p in range(n_pose):
        m = cam_idx == p
        if m.any():
            prior[p, :2] = np.median(du[m]) / k.fx, np.median(dv[m]) / k.fy
    return prior


def keyframe_poses(lm_idx, cam_idx, u, v, n_pose: int, k: Intrinsics,
                   pair_iters: int, pg_iters: int, dtype, device):
    """The keyframes' poses: for each pair (i, i + 1) and (i, i + 2) that
    shares 8 landmarks or more, a two-pose bundle adjustment (landmarks
    at depth 1 along keyframe i's rays, pose j at the translation prior,
    lam from 1e-2, no robust weights) gives the edge T_i T_j^-1; a
    consecutive pair that shares fewer gets the prior's translation and
    no rotation, a skip pair none.  The consecutive edges chain into
    the start, which the pose graph refines.  Returns (R, t)."""
    lm_idx, cam_idx = np.asarray(lm_idx), np.asarray(cam_idx)
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    prior = translation_prior(lm_idx, cam_idx, u, v, n_pose, k)
    on = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device=device)
    eye = torch.eye(3, dtype=dtype, device=device)
    by_cam = [dict(zip(lm_idx[cam_idx == p].tolist(),
                       np.flatnonzero(cam_idx == p).tolist()))
              for p in range(n_pose)]
    edges = {}
    for i, j in ([(i, i + 1) for i in range(n_pose - 1)] +
                 [(i, i + 2) for i in range(n_pose - 2)]):
        shared = sorted(set(by_cam[i]) & set(by_cam[j]))
        if len(shared) < 8:
            if j == i + 1:
                edges[(i, j)] = (eye, on(prior[j] - prior[i]))
            continue
        oi = np.asarray([by_cam[i][s] for s in shared])
        oj = np.asarray([by_cam[j][s] for s in shared])
        X0 = np.stack([(u[oi] - k.cx) / k.fx, (v[oi] - k.cy) / k.fy,
                       np.ones(len(shared))], -1)
        n = len(shared)
        obs = Observations(
            cam=on(np.r_[np.zeros(n), np.ones(n)], torch.int64),
            lm=on(np.r_[np.arange(n), np.arange(n)], torch.int64),
            uv=on(np.stack([np.r_[u[oi], u[oj]], np.r_[v[oi], v[oj]]], -1)))
        t0 = np.zeros((2, 3))
        t0[1] = prior[j] - prior[i]
        R2, t2, _ = levenberg_marquardt(
            eye.expand(2, 3, 3).clone(), on(t0), on(X0), obs, k,
            torch.ones(2 * n, dtype=dtype, device=device), pair_iters, 1e-2)
        Rrel = R2[0] @ R2[1].T
        edges[(i, j)] = (Rrel, t2[0] - Rrel @ t2[1])
    keys = sorted(edges)
    Rs, ts = [eye], [torch.zeros(3, dtype=dtype, device=device)]
    for i in range(n_pose - 1):
        Rz, tz = edges[(i, i + 1)]
        Rs.append(Rz.T @ Rs[-1])
        ts.append(Rz.T @ (ts[-1] - tz))
    ei = on([a for a, _ in keys], torch.int64)
    ej = on([b for _, b in keys], torch.int64)
    Rz = torch.stack([edges[e][0] for e in keys])
    tz = torch.stack([edges[e][1] for e in keys])
    return pose_graph(torch.stack(Rs), torch.stack(ts), ei, ej, Rz, tz,
                      pg_iters)


def back_end(lm_idx, cam_idx, u, v, n_pose: int, k: Intrinsics, s: dict,
             dtype=torch.float64, device="cpu"):
    """The whole back end from the hand-off's observations: the pose
    graph's poses, then the gated bundle adjustment from them and from
    landmarks at depth 1 along their first observations' rays.  `s`:
    the configuration's "slam" group.  Returns a dict of tensors
    (pg_R, pg_t, R, t, X, active, start = the adjustment's (R, t, X) at
    its start) and its observations (obs)."""
    pg_R, pg_t = keyframe_poses(lm_idx, cam_idx, u, v, n_pose, k,
                                s["pair_iters"], s["pg_iters"], dtype,
                                device)
    first = first_observation(lm_idx)
    u64, v64 = np.asarray(u, np.float64), np.asarray(v, np.float64)
    X0 = np.stack([(u64[first] - k.cx) / k.fx, (v64[first] - k.cy) / k.fy,
                   np.ones(len(first))], -1)
    obs = Observations(
        cam=torch.as_tensor(np.asarray(cam_idx), dtype=torch.int64,
                            device=device),
        lm=torch.as_tensor(np.asarray(lm_idx), dtype=torch.int64,
                           device=device),
        uv=torch.as_tensor(np.stack([u64, v64], -1), dtype=dtype,
                           device=device))
    X0 = torch.as_tensor(X0, dtype=dtype, device=device)
    start = (pg_R, pg_t, X0)
    R, t, X, active = gated_bundle_adjustment(
        pg_R, pg_t, X0, obs, k, s["ba_rounds"], s["ba_iterations"],
        delta=s["robust_delta"], gate_px=s["gate_px"])
    return {"pg_R": pg_R, "pg_t": pg_t, "R": R, "t": t, "X": X,
            "active": active, "obs": obs, "start": start}


# ---- the compared numbers ----------------------------------------------

def pose_gap(R, t, R_ref, t_ref) -> float:
    """The larger of the widest rotation gap (radians) and the widest
    translation gap over the reference's widest translation."""
    R, t = R.to(R_ref), t.to(t_ref)
    rot = so3_log(R @ R_ref.transpose(-1, -2)).norm(dim=-1).max()
    trans = (t - t_ref).norm(dim=-1).max() / \
        t_ref.norm(dim=-1).max().clamp(min=1e-12)
    return _finite(max(float(rot), float(trans)))


def landmark_gap(X, X_ref) -> float:
    """The median landmark's gap over its distance from the origin."""
    X = X.to(X_ref)
    rel = (X - X_ref).norm(dim=-1) / X_ref.norm(dim=-1).clamp(min=1e-12)
    return _finite(float(rel.median()))


def loss_gap(R, t, X, ref: dict, k: Intrinsics, delta: float) -> float:
    """How much of the descent of the Huber loss, from the bundle
    adjustment's start to the reference's solution, (R, t, X) falls
    short of: (L(R, t, X) - L(ref)) / (L(start) - L(ref)), each loss
    over the reference's active observations (below 0 where (R, t, X)
    has the lower loss).  The monocular problem has nearly flat
    directions, along which float32 and float64 runs stop at different
    points; its descent does not."""
    obs, act = ref["obs"], ref["active"]
    dt = ref["R"].dtype

    def loss(R, t, X):
        r, _ = residuals(R.to(dt), t.to(dt), X.to(dt), obs, k)
        return float(huber_loss(r.norm(dim=-1), delta)[act].sum())

    end = loss(ref["R"], ref["t"], ref["X"])
    start = loss(*ref["start"])
    return _finite((loss(R, t, X) - end) / max(start - end, 1e-30))


def behind(R, t, X, obs: Observations, k: Intrinsics) -> int:
    """Observations whose point lies at or behind its camera."""
    dt = obs.uv.dtype
    pc = (R.to(dt)[obs.cam] @ X.to(dt)[obs.lm][..., None])[..., 0] + \
        t.to(dt)[obs.cam]
    return int((pc[:, 2] <= 1e-6).sum())


def nonfinite(X) -> int:
    """Landmarks with a coordinate that is not finite."""
    return int((~torch.isfinite(X)).any(-1).sum())


# a number that is not finite is reported as this, which no limit passes
NOT_FINITE = 1e9


def _finite(x: float) -> float:
    return x if np.isfinite(x) else NOT_FINITE
