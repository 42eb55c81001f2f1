"""Sparse bundle adjustment via the Schur complement, on one device.

Counterpart of klt_tpu/slam/ba.py.  The normal equations have the arrow
structure

    [ U   W ] [dx_pose]   [ b_p ]
    [ W^T V ] [dx_lm  ] = [ b_l ]

with U block-diagonal over poses (6x6), V block-diagonal over landmarks
(3x3).  The pose update solves the Schur complement S = U - W V^-1 W^T;
landmarks back-substitute.  Per-observation residuals and Jacobians come
from `torch.func.jacfwd` under `torch.func.vmap`; U, V, b and the dense W
are summed per segment in a fixed order (slam/solvers.py), so two runs on
the card give the same bits.  The LM loops keep their accept flags,
damping and cost curves on the device: an LM iteration asks the host
nothing on the dense path, and on the CG path only for CG's stop rule
(slam/solvers.py::pcg).  As klt_tpu compiles each solve into one XLA
program, a solve without a mesh runs as programs of cuda/graph.py
(`_Solve`, a slam/solvers.py::LMSolve): on the card each LM iteration
after the first, and each landmark refit step after a solve's first,
replays CUDA graphs.  `_lm_drive_eager` and `_refit_landmarks_eager` are
the same loops launch by launch: the reference the programs are held
against, and what a solve over a mesh runs (its all-reduces are not
captured).

The dense step takes a batch of B independent problems of one shape
(the keyframe pair solves of slam/frontend.py); the public entry points
solve one problem (B = 1).  With a mesh (parallel/mesh.py), as in
klt_tpu, the problem is padded to the mesh's "data" size and replicated
on every rank; only the normal equations are sharded: each rank sums
U, V, W, b_p, b_l and each CG matvec's observation sums over its
contiguous block of the observations, and one all_reduce over "data"
adds the blocks (klt_tpu's psum).  The LM accept test, the gate and the
landmark refit run on the whole problem, so every rank decides alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..utils.linalg import gj_solve_spd, inv3
from .geometry import project, se3_apply, se3_exp
from .solvers import LMSolve, Segments, Shard, data_size, pcg


@dataclasses.dataclass
class BAProblem:
    """Dense-indexed bundle adjustment problem, all tensors on one device.

    R: [P, 3, 3] f32; t: [P, 3] f32 — camera-from-world poses.
    landmarks: [L, 3] f32 world points.
    cam_idx, lm_idx: [M] int; uv: [M, 2] f32; weight: [M] f32
    (0 disables an observation — used for padding).
    fx, fy, cx, cy: floats.
    """

    R: torch.Tensor
    t: torch.Tensor
    landmarks: torch.Tensor
    cam_idx: torch.Tensor
    lm_idx: torch.Tensor
    uv: torch.Tensor
    weight: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float

    def pad_observations(self, multiple: int) -> "BAProblem":
        """Zero-weight observations of (pose 0, landmark 0) up to a
        multiple of `multiple` (the shard size of a mesh)."""
        m = self.cam_idx.shape[0]
        pad = (-m) % multiple
        if pad == 0:
            return self
        z = lambda a, v: torch.cat(
            [a, torch.full((pad,) + tuple(a.shape[1:]), v, dtype=a.dtype,
                           device=a.device)])
        return dataclasses.replace(
            self, cam_idx=z(self.cam_idx, 0), lm_idx=z(self.lm_idx, 0),
            uv=z(self.uv, 0.0), weight=z(self.weight, 0.0))

    @property
    def consts(self):
        return self.fx, self.fy, self.cx, self.cy


class _Plan:
    """Flat observation indices of B problems of P poses and L landmarks
    (cam_idx, lm_idx [B, M] local to each problem) and their segment
    layouts, built once per solve.  `drop` [B, M] marks rows left out of
    every sum (padding known to carry weight 0)."""

    def __init__(self, cam_idx, lm_idx, n_pose: int, n_lm: int,
                 joint: bool, drop=None):
        cam = cam_idx.reshape(-1, cam_idx.shape[-1]).long()
        lm = lm_idx.reshape(cam.shape).long()
        b, m = cam.shape
        off = torch.arange(b, device=cam.device)[:, None]
        self.B, self.M, self.P, self.L = b, m, n_pose, n_lm
        self.cam = (cam + off * n_pose).reshape(-1)
        self.lm = (lm + off * n_lm).reshape(-1)
        joint_id = self.lm * n_pose + cam.reshape(-1)
        if drop is not None:
            gone = drop.reshape(-1)
            neg = torch.full_like(self.cam, -1)
            seg = lambda a: torch.where(gone, neg, a)
        else:
            seg = lambda a: a
        self.seg_cam = Segments(seg(self.cam), b * n_pose)
        self.seg_lm = Segments(seg(self.lm), b * n_lm)
        self.seg_joint = Segments(seg(joint_id), b * n_lm * n_pose) \
            if joint else None


def _residual_one(xi, dlm, R, t, lm, uv, fx, fy, cx, cy):
    """Reprojection residual of one observation at local updates
    (xi, dlm)."""
    dR, dt = se3_exp(xi[None])
    p = se3_apply(R, t, lm + dlm)
    p = se3_apply(dR[0], dt[0], p)
    return project(p, fx, fy, cx, cy) - uv


def _gather(R, t, lm, plan: _Plan):
    return (R.reshape(-1, 3, 3)[plan.cam], t.reshape(-1, 3)[plan.cam],
            lm.reshape(-1, 3)[plan.lm])


def _obs_blocks(R, t, lm, plan: _Plan, uv, weight, consts):
    """Per-observation weighted residuals [BM, 2] and Jacobians
    [BM, 2, 6], [BM, 2, 3], by jacfwd under vmap."""
    Ro, to, lmo = _gather(R, t, lm, plan)
    z6 = torch.zeros(6, dtype=R.dtype, device=R.device)
    z3 = torch.zeros(3, dtype=R.dtype, device=R.device)

    def one(Ri, ti, lmi, uvi):
        def f(xi, dl):
            r = _residual_one(xi, dl, Ri, ti, lmi, uvi, *consts)
            return r, r

        (jp, jl), r = jacfwd(f, argnums=(0, 1), has_aux=True)(z6, z3)
        return r, jp, jl

    r, jp, jl = vmap(one)(Ro, to, lmo, uv)
    w = weight[:, None, None]
    return r * weight[:, None], jp * w, jl * w


def _residuals(R, t, lm, plan: _Plan, uv, consts):
    """Unweighted residuals [BM, 2] (no Jacobians)."""
    Ro, to, lmo = _gather(R, t, lm, plan)
    return project(se3_apply(Ro, to, lmo), *consts) - uv


def _costs(R, t, lm, plan: _Plan, uv, weight, consts) -> torch.Tensor:
    """[B] sums of squared weighted residuals."""
    r = _residuals(R, t, lm, plan, uv, consts) * weight[:, None]
    return torch.sum((r * r).reshape(plan.B, -1), dim=1)


def _residual_norms_flat(R, t, lm, plan: _Plan, uv, consts):
    r = _residuals(R, t, lm, plan, uv, consts)
    return torch.sqrt(torch.sum(r * r, dim=-1))


def _huber(norms, delta: float):
    """sqrt of the Huber weight: enters r and J, so the normal equations
    carry the weight itself."""
    d = norms.new_full((), delta)
    return torch.where(norms <= d, torch.ones_like(norms),
                       torch.sqrt(d / torch.maximum(norms, d)))


def _tr(a):
    return a.transpose(-1, -2)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _pose_sums(plan, r, jp):
    """U [BP, 6, 6] and b_p [BP, 6]."""
    s = plan.seg_cam.sum(torch.cat([(_tr(jp) @ jp).reshape(-1, 36),
                                    -_mv(_tr(jp), r)], 1))
    return s[:, :36].reshape(-1, 6, 6), s[:, 36:]


def _landmark_sums(plan, r, jl):
    """V [BL, 3, 3] and b_l [BL, 3]."""
    s = plan.seg_lm.sum(torch.cat([(_tr(jl) @ jl).reshape(-1, 9),
                                   -_mv(_tr(jl), r)], 1))
    return s[:, :9].reshape(-1, 3, 3), s[:, 9:]


def _damp(A, lam):
    """Marquardt scaling: damp in proportion to each block's diagonal
    (the mixed rad/px/unit scales), plus a small absolute floor for
    unobserved parameters.  lam: 0-dim, or one per problem [B] with A
    [B, K, n, n]."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    lamv = lam.reshape((-1,) + (1,) * (A.dim() - 1)) if lam.dim() else lam
    return (A + lamv * (torch.diagonal(A, dim1=-2, dim2=-1)[..., None] * eye)
            + 1e-6 * eye)


def _apply(dx_pose, R, t):
    dR, dt = se3_exp(dx_pose)
    return dR @ R, _mv(dR, t) + dt


def _gn_step(R, t, lm, plan: _Plan, uv, weight, consts, lam, fix_first,
             shard: Shard | None = None):
    """One damped Schur Gauss-Newton step with W and S dense, for B
    problems at once: R [B, P, 3, 3], t [B, P, 3], lm [B, L, 3]; lam 0-dim
    or [B].  With a shard (one problem over a mesh) the blocks are summed
    over its observations and all-reduced.  Returns (R, t, lm, cost
    [B])."""
    b_, P, L = plan.B, plan.P, plan.L
    shard = shard or Shard(uv.shape[0], None, plan, None)
    sp, rows = shard.plan, shard.rows
    r, jp, jl = _obs_blocks(R, t, lm, sp, uv[rows], weight[rows], consts)
    U, bp = _pose_sums(sp, r, jp)
    V, bl = _landmark_sums(sp, r, jl)
    W = sp.seg_joint.sum((_tr(jp) @ jl).reshape(-1, 18))
    cost = torch.sum((r * r).reshape(b_, -1), dim=1)
    U, bp, V, bl, W, cost = shard.reduce([U, bp, V, bl, W, cost])
    W = W.reshape(b_, L, P, 6, 3).transpose(1, 2)          # [B, P, L, 6, 3]
    U = _damp(U.reshape(b_, P, 6, 6), lam)
    V = _damp(V.reshape(b_, L, 3, 3), lam)
    bp, bl = bp.reshape(b_, P, 6), bl.reshape(b_, L, 3)

    Vinv = inv3(V)                                          # [B, L, 3, 3]
    WVinv = W @ Vinv[:, None]                               # [B, P, L, 6, 3]
    S = -torch.einsum("bplik,bqlmk->bpiqm", WVinv, W)       # -W V^-1 W^T
    eye_p = torch.eye(P, dtype=S.dtype, device=S.device)
    S = (S + torch.einsum("pq,bpim->bpiqm", eye_p, U)).reshape(
        b_, P * 6, P * 6)
    rhs = bp - torch.einsum("bplik,blk->bpi", WVinv, bl)
    if fix_first:
        # gauge fix: clamp pose 0 by zeroing its rows/cols + identity
        mask = torch.ones(P * 6, dtype=S.dtype, device=S.device)
        mask[:6] = 0.0
        S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        rhs = rhs * mask.reshape(P, 6)
    # Jacobi preconditioning: the raw Schur system spans ~8 orders of
    # magnitude in f32 (fx^2-scaled rotation blocks vs unit translation
    # blocks); scaling by sqrt(diag) keeps the f32 solve accurate.
    d = torch.sqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1),
                               min=1e-12))
    Sp = S / d[..., :, None] / d[..., None, :]
    sol = torch.linalg.solve_ex(Sp, rhs.reshape(b_, -1) / d)[0]
    dx_pose = (sol / d).reshape(b_, P, 6)
    dx_lm = _mv(Vinv, bl - torch.einsum("bplik,bpi->blk", W, dx_pose))
    R_new, t_new = _apply(dx_pose, R, t)
    return R_new, t_new, lm + dx_lm, cost


class _SchurCG:
    """The matrix-free Schur system of one CG step for one large problem
    (B = 1), never building W (the [P, L, 6, 3] pose-landmark coupling)
    or the dense Schur matrix: S·x products stream through the
    per-observation Jacobians with two segment sums, so memory is
    O(M + P + L).  Block-Jacobi preconditioner on the damped U blocks.
    With a shard, every observation sum (U, V, b and each product with W
    or W^T) runs over its observations and is all-reduced, so CG's stop
    rule reads the same values on every rank."""

    def __init__(self, R, t, lm, plan: _Plan, uv, weight, consts, lam,
                 fix_first, shard: Shard | None = None):
        if plan.B != 1:
            raise ValueError("the CG step solves one problem")
        P = plan.P
        shard = shard or Shard(uv.shape[0], None, plan, None)
        self.sp, self.shard, self.fix_first = shard.plan, shard, fix_first
        r, jp, jl = _obs_blocks(R, t, lm, self.sp, uv[shard.rows],
                                weight[shard.rows], consts)
        U, bp = _pose_sums(self.sp, r, jp)
        V, bl = _landmark_sums(self.sp, r, jl)
        cost = torch.sum(r * r)[None]
        U, bp, V, bl, self.cost = shard.reduce([U, bp, V, bl, cost])
        self.jp, self.jl, self.bl = jp, jl, bl
        self.U, V = _damp(U, lam), _damp(V, lam)
        self.Vinv = inv3(V)
        self.mask = torch.ones((P, 6), dtype=torch.float32, device=R.device)
        if fix_first:
            self.mask[0] = 0.0
        self.rhs = (bp - self.w_times(_mv(self.Vinv, bl))) * self.mask
        eye6 = torch.eye(6, dtype=U.dtype, device=U.device).expand(U.shape)
        self.Uinv, _ = gj_solve_spd(self.U, eye6)

    def w_times(self, wl):       # W w for w [L, 3]
        return self.shard.reduce([self.sp.seg_cam.sum(
            _mv(_tr(self.jp), _mv(self.jl, wl[self.sp.lm])))])[0]

    def wt_times(self, v):       # W^T v for v [P, 6]
        return self.shard.reduce([self.sp.seg_lm.sum(
            _mv(_tr(self.jl), _mv(self.jp, v[self.sp.cam])))])[0]

    def precond(self, v):
        return _mv(self.Uinv, v) * self.mask

    def matvec(self, v):
        mask = self.mask
        v = v * mask
        out = (_mv(self.U, v) - self.w_times(
            _mv(self.Vinv, self.wt_times(v)))) * mask
        # identity on the gauge-fixed block keeps S definite
        return out + v * (1.0 - mask) if self.fix_first else out

    def update(self, dx_pose, R, t, lm):
        """The new state from the pose update: landmark
        back-substitution dl = V^-1 (bl - W^T dx)."""
        dx_lm = _mv(self.Vinv, self.bl - self.wt_times(dx_pose))
        R_new, t_new = _apply(dx_pose[None], R, t)
        return R_new, t_new, lm + dx_lm[None]


def _gn_step_cg(R, t, lm, plan: _Plan, uv, weight, consts, lam, fix_first,
                cg_iters: int, cg_tol: float, shard: Shard | None = None):
    """Matrix-free Schur Gauss-Newton step for one large problem (B = 1):
    the pose system (_SchurCG) solved with preconditioned CG, landmarks
    back-substituted per landmark.  Returns (R, t, lm, cost [1])."""
    s = _SchurCG(R, t, lm, plan, uv, weight, consts, lam, fix_first, shard)
    dx_pose = pcg(s.matvec, s.precond, s.rhs, cg_iters, cg_tol)
    return (*s.update(dx_pose, R, t, lm), s.cost)


def _total_cost(R, t, landmarks, prob: BAProblem) -> torch.Tensor:
    """Sum of squared weighted residuals of one problem (0-dim)."""
    plan = _Plan(prob.cam_idx, prob.lm_idx, R.shape[0],
                 landmarks.shape[0], joint=False)
    return _costs(R[None], t[None], landmarks[None], plan, prob.uv,
                  prob.weight, prob.consts)[0]


def _residual_norms(R, t, landmarks, prob: BAProblem) -> torch.Tensor:
    """Per-observation UNWEIGHTED residual norms [M] (for IRLS and the
    gate)."""
    plan = _Plan(prob.cam_idx, prob.lm_idx, R.shape[0],
                 landmarks.shape[0], joint=False)
    return _residual_norms_flat(R[None], t[None], landmarks[None], plan,
                                prob.uv, prob.consts)


def _lm_drive_eager(prob: BAProblem, plan: _Plan, iterations: int,
                    damping: float, gn_step, robust_delta=None):
    """Levenberg-Marquardt with masked accept, launch by launch: ok, lam
    and the cost curve stay on the device.  What `_Solve.lm_drive` is
    held against, and what a solve over a mesh runs."""
    consts = prob.consts
    R, t, lm = prob.R[None], prob.t[None], prob.landmarks[None]
    lam = torch.full((), damping, dtype=torch.float32, device=R.device)
    costs = []
    for _ in range(iterations):
        w = prob.weight
        if robust_delta is not None:
            # Huber IRLS on the current estimate
            w = w * _huber(_residual_norms_flat(R, t, lm, plan, prob.uv,
                                                consts), robust_delta)
        c_cur = _costs(R, t, lm, plan, prob.uv, w, consts)
        Rn, tn, lmn, _ = gn_step(R, t, lm, plan, prob.uv, w, consts, lam)
        c_new = _costs(Rn, tn, lmn, plan, prob.uv, w, consts)
        ok = (c_new < c_cur)[0]
        R = torch.where(ok, Rn, R)
        t = torch.where(ok, tn, t)
        lm = torch.where(ok, lmn, lm)
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-6), lam * 4.0)
        costs.append(torch.where(ok, c_new, c_cur)[0])
    costs = torch.stack(costs) if costs else R.new_zeros(0)
    return R[0], t[0], lm[0], costs


def _refit_step(R, t, lm, plan: _Plan, uv, weight, consts, robust_delta,
                out=None):
    """One step of the landmark refit (below): per-landmark damped
    Gauss-Newton on its own Huber-weighted observations, the poses
    fixed.  Returns lm + dlm (written into out when given)."""
    eye3 = torch.eye(3, dtype=torch.float32, device=R.device)
    hub = _huber(_residual_norms_flat(R, t, lm, plan, uv, consts),
                 robust_delta)
    r, _, jl = _obs_blocks(R, t, lm, plan, uv, weight * hub, consts)
    V, bl = _landmark_sums(plan, r, jl)
    dlm = _mv(inv3(V + 1e-4 * eye3), bl)
    return torch.add(lm, dlm[None], out=out)


def _refit_landmarks_eager(R, t, lm, prob: BAProblem, iters: int = 3,
                           robust_delta: float = 2.0,
                           plan: _Plan | None = None):
    """Robust landmark-only refinement with poses FIXED: per-landmark
    damped GN on its own observations, parallel over landmarks, launch
    by launch (`_Solve.refit_landmarks` is held against it).

    Rescues landmarks the gating loop would otherwise freeze dead: a
    landmark whose support fell below the gate keeps a stale 3D position,
    so its clean observations never pass the gate again.  With poses
    near-correct, a Huber refit pulls each landmark to the consistent
    majority of its observations."""
    plan = plan or _plan_of(prob, joint=False)
    R, t, lm = R[None], t[None], lm[None]
    for _ in range(iters):
        lm = _refit_step(R, t, lm, plan, prob.uv, prob.weight, prob.consts,
                         robust_delta)
    return lm[0]


def _gn_step_of(fix_first: bool, cg=None, shard: Shard | None = None):
    """The step `_lm_drive_eager` takes: the dense Schur step, or the CG
    step with cg = (cg_iters, cg_tol); with a shard, sharded."""
    if cg is None:
        return lambda R, t, lm, plan, uv, w, consts, lam: _gn_step(
            R, t, lm, plan, uv, w, consts, lam, fix_first, shard)
    return lambda R, t, lm, plan, uv, w, consts, lam: _gn_step_cg(
        R, t, lm, plan, uv, w, consts, lam, fix_first, *cg, shard)


class _Solve(LMSolve):
    """One bundle adjustment as programs (slam/solvers.py::LMSolve), as
    klt_tpu compiles it (its `_lm_drive` and `_refit_landmarks`): the
    caller's poses, landmarks, observations and weights copied into
    static buffers; the dense Schur step as one program, or the CG
    step's linearization (`_SchurCG` and CG's start), CG's chunks and the
    update; and the landmark refit's step, which bundle_adjust_gated runs
    between its rounds on the same buffers."""

    def __init__(self, prob: BAProblem, plan: _Plan, damping: float,
                 fix_first: bool, robust_delta, cg=None):
        super().__init__(prob.R.device, cg, (plan.P, 6))
        self.plan, self.consts = plan, prob.consts
        self.damping, self.fix_first = damping, fix_first
        self.robust_delta = robust_delta
        self.R, self.t, self.lm = (a[None].clone() for a in (
            prob.R, prob.t, prob.landmarks))
        self.uv, self.weight = prob.uv.clone(), prob.weight.clone()
        self.w = self.weight   # a round's weights (set_active)
        self.lam = torch.empty((), dtype=torch.float32, device=self.device)
        self.cost = torch.empty(1, dtype=torch.float32, device=self.device)
        self.refit = self.program(self._refit_step)

    def extra_programs(self) -> list:
        return [self.refit]

    def lm_drive(self, iterations: int) -> torch.Tensor:
        """`_lm_drive_eager` from the static state (lam starts at the
        damping, as every round of bundle_adjust_gated does)."""
        self.lam.fill_(self.damping)
        return super().lm_drive(iterations)

    def _weights(self):
        """The iteration's weights (Huber IRLS on the current estimate)
        and the current cost."""
        w = self.w
        if self.robust_delta is not None:
            w = w * _huber(_residual_norms_flat(
                self.R, self.t, self.lm, self.plan, self.uv, self.consts),
                self.robust_delta)
        return w, _costs(self.R, self.t, self.lm, self.plan, self.uv, w,
                         self.consts)

    def _iteration(self):
        w, c_cur = self._weights()
        new = _gn_step(self.R, self.t, self.lm, self.plan, self.uv, w,
                       self.consts, self.lam, self.fix_first)
        self._accept(new[:3], w, c_cur)

    def _linearize(self):
        self.w_it, self.c_cur = self._weights()
        self.sys = _SchurCG(self.R, self.t, self.lm, self.plan, self.uv,
                            self.w_it, self.consts, self.lam,
                            self.fix_first)
        self.cg.start(self.sys.matvec, self.sys.precond, self.sys.rhs)

    def _update(self):
        self._accept(self.sys.update(self.cg.x, self.R, self.t, self.lm),
                     self.w_it, self.c_cur)

    def _accept(self, new, w, c_cur):
        """The accept test into the static state, the cost into its
        slot."""
        c_new = _costs(*new, self.plan, self.uv, w, self.consts)
        ok = (c_new < c_cur)[0]
        for a, b in zip(new, (self.R, self.t, self.lm)):
            torch.where(ok, a, b, out=b)
        torch.where(ok, torch.clamp(self.lam * 0.5, min=1e-6),
                    self.lam * 4.0, out=self.lam)
        torch.where(ok, c_new, c_cur, out=self.cost)

    def _refit_step(self):
        _refit_step(self.R, self.t, self.lm, self.plan, self.uv, self.weight,
                    self.consts, self.robust_delta, out=self.lm)

    def refit_landmarks(self, iters: int) -> None:
        """`_refit_landmarks_eager` on the static state (the caller's
        weights, Huber delta robust_delta)."""
        for _ in range(iters):
            self.refit.run(1)

    def set_active(self, act: torch.Tensor) -> None:
        """A round's weights: the caller's where act, else 0."""
        if self.w is self.weight:   # the first round: a buffer of its own
            self.w = torch.empty_like(self.weight)
        torch.where(act, self.weight, torch.zeros_like(self.weight),
                    out=self.w)

    def state(self):
        return self.R[0], self.t[0], self.lm[0]

    def result(self):
        """The state as the caller's own tensors."""
        return tuple(a.clone() for a in self.state())


class _EagerSolve:
    """`_Solve`'s interface over the eager bodies (`_lm_drive_eager`,
    `_refit_landmarks_eager`): what a solve over a mesh runs (its
    shard's all-reduces stay out of graphs), and the reference the
    programs are held against."""

    def __init__(self, prob: BAProblem, plan: _Plan, damping: float,
                 fix_first: bool, robust_delta, cg=None,
                 shard: Shard | None = None):
        self.prob, self.plan, self.damping = prob, plan, damping
        self.robust_delta = robust_delta
        self.gn_step = _gn_step_of(fix_first, cg, shard)
        self.R, self.t, self.lm = prob.R, prob.t, prob.landmarks
        self.w = prob.weight

    def lm_drive(self, iterations: int) -> torch.Tensor:
        pw = dataclasses.replace(self.prob, R=self.R, t=self.t,
                                 landmarks=self.lm, weight=self.w)
        self.R, self.t, self.lm, costs = _lm_drive_eager(
            pw, self.plan, iterations, self.damping, self.gn_step,
            self.robust_delta)
        return costs

    def refit_landmarks(self, iters: int) -> None:
        self.lm = _refit_landmarks_eager(self.R, self.t, self.lm, self.prob,
                                         iters, self.robust_delta,
                                         self.plan)

    def set_active(self, act: torch.Tensor) -> None:
        w = self.prob.weight
        self.w = torch.where(act, w, torch.zeros_like(w))

    def state(self):
        return self.R, self.t, self.lm

    result = state


def _plan_of(prob: BAProblem, joint: bool) -> _Plan:
    return _Plan(prob.cam_idx, prob.lm_idx, prob.R.shape[0],
                 prob.landmarks.shape[0], joint)


def _shard_of(prob: BAProblem, plan: _Plan, mesh) -> Shard | None:
    """This rank's block of the (padded) problem's observations over the
    mesh's "data" axis; its plan counts the problem's global poses and
    landmarks, so the partial blocks have the full shapes to reduce."""
    if mesh is None:
        return None
    return Shard(plan.M, mesh, plan, lambda rows: _Plan(
        prob.cam_idx[rows], prob.lm_idx[rows], plan.P, plan.L,
        plan.seg_joint is not None))


def _padded(prob: BAProblem, mesh) -> BAProblem:
    return prob if mesh is None else prob.pad_observations(data_size(mesh))


def _solve(prob: BAProblem, plan: _Plan, mesh, damping: float,
           fix_first: bool, robust_delta, cg=None):
    """The solve of one call: its programs, or over a mesh the eager
    bodies on this rank's shard."""
    if mesh is None:
        return _Solve(prob, plan, damping, fix_first, robust_delta, cg)
    return _EagerSolve(prob, plan, damping, fix_first, robust_delta, cg,
                       _shard_of(prob, plan, mesh))


def bundle_adjust(prob: BAProblem, mesh=None, iterations: int = 10,
                  damping: float = 10.0, fix_first: bool = True,
                  robust_delta: float | None = None):
    """Levenberg-Marquardt with adaptive damping and the dense Schur
    step.

    Each iteration computes one damped Schur step; the step is accepted
    only if it lowers the total cost (otherwise the damping is raised and
    the step retried on the next iteration — classic LM, a fixed number of
    iterations with masked accept).

    robust_delta (px): Huber IRLS — observations with residual norm n
    beyond delta are down-weighted by delta/n each iteration.  None =
    plain least squares.

    mesh: a DeviceMesh with a "data" axis (parallel/mesh.py): the
    observations are padded to its size and their normal equations
    sharded over it (see the module docstring); every rank passes the
    same problem and gets the same result.

    Returns (R, t, landmarks, costs [iterations]) on the problem's device
    — costs are the accepted (weighted) cost after each iteration."""
    prob = _padded(prob, mesh)
    solve = _solve(prob, _plan_of(prob, joint=True), mesh, damping,
                   fix_first, robust_delta)
    costs = solve.lm_drive(iterations)
    return (*solve.result(), costs)


def bundle_adjust_cg(prob: BAProblem, mesh=None, iterations: int = 10,
                     damping: float = 10.0, fix_first: bool = True,
                     cg_iters: int = 250, cg_tol: float = 1e-5,
                     robust_delta: float | None = None):
    """Levenberg-Marquardt with the matrix-free Schur/CG inner solver
    (_gn_step_cg) — the path for hundreds of keyframes and tens of
    thousands of landmarks.  Same accept/reject semantics as
    `bundle_adjust` (incl. the Huber IRLS option); prefer it whenever
    n_pose * n_lm is too large to build W densely.  A mesh shards the
    observations as in `bundle_adjust`, with one all_reduce per CG
    matvec."""
    prob = _padded(prob, mesh)
    solve = _solve(prob, _plan_of(prob, joint=False), mesh, damping,
                   fix_first, robust_delta, (cg_iters, cg_tol))
    costs = solve.lm_drive(iterations)
    return (*solve.result(), costs)


def bundle_adjust_gated(prob: BAProblem, mesh=None, rounds: int = 3,
                        iterations: int = 20, damping: float = 10.0,
                        fix_first: bool = True, cg_iters: int = 250,
                        cg_tol: float = 1e-5, robust_delta: float = 2.0,
                        gate_px: float = 2.0, min_obs_per_lm: int = 2):
    """Geometrically gated BA: robust LM rounds (bundle_adjust_cg)
    alternated with reprojection-threshold track pruning — the classic
    SLAM inlier gating loop.

    After each round the active set is RE-EVALUATED from the current
    solution: observations whose UNWEIGHTED residual norm exceeds the
    gate sit out the next round (weight 0), and landmarks left with fewer
    than `min_obs_per_lm` live observations are dropped entirely.  The
    gate is annealed: gate_px * 2^(rounds - 2 - round), wide early (the
    first solution is still outlier-pulled), gate_px for the final round.
    The per-round gating runs on the host (numpy), as in klt_tpu, on the
    whole problem; a mesh shards each round's normal equations as in
    `bundle_adjust_cg`.  Without a mesh the rounds and the landmark
    refits between them share one solve's programs.

    Returns (R, t, landmarks, costs [rounds*iterations] on the problem's
    device, active [M] numpy bool — the observations the final solution
    is supported by)."""
    m = int(prob.cam_idx.shape[0])
    prob = _padded(prob, mesh)
    solve = _solve(prob, _plan_of(prob, joint=False), mesh, damping,
                   fix_first, robust_delta, (cg_iters, cg_tol))
    return _gated(solve, prob, m, rounds, iterations, gate_px,
                  min_obs_per_lm)


def _bundle_adjust_eager(prob: BAProblem, iterations: int = 10,
                         damping: float = 10.0, fix_first: bool = True,
                         robust_delta: float | None = None, cg=None):
    """`bundle_adjust` (cg None) or `bundle_adjust_cg` (cg = (cg_iters,
    cg_tol)) without a mesh, through the eager bodies: what their
    programs are held against."""
    solve = _EagerSolve(prob, _plan_of(prob, joint=cg is None), damping,
                        fix_first, robust_delta, cg)
    costs = solve.lm_drive(iterations)
    return (*solve.result(), costs)


def _bundle_adjust_gated_eager(prob: BAProblem, rounds: int = 3,
                               iterations: int = 20, damping: float = 10.0,
                               fix_first: bool = True, cg_iters: int = 250,
                               cg_tol: float = 1e-5,
                               robust_delta: float = 2.0,
                               gate_px: float = 2.0,
                               min_obs_per_lm: int = 2):
    """`bundle_adjust_gated` without a mesh, through the eager bodies:
    what its programs are held against."""
    solve = _EagerSolve(prob, _plan_of(prob, joint=False), damping,
                        fix_first, robust_delta, (cg_iters, cg_tol))
    return _gated(solve, prob, int(prob.cam_idx.shape[0]), rounds,
                  iterations, gate_px, min_obs_per_lm)


def _gated(solve, prob: BAProblem, m: int, rounds: int, iterations: int,
           gate_px: float, min_obs_per_lm: int):
    """bundle_adjust_gated's rounds on a solve (`_Solve` or
    `_EagerSolve`), its gating on the host."""
    weight = prob.weight.cpu().numpy()
    active = weight > 0
    fed = weight > 0  # caller's hard zero-weights
    lm_idx = prob.lm_idx.cpu().numpy()
    n_lm = int(prob.landmarks.shape[0])
    costs_all = []
    for rd in range(rounds):
        solve.set_active(torch.from_numpy(active).to(prob.weight.device))
        costs_all.append(solve.lm_drive(iterations))
        if rd < rounds - 1:
            # rescue frozen landmarks before re-evaluating the gate
            solve.refit_landmarks(3)
            R, t, lm = solve.state()
            rn = _residual_norms_flat(R[None], t[None], lm[None], solve.plan,
                                      prob.uv, prob.consts).cpu().numpy()
            gate = gate_px * (2.0 ** (rounds - 2 - rd))
            act = fed & (rn <= gate)
            cnt = np.zeros(n_lm, np.int32)
            np.add.at(cnt, lm_idx, act.astype(np.int32))
            act &= cnt[lm_idx] >= min_obs_per_lm
            if act.sum() < 6:  # never gate into a degenerate problem
                break
            active = act
    return (*solve.result(), torch.cat(costs_all), active[:m])
