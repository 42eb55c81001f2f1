"""Pose-graph optimization over SE(3) relative-pose constraints.

Counterpart of klt_tpu/slam/pose_graph.py on one device.  Given odometry
/ loop-closure edges (i, j, relative pose Z_ij, weight), refine absolute
poses by Levenberg-Marquardt on the residual

    r_ij = Log( Z_ij^-1 * (T_i^-1 * T_j) )   in R^6

linearized by `torch.func.jacfwd` under `torch.func.vmap` through the same
Taylor-guarded exp map the BA uses.  The normal equations are summed per
pose in a fixed order (slam/solvers.py), so two runs on the card give the
same bits; the LM loop keeps its accept flag, damping and cost curve on
the device.  As klt_tpu compiles the solve into one XLA program, it runs
as programs of cuda/graph.py (`_Solve`, a slam/solvers.py::LMSolve): on
the card every LM iteration after the first replays CUDA graphs.  With a
mesh (parallel/mesh.py) it runs `_optimize_pose_graph_eager`, the same
loop launch by launch (also the reference the programs are held
against): the edges are padded to the mesh's "data" size and only the
normal equations are sharded: each rank sums its contiguous block of the
edges and one all_reduce over "data" adds them (klt_tpu's psum); the LM
accept test runs on the whole graph.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

from ..utils.linalg import gj_solve_spd
from .geometry import so3_exp
from .solvers import LMSolve, Segments, Shard, data_size, pcg

def _max(a: torch.Tensor, b: float) -> torch.Tensor:
    """jnp.maximum(a, b): half the tangent to each side at a tie."""
    return torch.maximum(a, torch.full_like(a, b))


def _min(a: torch.Tensor, b: float) -> torch.Tensor:
    return torch.minimum(a, torch.full_like(a, b))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] axis-angle.

    atan2-based and Taylor-guarded on BOTH branches so forward-mode
    derivatives are finite at (and near) the identity — a plain
    arccos((tr-1)/2) has an infinite derivative exactly where pose-graph
    residuals live."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = torch.sum(w * w, dim=-1) * 0.25          # sin^2(theta)
    c = _min(_max((tr - 1.0) * 0.5, -1.0), 1.0)   # cos(theta), clipped
    # sin(theta) ~ 0 happens BOTH at theta ~ 0 (Taylor branch) and at
    # theta ~ pi, where w ~ 0 but the log is ~ pi * axis: recover the
    # axis there from the symmetric part, aa^T = (S - cI) / (1 - c).
    small = (s2 < 1e-12) & (c > 0.0)
    near_pi = c < -0.999
    s2_safe = torch.where(small | near_pi, torch.ones_like(s2), s2)
    s_safe = torch.sqrt(s2_safe)
    theta = torch.atan2(s_safe, c)
    scale = torch.where(small, 0.5 + s2 / 12.0,
                        theta / (2.0 * s_safe))[..., None]
    # near-pi branch: theta from the (guarded) cosine alone — atan2
    # needs an accurate sine, which w no longer carries there
    theta_pi = torch.arccos(_max(c, -1.0 + 1e-7))
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    one_mc = torch.where(near_pi, 1.0 - c, torch.ones_like(c))[..., None]
    axis2 = _max((diag - c[..., None]) / one_mc, 1e-12)
    # Relative axis signs from the symmetric part: (S - cI)[i, j] =
    # a_i a_j (1 - c), so sign(a_i) relative to the dominant axis k is
    # sign(S[i, k]) — robust at exactly theta = pi.  The GLOBAL sign
    # comes from w's dominant component (w = 2 sin(theta) a, still
    # accurate slightly below pi); at exactly pi it is the legitimate
    # R(pi, a) == R(pi, -a) ambiguity and +1 is a valid choice.
    S = 0.5 * (R + R.transpose(-1, -2))
    arange3 = torch.arange(3, device=R.device)
    kk = (arange3 == torch.argmax(axis2, dim=-1)[..., None]).to(R.dtype)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    scol = ((S - c[..., None, None] * eye) @ kk[..., None])[..., 0]
    one = torch.ones_like(scol)
    rel = torch.where(scol >= 0.0, one, -one)  # rel[k] = +1
    wk = torch.sum(w * kk, dim=-1, keepdim=True)
    sign = torch.where(wk < 0.0, -rel, rel)
    log_pi = theta_pi[..., None] * sign * torch.sqrt(axis2)
    return torch.where(near_pi[..., None], log_pi, w * scale)


@dataclasses.dataclass
class PoseGraph:
    """R: [P,3,3]; t: [P,3]; edges (i, j, Z) with Z = (Rz [E,3,3],
    tz [E,3]) the measured pose of j in i's frame; weight [E].  All
    tensors on one device (int64 or int32 edge indices)."""

    R: torch.Tensor
    t: torch.Tensor
    ei: torch.Tensor
    ej: torch.Tensor
    Rz: torch.Tensor
    tz: torch.Tensor
    weight: torch.Tensor

    def pad_edges(self, multiple: int) -> "PoseGraph":
        """Zero-weight identity edges (0, 0) up to a multiple of
        `multiple` edges (the shard size of a mesh)."""
        e = self.ei.shape[0]
        pad = (-e) % multiple
        if pad == 0:
            return self
        z = lambda a, v: torch.cat(
            [a, torch.full((pad,) + tuple(a.shape[1:]), v, dtype=a.dtype,
                           device=a.device)])
        eye = torch.eye(3, dtype=self.Rz.dtype,
                        device=self.Rz.device).expand(pad, 3, 3)
        return dataclasses.replace(
            self, ei=z(self.ei, 0), ej=z(self.ej, 0),
            Rz=torch.cat([self.Rz, eye]), tz=z(self.tz, 0.0),
            weight=z(self.weight, 0.0))


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rz, tz):
    """r in R^6 of one edge for updates T_i <- exp(xi_i) T_i etc.
    (camera-from-world poses: T_i^-1 T_j has R_rel = Ri Rj^T)."""
    dRi = so3_exp(xi_i[None, :3])[0]
    dRj = so3_exp(xi_j[None, :3])[0]
    Ri_n = dRi @ Ri
    ti_n = dRi @ ti + xi_i[3:]
    Rj_n = dRj @ Rj
    tj_n = dRj @ tj + xi_j[3:]
    R_rel = Ri_n @ Rj_n.transpose(-1, -2)
    t_rel = ti_n - R_rel @ tj_n
    # residual vs measurement
    dR = Rz.transpose(-1, -2) @ R_rel
    rw = so3_log(dR[None])[0]
    rt = Rz.transpose(-1, -2) @ (t_rel - tz)
    return torch.cat([rw, rt])


def _one_edge(Ri, ti, Rj, tj, Rz, tz):
    z6 = torch.zeros(6, dtype=Ri.dtype, device=Ri.device)

    def f(a, b):
        r = _edge_residual(a, b, Ri, ti, Rj, tj, Rz, tz)
        return r, r

    (ji, jj), r = jacfwd(f, argnums=(0, 1), has_aux=True)(z6, z6)
    return r, ji, jj


def _edge_blocks(R, t, pg: PoseGraph):
    """Weighted per-edge residuals [E, 6] and Jacobians [E, 6, 6] with
    respect to the updates of pose i and of pose j."""
    ei, ej = pg.ei.long(), pg.ej.long()
    r, ji, jj = vmap(_one_edge)(R[ei], t[ei], R[ej], t[ej], pg.Rz, pg.tz)
    w = pg.weight[:, None, None]
    return r * pg.weight[:, None], ji * w, jj * w


def _edge_cost(R, t, pg: PoseGraph) -> torch.Tensor:
    """sum of squared weighted residuals (no Jacobians)."""
    ei, ej = pg.ei.long(), pg.ej.long()
    z6 = torch.zeros(6, dtype=R.dtype, device=R.device)
    r = vmap(lambda *a: _edge_residual(z6, z6, *a))(
        R[ei], t[ei], R[ej], t[ej], pg.Rz, pg.tz) * pg.weight[:, None]
    return torch.sum(r * r)


class _Plan:
    """The graph's segment layouts, built once per optimization:
    `ends` sums over the edges' two end poses ([ei; ej]); `joint` over
    the four (a, b) pose pairs of each edge, for the dense H."""

    def __init__(self, pg: PoseGraph, n: int, dense: bool):
        ei, ej = pg.ei.long(), pg.ej.long()
        self.ends = Segments(torch.cat([ei, ej]), n)
        self.joint = Segments(torch.cat([ei * n + ei, ei * n + ej,
                                         ej * n + ei, ej * n + ej]),
                              n * n) if dense else None


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _apply(dx, R, t):
    dR = so3_exp(dx[:, :3])
    return dR @ R, _mv(dR, t) + dx[:, 3:]


def _edges(pg: PoseGraph, rows: slice) -> PoseGraph:
    return dataclasses.replace(pg, ei=pg.ei[rows], ej=pg.ej[rows],
                               Rz=pg.Rz[rows], tz=pg.tz[rows],
                               weight=pg.weight[rows])


def _gn_step(R, t, pg: PoseGraph, plan: _Plan, damping, fix_first,
             shard: Shard | None = None):
    """One damped Gauss-Newton step with the dense [6P, 6P] H (with a
    shard: summed over its edges and all-reduced)."""
    n = R.shape[0]
    shard = shard or Shard(pg.ei.shape[0], None, plan, None)
    plan = shard.plan
    r, ji, jj = _edge_blocks(R, t, _edges(pg, shard.rows))
    tr = lambda a: a.transpose(-1, -2)
    blocks = torch.cat([tr(ji) @ ji, tr(ji) @ jj, tr(jj) @ ji, tr(jj) @ jj])
    H = plan.joint.sum(blocks)
    g = torch.cat([-_mv(tr(ji), r), -_mv(tr(jj), r)])
    H, b = shard.reduce([H, plan.ends.sum(g)])
    H = H.reshape(n, n, 6, 6)

    Hm = H.permute(0, 2, 1, 3).reshape(n * 6, n * 6)
    eye = torch.eye(n * 6, dtype=Hm.dtype, device=Hm.device)
    Hm = Hm + damping * torch.diag(torch.diagonal(Hm)) + 1e-8 * eye
    rhs = b.reshape(-1)
    if fix_first:
        mask = torch.ones(n * 6, dtype=Hm.dtype, device=Hm.device)
        mask[:6] = 0.0
        Hm = Hm * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        rhs = rhs * mask
    d = torch.sqrt(_max(torch.diagonal(Hm), 1e-12))
    sol = torch.linalg.solve_ex(Hm / d[:, None] / d[None, :], rhs / d)[0]
    dx = (sol / d).reshape(n, 6)
    return _apply(dx, R, t)


class _EdgeCG:
    """The matrix-free edge-list system of one CG step: never builds the
    [P,6,P,6] H.  Each matvec streams through the per-edge Jacobians
    (two gathers + one segment sum), so memory is O(E + P).  With a
    shard, every edge sum runs over its edges and is all-reduced."""

    def __init__(self, R, t, pg: PoseGraph, plan: _Plan, damping,
                 fix_first, shard: Shard | None = None):
        n = R.shape[0]
        dev = R.device
        self.mask = torch.ones((n, 6), dtype=torch.float32, device=dev)
        if fix_first:
            self.mask[0] = 0.0
        shard = shard or Shard(pg.ei.shape[0], None, plan, None)
        self.plan, self.shard = shard.plan, shard
        self.damping, self.fix_first = damping, fix_first
        pg = _edges(pg, shard.rows)
        r, self.ji, self.jj = _edge_blocks(R, t, pg)
        ji, jj = self.ji, self.jj
        self.ei, self.ej = pg.ei.long(), pg.ej.long()
        # b and the block-diagonal of H (damping + preconditioning)
        b, Hd = shard.reduce([
            self.plan.ends.sum(torch.cat([_mv(_tr(ji), r), _mv(_tr(jj), r)])),
            self.plan.ends.sum(torch.cat([_tr(ji) @ ji, _tr(jj) @ jj]))])
        self.b = -b
        self.diag = torch.diagonal(Hd, dim1=-2, dim2=-1)
        eye6 = torch.eye(6, dtype=Hd.dtype, device=dev)[None]
        Hd_damped = Hd + damping * self.diag[:, :, None] * eye6 + 1e-8 * eye6
        self.Minv, _ = gj_solve_spd(Hd_damped, eye6.expand(Hd_damped.shape))

    def matvec(self, v):
        mask = self.mask
        v = v * mask
        y = _mv(self.ji, v[self.ei]) + _mv(self.jj, v[self.ej])
        out = self.shard.reduce([self.plan.ends.sum(
            torch.cat([_mv(_tr(self.ji), y), _mv(_tr(self.jj), y)]))])[0]
        out = (out + self.damping * self.diag * v + 1e-8 * v) * mask
        return out + v * (1.0 - mask) if self.fix_first else out

    def precond(self, v):
        return _mv(self.Minv, v) * self.mask


def _tr(a):
    return a.transpose(-1, -2)


def _gn_step_cg(R, t, pg: PoseGraph, plan: _Plan, damping, fix_first,
                cg_iters: int, cg_tol: float, shard: Shard | None = None):
    """Matrix-free edge-list Gauss-Newton step (_EdgeCG solved with
    preconditioned CG)."""
    s = _EdgeCG(R, t, pg, plan, damping, fix_first, shard)
    dx = pcg(s.matvec, s.precond, s.b * s.mask, cg_iters, cg_tol)
    return _apply(dx, R, t)


class _Solve(LMSolve):
    """One pose-graph optimization as programs (slam/solvers.py::LMSolve),
    as klt_tpu compiles `optimize_pose_graph`: the caller's poses and
    edges copied into static buffers, the current cost carried in its
    slot; the dense step as one program, or the CG step's linearization
    (`_EdgeCG` and CG's start), CG's chunks and the update."""

    def __init__(self, pg: PoseGraph, plan: _Plan, damping: float,
                 fix_first: bool, cg=None):
        n = pg.R.shape[0]
        super().__init__(pg.R.device, cg, (n, 6))
        self.plan, self.fix_first = plan, fix_first
        self.pg = dataclasses.replace(pg, **{
            f.name: getattr(pg, f.name).clone()
            for f in dataclasses.fields(pg)})
        self.R, self.t = self.pg.R, self.pg.t
        self.cost = _edge_cost(self.R, self.t, self.pg)
        self.lam = torch.full((), damping, dtype=torch.float32,
                              device=self.device)

    def _iteration(self):
        self._accept(_gn_step(self.R, self.t, self.pg, self.plan, self.lam,
                              self.fix_first))

    def _linearize(self):
        self.sys = _EdgeCG(self.R, self.t, self.pg, self.plan, self.lam,
                           self.fix_first)
        self.cg.start(self.sys.matvec, self.sys.precond,
                      self.sys.b * self.sys.mask)

    def _update(self):
        self._accept(_apply(self.cg.x, self.R, self.t))

    def _accept(self, new):
        c_new = _edge_cost(*new, self.pg)
        ok = c_new < self.cost
        for a, b in zip(new, (self.R, self.t)):
            torch.where(ok, a, b, out=b)
        torch.where(ok, torch.clamp(self.lam * 0.5, min=1e-8),
                    self.lam * 4.0, out=self.lam)
        torch.where(ok, c_new, self.cost, out=self.cost)


def optimize_pose_graph(pg: PoseGraph, mesh=None, iterations: int = 10,
                        damping: float = 1e-3, fix_first: bool = True,
                        solver: str = "dense", cg_iters: int = 200,
                        cg_tol: float = 1e-6):
    """LM with accept/reject; returns (R, t, costs [iterations]) on the
    graph's device.

    solver="dense" builds H (fine for tens of keyframes); solver="cg" is
    the matrix-free edge-list path for large graphs.  mesh: a DeviceMesh
    with a "data" axis (parallel/mesh.py); the edges are padded to its
    size and their sums sharded over it (module docstring); every rank
    passes the same graph and gets the same result."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"solver must be 'dense' or 'cg', got {solver!r}")
    if mesh is not None:
        return _optimize_pose_graph_eager(pg, mesh, iterations, damping,
                                          fix_first, solver, cg_iters,
                                          cg_tol)
    solve = _Solve(pg, _Plan(pg, pg.R.shape[0], solver == "dense"),
                   damping, fix_first,
                   None if solver == "dense" else (cg_iters, cg_tol))
    costs = solve.lm_drive(iterations)
    return solve.R.clone(), solve.t.clone(), costs


def _optimize_pose_graph_eager(pg: PoseGraph, mesh=None,
                               iterations: int = 10, damping: float = 1e-3,
                               fix_first: bool = True, solver: str = "dense",
                               cg_iters: int = 200, cg_tol: float = 1e-6):
    """`optimize_pose_graph` launch by launch: what its programs are held
    against, and what a solve over a mesh runs."""
    if mesh is not None:
        pg = pg.pad_edges(data_size(mesh))
    n = pg.R.shape[0]
    dense = solver == "dense"
    plan = _Plan(pg, n, dense)
    shard = None if mesh is None else Shard(
        pg.ei.shape[0], mesh, plan,
        lambda rows: _Plan(_edges(pg, rows), n, dense))
    R, t = pg.R, pg.t
    c_cur = _edge_cost(R, t, pg)
    lam = torch.full((), damping, dtype=torch.float32, device=R.device)
    costs = []
    for _ in range(iterations):
        if solver == "cg":
            Rn, tn = _gn_step_cg(R, t, pg, plan, lam, fix_first, cg_iters,
                                 cg_tol, shard)
        else:
            Rn, tn = _gn_step(R, t, pg, plan, lam, fix_first, shard)
        c_new = _edge_cost(Rn, tn, pg)
        ok = c_new < c_cur
        R = torch.where(ok, Rn, R)
        t = torch.where(ok, tn, t)
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=1e-8), lam * 4.0)
        c_cur = torch.where(ok, c_new, c_cur)
        costs.append(c_cur)
    return R, t, torch.stack(costs) if costs else c_cur.new_zeros(0)
