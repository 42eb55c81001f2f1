"""The SLAM back end of the port (klt_tpu_torch/slam) held against
klt_tpu/slam on the CPU: geometry and so3_log, Jacobians from torch.func
against jax.jacfwd, chains and keyframes, one Gauss-Newton step of each
solver, tests/test_slam.py's cases run on both packages (its assertions
applied to the port), LM cost curves, the fixed-order segment sums and
the padding for a mesh (the mesh runs: tests/test_torch_mesh.py).
Inputs are numpy arrays made from seeds (the problems of
tests/test_slam.py) and handed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import klt_tpu.slam.ba as jba
import klt_tpu.slam.chains as jchains
import klt_tpu.slam.frontend as jfront
import klt_tpu.slam.geometry as jgeo
import klt_tpu.slam.pose_graph as jpg
from klt_tpu_torch.interop import (ba_problem_from_numpy, ba_problem_to_numpy,
                                   pose_graph_from_numpy, pose_graph_to_numpy)
from klt_tpu_torch.slam import ba, chains, frontend, geometry, pose_graph
from klt_tpu_torch.slam.solvers import Segments
from test_slam import _synthetic_pose_graph, _synthetic_problem

# f32 geometry evaluated by two libraries: a few ulps of values up to pi
GEO_TOL = 1e-6
# Jacobians: relative to the largest entry
JAC_TOL = 1e-5
# one Gauss-Newton step: the difference of the new states, relative to
# the step's own size (measured: 2.3e-5 at most on the problems below)
STEP_TOL = 1e-4
# LM cost curves, relative, on problems whose cost floor (noise) sits far
# above f32 rounding (measured: 7e-5 at most)
CURVE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads for this module's small tensors: pytest-xdist
    runs several workers on the cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def port(prob):
    return ba_problem_from_numpy(vars(prob))


def port_pg(pg):
    return pose_graph_from_numpy(vars(pg))


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def rotations():
    """Axis-angle vectors at w = 0, small, generic, near pi, and exactly
    pi about a mixed-sign axis."""
    rng = np.random.RandomState(0)
    axis = np.array([0.48, -0.6, 0.64], np.float32)
    axis /= np.linalg.norm(axis)
    return {
        "zero": np.zeros(3, np.float32),
        "small": np.float32(3e-5) * rng.randn(3).astype(np.float32),
        "generic": rng.randn(3).astype(np.float32) * np.float32(0.7),
        "near_pi": axis * np.float32(np.pi - 2e-3),
        "pi": axis * np.float32(np.pi),
    }


@pytest.mark.parametrize("name", list(rotations()))
def test_geometry_and_so3_log_match_klt_tpu(name):
    w = rotations()[name]
    rng = np.random.RandomState(1)
    p = (rng.uniform(-2, 2, (5, 3)) + [0, 0, 5]).astype(np.float32)
    t = rng.randn(3).astype(np.float32)
    tw = torch.from_numpy(w)
    R = geometry.so3_exp(tw[None])[0]
    jR = jgeo.so3_exp(jnp.asarray(w)[None])[0]
    np.testing.assert_allclose(np_(R), np.asarray(jR), rtol=0, atol=GEO_TOL)
    np.testing.assert_array_equal(np_(geometry.skew(tw)),
                                  np.asarray(jgeo.skew(jnp.asarray(w))))
    pc = geometry.se3_apply(R, torch.from_numpy(t), torch.from_numpy(p))
    jpc = jgeo.se3_apply(jR, jnp.asarray(t), jnp.asarray(p))
    np.testing.assert_allclose(np_(pc), np.asarray(jpc), rtol=GEO_TOL,
                               atol=GEO_TOL)
    np.testing.assert_allclose(
        np_(geometry.project(torch.from_numpy(p), 300.0, 310.0, 160.0,
                             120.0)),
        np.asarray(jgeo.project(jnp.asarray(p), 300.0, 310.0, 160.0,
                                120.0)), rtol=GEO_TOL, atol=0)
    # the log of the same f32 rotation matrix
    Rn = np_(R)
    log = np_(pose_graph.so3_log(torch.from_numpy(Rn)[None])[0])
    jlog = np.asarray(jpg.so3_log(jnp.asarray(Rn)[None])[0])
    np.testing.assert_allclose(log, jlog, rtol=0, atol=GEO_TOL)
    assert np.isfinite(log).all()
    if name != "pi":  # at exactly pi, w and -w are the same rotation
        np.testing.assert_allclose(log, w, rtol=0, atol=1e-3)


def rel_err(a, b):
    a, b = np_(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", ["zero", "small", "generic", "near_pi"])
def test_jacobians_match_jax(name):
    """jacfwd of exp, of log (at one f32 rotation matrix, both branches)
    and of the BA and pose-graph residuals at w = 0 (the gauge pose,
    identity edges), small, generic and near pi: finite, and within
    JAC_TOL of jax.jacfwd."""
    w = rotations()[name]
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    Rw = np_(geometry.so3_exp(tw[None])[0])
    pairs = [
        (jacfwd(lambda a: geometry.so3_exp(a[None])[0])(tw),
         jax.jit(jax.jacfwd(lambda a: jgeo.so3_exp(a[None])[0]))(jw)),
        (jacfwd(lambda a: pose_graph.so3_log(a[None])[0])(
            torch.from_numpy(Rw)),
         jax.jit(jax.jacfwd(lambda a: jpg.so3_log(a[None])[0]))(
            jnp.asarray(Rw))),
    ]
    rng = np.random.RandomState(2)
    Ri = np_(geometry.so3_exp(torch.from_numpy(w)[None])[0])
    ti, tj, tz = (rng.randn(3).astype(np.float32) for _ in range(3))
    Rj = np_(geometry.so3_exp(torch.from_numpy(
        rng.randn(3).astype(np.float32) * np.float32(0.2))[None])[0])
    Rz = Ri @ Rj.T  # an identity-rotation residual at xi = 0
    args = [Ri, ti, Rj, tj, Rz, tz]
    # the pose i rotated by w, updates of 1e-3 w: the residual's rotation
    # stays small (log near pi amplifies f32 rounding ~1/sin(theta) times;
    # its own Jacobian is held above at the near-pi matrix)
    x12 = np.concatenate([w * np.float32(1e-3), ti * np.float32(0.1),
                          w[::-1] * np.float32(1e-3),
                          tj * np.float32(0.1)]).astype(np.float32)
    pairs.append((
        jacfwd(lambda a: pose_graph._edge_residual(
            a[:6], a[6:], *map(torch.from_numpy, args)))(
            torch.from_numpy(x12)),
        jax.jit(jax.jacfwd(lambda a: jpg._edge_residual(
            a[:6], a[6:], *map(jnp.asarray, args))))(jnp.asarray(x12))))
    lm = np.array([0.3, -0.2, 5.0], np.float32)
    uv = np.array([170.0, 110.0], np.float32)
    x9 = np.concatenate([w, w[:3] * np.float32(0.01), w[:3]]).astype(
        np.float32)
    consts = (300.0, 300.0, 160.0, 120.0)
    pairs.append((
        jacfwd(lambda a: ba._residual_one(
            a[:6], a[6:], torch.from_numpy(Ri), torch.from_numpy(ti),
            torch.from_numpy(lm), torch.from_numpy(uv), *consts))(
            torch.from_numpy(x9)),
        jax.jit(jax.jacfwd(lambda a: jba._residual_one(
            a[:6], a[6:], jnp.asarray(Ri), jnp.asarray(ti), jnp.asarray(lm),
            jnp.asarray(uv), *consts)))(jnp.asarray(x9))))
    for ours, ref in pairs:
        assert ours.dtype == torch.float32
        assert torch.isfinite(ours).all()
        assert rel_err(ours, ref) <= JAC_TOL, rel_err(ours, ref)


def test_obs_and_edge_blocks_match_klt_tpu():
    """The vmapped per-observation and per-edge residuals and Jacobians
    (the gauge pose at identity included)."""
    prob, *_ = _synthetic_problem(np.random.RandomState(3), noise=0.3)
    P = port(prob)
    plan = ba._plan_of(P, joint=False)
    ours = ba._obs_blocks(P.R[None], P.t[None], P.landmarks[None], plan,
                          P.uv, P.weight, P.consts)
    ref = jax.jit(jba._obs_blocks, static_argnums=(7, 8, 9, 10))(
        prob.R, prob.t, prob.landmarks, prob.cam_idx, prob.lm_idx, prob.uv,
        prob.weight, prob.fx, prob.fy, prob.cx, prob.cy)
    for a, b in zip(ours, ref):
        assert rel_err(a, b) <= JAC_TOL
    pg, *_ = _synthetic_pose_graph(np.random.RandomState(4), noise=0.02)
    G = port_pg(pg)
    ours = pose_graph._edge_blocks(G.R, G.t, G)
    ref = jax.jit(jpg._edge_blocks)(pg.R, pg.t, pg.ei, pg.ej, pg.Rz, pg.tz,
                                    pg.weight)
    for a, b in zip(ours, ref):
        assert rel_err(a, b) <= JAC_TOL


def random_table(seed, n=30, t=25):
    rng = np.random.RandomState(seed)
    val = np.where(rng.rand(n, t) < 0.8, 0, -1).astype(np.int32)
    val[rng.rand(n, t) < 0.15] = rng.randint(1, 500)
    val[:, 0] = np.where(rng.rand(n) < 0.9, 300, -1)
    x = rng.uniform(0, 320, (n, t)).astype(np.float32)
    y = rng.uniform(0, 240, (n, t)).astype(np.float32)
    return x, y, val


@pytest.mark.parametrize("seed", range(4))
def test_chains_and_keyframes_equal_klt_tpu(seed):
    x, y, val = random_table(seed)
    for min_length in (1, 2, 3):
        for a, b in zip(chains.tracks_from_table(x, y, val, min_length),
                        jchains.tracks_from_table(x, y, val, min_length)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for thresh, gap in ((0.6, 1), (0.8, 1), (0.8, 3), (0.95, 2)):
        np.testing.assert_array_equal(
            chains.select_keyframes(val, thresh, gap),
            jchains.select_keyframes(val, thresh, gap))
    tid, frame, u, v = chains.tracks_from_table(x, y, val, 2)
    first = frontend._first_obs(tid)
    np.testing.assert_array_equal(first, jfront._first_obs(tid))
    np.testing.assert_array_equal(
        chains.ba_translation_prior(tid, frame % 5, u, v, first, 5, 300.0,
                                    310.0),
        jchains.ba_translation_prior(tid, frame % 5, u, v, first, 5, 300.0,
                                     310.0))


def step_err(new, ref_new, old):
    """max |ours - klt_tpu's| over the step's own size."""
    return np.abs(np_(new) - np.asarray(ref_new)).max() / \
        np.abs(np.asarray(ref_new) - np_(old)).max()


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_one_ba_step_matches_klt_tpu(solver):
    prob, *_ = _synthetic_problem(np.random.RandomState(1), noise=0.3)
    P = port(prob)
    plan = ba._plan_of(P, joint=solver == "dense")
    lam = torch.tensor(10.0)
    state = (P.R[None], P.t[None], P.landmarks[None])
    if solver == "dense":
        ours = ba._gn_step(*state, plan, P.uv, P.weight, P.consts, lam, True)
        ref = jax.jit(lambda R, t, lm: jba._gn_step(
            R, t, lm, prob, None, 10.0, True))(prob.R, prob.t,
                                               prob.landmarks)
    else:
        ours = ba._gn_step_cg(*state, plan, P.uv, P.weight, P.consts, lam,
                              True, 250, 1e-5)
        ref = jax.jit(lambda R, t, lm: jba._gn_step_cg(
            R, t, lm, prob, None, 10.0, True, 250, 1e-5))(
            prob.R, prob.t, prob.landmarks)
    for a, b, old in zip(ours[:3], ref[:3], (prob.R, prob.t,
                                             prob.landmarks)):
        assert step_err(a[0], b, old) <= STEP_TOL
    np.testing.assert_allclose(np_(ours[3])[0], float(ref[3]), rtol=1e-5)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_one_pose_graph_step_matches_klt_tpu(solver):
    pg, *_ = _synthetic_pose_graph(np.random.RandomState(5), n_pose=8,
                                   noise=0.02)
    G = port_pg(pg)
    plan = pose_graph._Plan(G, 8, dense=solver == "dense")
    lam = torch.tensor(1e-3)
    if solver == "dense":
        ours = pose_graph._gn_step(G.R, G.t, G, plan, lam, True)
        ref = jax.jit(lambda R, t: jpg._gn_step(R, t, pg, None, 1e-3,
                                                True))(pg.R, pg.t)
    else:
        ours = pose_graph._gn_step_cg(G.R, G.t, G, plan, lam, True, 200,
                                      1e-6)
        ref = jax.jit(lambda R, t: jpg._gn_step_cg(
            R, t, pg, None, 1e-3, True, 200, 1e-6))(pg.R, pg.t)
    for a, b, old in zip(ours, ref[:2], (pg.R, pg.t)):
        assert step_err(a, b, old) <= STEP_TOL


# an LM accept decision whose cost change is below the two packages'
# disagreement on a cost (measured: 7e-5 relative) is a near tie: f32
# rounding decides it, and the two packages may decide it differently
NEAR_TIE = 1e-4


def assert_same_accepts(ours, ref, c0):
    """The LM's accepted steps (a plain least-squares run's cost falls
    exactly where a step was accepted) are the same in both packages,
    except at near ties, which are named in the failure message if any
    other step differs."""
    flags, drops = [], []
    for costs in (np_(ours), np.asarray(ref)):
        c = np.concatenate([[c0], costs]).astype(np.float64)
        flags.append(c[1:] < c[:-1])
        drops.append((c[:-1] - c[1:]) / c[:-1])
    differ = np.flatnonzero(flags[0] != flags[1])
    near = [int(i) for i in differ
            if max(drops[0][i], drops[1][i]) < NEAR_TIE]
    assert list(differ) == near, (
        f"accepted steps differ at iterations {list(differ)}; near ties "
        f"(cost change under {NEAR_TIE} relative): {near}")
    assert flags[0][0] and flags[1][0]


# tests/test_slam.py's cases, run on both packages.  klt_tpu compiles its
# LM scan on every call, and pytest-xdist may run a module's tests in
# several workers, so each test runs only what it checks.


def test_ba_converges():
    prob, R_true, t_true, lm_true = _synthetic_problem(
        np.random.RandomState(0))
    R, t, lm, costs = ba.bundle_adjust(port(prob), iterations=15,
                                       damping=1e-4)
    ref = jba.bundle_adjust(prob, iterations=15, damping=1e-4)
    costs = np_(costs)
    assert costs[-1] < costs[0] * 1e-4
    assert np.abs(np_(lm) - lm_true).max() < 2e-2
    np.testing.assert_allclose(np_(lm), np.asarray(ref[2]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(np_(t), np.asarray(ref[1]), rtol=0,
                               atol=1e-3)


def test_ba_cg_matches_dense():
    prob, *_ = _synthetic_problem(np.random.RandomState(2))
    dense = ba.bundle_adjust(port(prob), iterations=10, damping=1e-4)
    cg = ba.bundle_adjust_cg(port(prob), iterations=10, damping=1e-4)
    cc = np_(cg[3])
    assert cc[-1] < cc[0] * 1e-4
    np.testing.assert_allclose(np_(cg[2]), np_(dense[2]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np_(cg[1]), np_(dense[1]), rtol=0, atol=2e-3)
    jcg = jba.bundle_adjust_cg(prob, iterations=10, damping=1e-4)
    np.testing.assert_allclose(np_(cg[2]), np.asarray(jcg[2]), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("which", ["dense", "cg", "huber"])
def test_ba_cost_curves_match_klt_tpu(which):
    """The dense step, the CG step and Huber IRLS (dense) on a problem
    with 0.3 px of noise: cost curves within CURVE_TOL; the plain runs
    accept the same steps up to near ties (under IRLS the weights change
    every iteration, so the curve does not show the accepts)."""
    prob, *_ = _synthetic_problem(np.random.RandomState(1), noise=0.3)
    f, jf = {"cg": (ba.bundle_adjust_cg, jba.bundle_adjust_cg)}.get(
        which, (ba.bundle_adjust, jba.bundle_adjust))
    kw = {"robust_delta": 2.0} if which == "huber" else {}
    ours = f(port(prob), iterations=8, damping=1e-4, **kw)
    ref = jf(prob, iterations=8, damping=1e-4, **kw)
    np.testing.assert_allclose(np_(ours[3]), np.asarray(ref[3]),
                               rtol=CURVE_TOL)
    P = port(prob)
    c0 = float(ba._total_cost(P.R, P.t, P.landmarks, P))
    assert np_(ours[3])[-1] < c0 * 1e-2
    if which != "huber":
        assert_same_accepts(ours[3], ref[3], c0)


def test_ba_gated_rejects_outlier_spike():
    """test_slam.py's problem with 40% of the observations moved by 8-60
    px: its assertions on the port, and klt_tpu's gate decisions and cost
    curve."""
    rng = np.random.RandomState(7)
    prob, *_ = _synthetic_problem(rng, n_pose=4, n_lm=60, noise=0.3)
    m = int(prob.uv.shape[0])
    spike = rng.rand(m) < 0.4
    off = rng.uniform(8.0, 60.0, (m, 2)).astype(np.float32) * \
        np.sign(rng.randn(m, 2)).astype(np.float32)
    uv = np.asarray(prob.uv) + np.where(spike[:, None], off, 0.0)
    prob = dataclasses.replace(prob, uv=jnp.asarray(uv.astype(np.float32)))
    kw = dict(rounds=3, iterations=10, damping=1e-2, robust_delta=2.0,
              gate_px=3.0)
    R, t, lm, costs, active = ba.bundle_adjust_gated(port(prob), **kw)
    costs = np_(costs)
    assert costs[-1] < costs[0]
    assert active[spike].mean() <= 0.05, active[spike].mean()
    assert active[~spike].mean() >= 0.70, active[~spike].mean()
    rn = np_(ba._residual_norms(R, t, lm, port(prob)))
    assert np.sqrt(np.mean(rn[active] ** 2)) <= 1.0
    assert (rn[active] <= 3.0).mean() >= 0.98
    ref = jba.bundle_adjust_gated(prob, **kw)
    np.testing.assert_array_equal(active, np.asarray(ref[4]))
    np.testing.assert_allclose(costs, np.asarray(ref[3]), rtol=CURVE_TOL)


def test_pose_graph_converges():
    pg, R_true, t_true = _synthetic_pose_graph(np.random.RandomState(5),
                                               noise=0.0)
    R, t, costs = pose_graph.optimize_pose_graph(port_pg(pg), iterations=15)
    assert np_(costs)[-1] < 1e-6
    assert np.abs(np_(t) - t_true).max() < 1e-2
    assert np.abs(np_(R) - R_true).max() < 1e-2
    ref = jpg.optimize_pose_graph(pg, iterations=15)
    np.testing.assert_allclose(np_(t), np.asarray(ref[1]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_cg_matches_dense(solver):
    """CG against the dense solve (test_slam.py), and each against
    klt_tpu's: LM cost curves (noise 0.02 keeps the floor far above
    rounding), accepted steps and poses."""
    pg, *_ = _synthetic_pose_graph(np.random.RandomState(5), n_pose=8,
                                   noise=0.02)
    G = port_pg(pg)
    dense = pose_graph.optimize_pose_graph(G, iterations=8, solver="dense")
    cg = pose_graph.optimize_pose_graph(G, iterations=8, solver="cg")
    np.testing.assert_allclose(np_(cg[2])[-1], np_(dense[2])[-1],
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(np_(cg[1]), np_(dense[1]), rtol=0, atol=1e-3)
    ours = dense if solver == "dense" else cg
    ref = jpg.optimize_pose_graph(pg, iterations=8, solver=solver)
    c0 = float(pose_graph._edge_cost(G.R, G.t, G))
    np.testing.assert_allclose(np_(ours[2]), np.asarray(ref[2]),
                               rtol=CURVE_TOL)
    assert_same_accepts(ours[2], ref[2], c0)
    np.testing.assert_allclose(np_(ours[1]), np.asarray(ref[1]), rtol=0,
                               atol=1e-4)


def test_keyframes_overlap():
    val = -np.ones((10, 8), np.int32)
    for i in range(10):
        val[i, : 8 - i // 2] = 0
    kfs = chains.select_keyframes(val, overlap_thresh=0.7)
    assert kfs[0] == 0 and len(kfs) >= 2
    np.testing.assert_array_equal(
        kfs, jchains.select_keyframes(val, overlap_thresh=0.7))


def test_keyframes_replacement_not_survival():
    n, t = 20, 12
    val = np.zeros((n, t), np.int32)
    for j in range(1, t):
        val[(j % 2)::2, j] = 1000
    kfs = chains.select_keyframes(val, overlap_thresh=0.7, min_gap=1)
    assert len(kfs) >= t // 2, f"keyframes {kfs}"
    np.testing.assert_array_equal(
        kfs, jchains.select_keyframes(val, overlap_thresh=0.7, min_gap=1))


def test_tracks_from_table():
    val = np.array([[10, 0, 0, -2, 5, 0],
                    [3, 0, -1, 7, 0, 0]], np.int32)
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    y = x + 100
    tid, frame, u, v = chains.tracks_from_table(x, y, val, min_length=2)
    assert len(np.unique(tid)) == 4 and len(tid) == 10
    for t in np.unique(tid):
        assert (np.diff(frame[tid == t]) == 1).all()


def test_keyframe_pose_graph_init_recovers_translation():
    """Tiny pairwise BAs (solved as one batch) -> pose graph on a
    forward-translating trajectory: rotations near identity, the
    translation direction recovered, and klt_tpu's poses within 1e-3."""
    rng = np.random.RandomState(7)
    fx = fy = 300.0
    cx, cy = 160.0, 120.0
    n_pose, n_lm = 5, 120
    lm = rng.uniform([-2, -2, 3], [2, 2, 6], (n_lm, 3)).astype(np.float32)
    t_true = np.stack([[0.12 * p, 0.03 * p, 0.0]
                       for p in range(n_pose)]).astype(np.float32)
    cam_idx = np.repeat(np.arange(n_pose, dtype=np.int32), n_lm)
    lm_idx = np.tile(np.arange(n_lm, dtype=np.int32), n_pose)
    p_cam = lm[lm_idx] + t_true[cam_idx]
    uv = np.asarray(jgeo.project(jnp.asarray(p_cam), fx, fy, cx, cy))
    args = (lm_idx, cam_idx, uv[:, 0], uv[:, 1], n_pose, fx, fy, cx, cy)
    R, t, costs = frontend.keyframe_pose_graph_init(*args, device="cpu")
    assert np.abs(R - np.eye(3)[None]).max() < 0.05
    d_est, d_true = t[-1] - t[0], t_true[-1] - t_true[0]
    cos = float(d_est @ d_true /
                (np.linalg.norm(d_est) * np.linalg.norm(d_true) + 1e-9))
    assert cos > 0.95, f"direction cosine {cos}"
    jR, jt, jcosts = jfront.keyframe_pose_graph_init(*args)
    np.testing.assert_allclose(R, jR, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-3)


def test_pair_solve_batch_equals_one_pair_at_a_time():
    """The hand-batched pair solve gives each pair what a batch of one
    gives it (segments, solves and damping per pair), within 1e-5: a
    batched product may sum in another order, and these pure translations
    leave the rotation weakly determined (|R - I| ~ 1e-5, measured 1.7e-6
    apart)."""
    rng = np.random.RandomState(8)
    b, m, L = 3, 64, 64
    lm0 = np.concatenate([rng.uniform(-0.5, 0.5, (b, L, 2)),
                          np.ones((b, L, 1))], -1).astype(np.float32)
    cam = np.tile(np.repeat([0, 1], m // 2), (b, 1)).astype(np.int32)
    lmi = np.tile(np.tile(np.arange(m // 2), 2), (b, 1)).astype(np.int32)
    uv = np.zeros((b, m, 2), np.float32)
    t0 = np.zeros((b, 2, 3), np.float32)
    for k in range(b):
        shift = np.array([0.05 * (k + 1), -0.02, 0.0], np.float32)
        p = lm0[k, lmi[k]] + np.where(cam[k, :, None] == 1, shift, 0.0)
        uv[k] = 300 * p[:, :2] / p[:, 2:] + [160, 120]
    weight = np.ones((b, m), np.float32)
    weight[:, -10:] = 0.0  # padding, left out of the segment sums
    args = [torch.from_numpy(a) for a in (t0, lm0, cam, lmi, uv, weight)]
    Rb, tb = frontend._pair_solve(*args, 300.0, 300.0, 160.0, 120.0, 8)
    for k in range(b):
        R1, t1 = frontend._pair_solve(*[a[k:k + 1] for a in args], 300.0,
                                      300.0, 160.0, 120.0, 8)
        np.testing.assert_allclose(R1[0].numpy(), Rb[k].numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(t1[0].numpy(), tb[k].numpy(), rtol=0,
                                   atol=1e-5)
    assert torch.isfinite(tb).all() and (tb[:, 1, 0] > 0).all()


def test_segment_sums_repeat_to_the_bit():
    """Segments: the same call twice gives the same bits; the sums equal
    index_add_ within f32 rounding; negative ids are left out."""
    rng = np.random.RandomState(9)
    idx = torch.from_numpy(rng.randint(0, 50, 4000))
    idx[::7] = -1
    vals = torch.from_numpy(rng.randn(4000, 3, 2).astype(np.float32))
    seg = Segments(idx, 60)
    a, b = seg.sum(vals), Segments(idx, 60).sum(vals)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    keep = idx >= 0
    ref = torch.zeros(60, 3, 2, dtype=torch.float64).index_add_(
        0, idx[keep], vals[keep].double())
    np.testing.assert_allclose(a.double().numpy(), ref.numpy(), rtol=0,
                               atol=1e-4)
    assert (a[50:] == 0).all()


def test_interop_round_trips():
    prob, *_ = _synthetic_problem(np.random.RandomState(0))
    fields = ba_problem_to_numpy(port(prob))
    for k, v in vars(prob).items():
        np.testing.assert_array_equal(fields[k], np.asarray(v))
    pg, *_ = _synthetic_pose_graph(np.random.RandomState(5))
    fields = pose_graph_to_numpy(port_pg(pg))
    for k, v in vars(pg).items():
        np.testing.assert_array_equal(fields[k], np.asarray(v))
    with pytest.raises(ValueError, match="fields"):
        ba_problem_from_numpy({"R": fields["R"]})


def test_padding_for_a_mesh_changes_no_cost():
    """Zero-weight rows that change no cost."""
    prob = port(_synthetic_problem(np.random.RandomState(0), n_pose=2,
                                   n_lm=8)[0])
    pg = port_pg(_synthetic_pose_graph(np.random.RandomState(5))[0])
    padded = prob.pad_observations(8)
    assert padded.cam_idx.shape[0] % 8 == 0
    assert float(ba._total_cost(prob.R, prob.t, prob.landmarks, padded)) == \
        float(ba._total_cost(prob.R, prob.t, prob.landmarks, prob))
    pe = pg.pad_edges(4)
    assert pe.ei.shape[0] % 4 == 0 and (pe.weight[pg.ei.shape[0]:] == 0).all()
