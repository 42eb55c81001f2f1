"""The SLAM solvers' programs (slam/solvers.py::LMSolve, cuda/graph.py)
held against their eager bodies on the CPU, bit for bit.

On the CPU a program runs its step functions without capture, so these
tests hold the bookkeeping the card's graphs replay: the copies into the
static buffers, the accept test written in place, the cost slot copied
out after each LM iteration, CG's chunks of CG_CHECK_EVERY masked
iterations and its stop, the gated BA's rounds and landmark refits on
one solve.  The problems are tests/test_slam.py's, as
tests/test_torch_slam.py hands them to both packages; the card runs the
same comparisons at full size (tests/test_torch_cuda.py, chip_smoke.py
phase 42)."""

import dataclasses

import numpy as np
import pytest
import torch

from klt_tpu_torch.interop import ba_problem_from_numpy, pose_graph_from_numpy
from klt_tpu_torch.slam import ba, frontend, pose_graph, solvers
from test_slam import _synthetic_pose_graph, _synthetic_problem


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def solves(monkeypatch):
    """Every LMSolve made while the test runs."""
    made = []
    init = solvers.LMSolve.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
    monkeypatch.setattr(solvers.LMSolve, "__init__", spy)
    return made


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bits_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(bits(a), bits(b))


def ba_problem(seed=1, spiked=False):
    rng = np.random.RandomState(seed)
    prob, *_ = _synthetic_problem(rng, noise=0.3)
    f = {k: np.asarray(v) if not isinstance(v, float) else v
         for k, v in vars(prob).items()}
    if spiked:   # test_slam.py's gated problem: 40% moved by 8-60 px
        m = len(f["uv"])
        spike = rng.rand(m) < 0.4
        off = rng.uniform(8.0, 60.0, (m, 2)).astype(np.float32) * \
            np.sign(rng.randn(m, 2)).astype(np.float32)
        f["uv"] = (f["uv"] + np.where(spike[:, None], off, 0.0)).astype(
            np.float32)
    return ba_problem_from_numpy(f, "cpu")


def pose_graph_problem():
    pg, *_ = _synthetic_pose_graph(np.random.RandomState(5), n_pose=8,
                                   noise=0.02)
    return pose_graph_from_numpy({k: np.asarray(v) for k, v in
                                  vars(pg).items()}, "cpu")


def eager_ba(P, iterations, damping, robust_delta=None, cg=None):
    """`_lm_drive_eager` itself (what `_bundle_adjust_eager` wraps)."""
    plan = ba._plan_of(P, joint=cg is None)
    return ba._lm_drive_eager(P, plan, iterations, damping,
                              ba._gn_step_of(True, cg), robust_delta)


GATED = dict(rounds=3, iterations=6, damping=1e-2, robust_delta=2.0,
             gate_px=3.0, cg_iters=40)


CASES = {
    "bundle_adjust": (
        lambda: ba.bundle_adjust(ba_problem(), iterations=6, damping=1e-4),
        lambda: eager_ba(ba_problem(), 6, 1e-4)),
    "bundle_adjust huber": (
        lambda: ba.bundle_adjust(ba_problem(), iterations=6, damping=1e-4,
                                 robust_delta=2.0),
        lambda: eager_ba(ba_problem(), 6, 1e-4, robust_delta=2.0)),
    "bundle_adjust_cg": (
        lambda: ba.bundle_adjust_cg(ba_problem(), iterations=6,
                                    damping=1e-4, cg_iters=30),
        lambda: eager_ba(ba_problem(), 6, 1e-4, cg=(30, 1e-5))),
    "bundle_adjust_cg huber": (
        lambda: ba.bundle_adjust_cg(ba_problem(), iterations=6,
                                    damping=1e-4, cg_iters=30,
                                    robust_delta=2.0),
        lambda: eager_ba(ba_problem(), 6, 1e-4, robust_delta=2.0,
                         cg=(30, 1e-5))),
    "bundle_adjust_gated": (
        lambda: ba.bundle_adjust_gated(ba_problem(7, spiked=True), **GATED),
        lambda: ba._bundle_adjust_gated_eager(ba_problem(7, spiked=True),
                                              **GATED)),
    "optimize_pose_graph dense": (
        lambda: pose_graph.optimize_pose_graph(pose_graph_problem(),
                                               iterations=8),
        lambda: pose_graph._optimize_pose_graph_eager(pose_graph_problem(),
                                                      iterations=8)),
    "optimize_pose_graph cg": (
        lambda: pose_graph.optimize_pose_graph(pose_graph_problem(),
                                               iterations=8, solver="cg"),
        lambda: pose_graph._optimize_pose_graph_eager(
            pose_graph_problem(), iterations=8, solver="cg")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_eager_body(case, solves):
    """Each entry point's program path bit-equal to its eager body (the
    gated BA's rounds and refits on one solve: its LM steps run every
    iteration, its refit 3 steps between rounds)."""
    graphed, eager = CASES[case]
    got = graphed()
    assert len(solves) == 1
    ref = eager()
    assert len(solves) == 1
    assert_bits_equal(got, ref)
    s = solves[0]
    if case == "bundle_adjust_gated":
        assert s.cg.chunks > 0 and s.warm
        assert len(got[3]) == GATED["rounds"] * GATED["iterations"]


def test_pair_solves_equal_eager_body(monkeypatch):
    """build_keyframe_pose_graph's pair solves (one program for every
    pair) bit-equal to `_pair_solve_eager`, and the graph they build."""
    rng = np.random.RandomState(3)
    prob, *_ = _synthetic_problem(rng, n_pose=5, n_lm=120, noise=0.2)
    uv = np.asarray(prob.uv)
    args = (np.asarray(prob.lm_idx), np.asarray(prob.cam_idx), uv[:, 0],
            uv[:, 1], 5, 300.0, 300.0, 160.0, 120.0)
    calls = []
    solve = frontend._pair_solve

    def spy(*a):
        out = solve(*a)
        calls.append((a, out))
        return out
    monkeypatch.setattr(frontend, "_pair_solve", spy)
    got = frontend.build_keyframe_pose_graph(*args, device="cpu")
    monkeypatch.setattr(frontend, "_pair_solve", frontend._pair_solve_eager)
    ref = frontend.build_keyframe_pose_graph(*args, device="cpu")
    assert len(calls) == 1 and calls[0][0][0].shape[0] == 7   # 4 + 3 pairs
    assert_bits_equal(calls[0][1], frontend._pair_solve_eager(*calls[0][0]))
    assert_bits_equal([getattr(got, f.name) for f in
                       dataclasses.fields(got)],
                      [getattr(ref, f.name) for f in
                       dataclasses.fields(ref)])


def spd_system(kind: str, n: int = 24):
    """A seeded SPD system [n, n], its right-hand side and a Jacobi
    preconditioner.  "few": 5 distinct eigenvalues, so CG converges in 5
    iterations; "hard": eigenvalues over 6 orders of magnitude."""
    rng = np.random.RandomState(11)
    q, _ = np.linalg.qr(rng.randn(n, n))
    ev = np.tile([1.0, 2.0, 3.5, 5.0, 9.0], n)[:n] if kind == "few" else \
        np.logspace(0, 6, n)
    A = torch.from_numpy(((q * ev) @ q.T).astype(np.float32))
    A = 0.5 * (A + A.T)
    if kind == "few":   # the identity preconditioner keeps 5 eigenvalues
        dinv = torch.ones(n)
    else:
        dinv = 1.0 / torch.diagonal(A)
    rhs = torch.from_numpy(rng.randn(n).astype(np.float32))
    return (lambda v: A @ v), (lambda v: dinv * v), rhs


def cg_while_loop(matvec, precond, rhs, cg_iters, cg_tol):
    """klt_tpu's `while_loop`: iterate while k < cg_iters and |r|^2 >
    cg_tol^2 |rhs|^2, unmasked.  Returns (x, iterations run)."""
    x, rr, p, rz, stop = solvers._cg_start(precond, rhs, cg_tol)
    k = 0
    while k < cg_iters and bool(torch.sum(rr * rr) > stop):
        hp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
        x, rr = x + alpha * p, rr - alpha * hp
        z = precond(rr)
        rz_n = torch.sum(rr * z)
        p = z + rz_n / torch.clamp(rz, min=1e-30) * p
        rz = rz_n
        k += 1
    return x, k


@pytest.mark.parametrize("kind,cg_iters,ran,chunks", [
    ("few", 40, 5, 1),       # stops in the middle of the first chunk
    ("hard", 11, 11, 2),     # cg_iters not a multiple of 8: 8 + 3
    ("hard", 16, 16, 2),     # cg_iters reached unconverged
])
def test_cg_program_equals_pcg(kind, cg_iters, ran, chunks):
    """CG's program (static buffers, chunks, the flag read after each but
    the last) bit-equal to `pcg` and to klt_tpu's loop that stops at the
    first failing iteration, with the chunks it needs."""
    matvec, precond, rhs = spd_system(kind)
    ref, k = cg_while_loop(matvec, precond, rhs, cg_iters, 1e-5)
    assert k == ran
    cg = solvers.CG(rhs.shape, torch.device("cpu"), cg_iters, 1e-5, False)
    cg.start(matvec, precond, rhs)
    x = cg.solve()
    assert cg.chunks == chunks
    assert torch.equal(bits(x), bits(ref))
    assert torch.equal(bits(x), bits(solvers.pcg(matvec, precond, rhs,
                                                 cg_iters, 1e-5)))
    # a second solve of the same system on the same buffers
    cg.start(matvec, precond, rhs)
    assert torch.equal(bits(cg.solve()), bits(ref))


def test_results_are_the_callers(solves):
    """What a solve returns shares no storage with its static buffers,
    and a later solve changes none of it."""
    P = ba_problem()
    first = ba.bundle_adjust_cg(P, iterations=3, damping=1e-4, cg_iters=20)
    kept = [a.clone() for a in first]
    s = solves[0]
    static = {a.untyped_storage().data_ptr()
              for a in (s.R, s.t, s.lm, s.cost, s.cg.x)}
    assert not static & {a.untyped_storage().data_ptr() for a in first}
    G = pose_graph_problem()
    pg_out = pose_graph.optimize_pose_graph(G, iterations=3, solver="cg")
    ba.bundle_adjust_cg(ba_problem(2), iterations=3, damping=1e-4,
                        cg_iters=20)
    assert_bits_equal(first, kept)
    assert not {solves[1].R.untyped_storage().data_ptr(),
                solves[1].cost.untyped_storage().data_ptr()} & \
        {a.untyped_storage().data_ptr() for a in pg_out}
