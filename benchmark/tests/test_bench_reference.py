"""The references against the port at small sizes on the CPU: the frozen
plain versions (benchmark/reference/klt.py) bit for bit, so that the
comparison can ask for equality; the SLAM hand-off exactly and its float64
back end (benchmark/reference/slam) within the pending map cell's
tolerances."""

import numpy as np
import pytest
import torch

import klt_tpu_torch as kt
from benchmark import frames as frame_gen
from benchmark.reference import check, klt
from klt_tpu_torch.kernels import gaussian_kernels
from klt_tpu_torch.ops.lk import track_features_pyramid_levels
from klt_tpu_torch.ops.pyramid import build_pyramid_stacks_plain
from klt_tpu_torch.ops.replace import replace_lost_plain_
from klt_tpu_torch.ops.selection import corner_response_plain

MIX = {"pool": 4, "circle_radius": 6.0, "streams": 1,
       "blocks": {"width": 24, "height": 12, "speeds": [2.0, 3.0],
                  "lanes": [0.2, 0.7], "directions": [1, -1],
                  "phases": [0.0, 0.5]}}


def _frames(seed=5, w=160, h=120):
    return frame_gen.streams(w, h, MIX, seed, "cpu")[0]


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) \
        if a.dtype == torch.float32 else torch.equal(a, b)


@pytest.mark.parametrize("window,search", [(7, 15), (5, 10), (9, 30)])
def test_config_derives_as_the_port(window, search):
    prog = kt.TrackingConfig(window_width=window, window_height=window,
                             search_range=search)
    ref = klt.Config(window_width=window, window_height=window,
                     search_range=search)
    for k in ("n_pyramid_levels", "subsampling", "borderx", "bordery"):
        assert getattr(prog, k) == getattr(ref, k), k
    for sigma in (ref.smooth_sigma, ref.grad_sigma, ref.pyramid_sigma):
        for a, b in zip(gaussian_kernels(sigma), klt.gaussian_kernels(sigma)):
            assert np.array_equal(a, b)


def test_pyramid_bit_equal():
    cfg, f = kt.TrackingConfig(), _frames()
    for a, b in zip(build_pyramid_stacks_plain(f[0], cfg),
                    klt.pyramid(f[0], klt.Config())):
        assert _bits_equal(a, b)


def test_track_and_response_bit_equal():
    cfg, ref = kt.TrackingConfig(), klt.Config()
    f = _frames()
    s1 = build_pyramid_stacks_plain(f[0], cfg)
    s2 = build_pyramid_stacks_plain(f[1], cfg)
    g = torch.Generator().manual_seed(3)
    n = 64
    x = torch.rand(n, generator=g) * 150 + 5
    y = torch.rand(n, generator=g) * 110 + 5
    val = torch.randint(-1, 50, (n,), generator=g, dtype=torch.int32)
    want = track_features_pyramid_levels(s1, s2, x, y, val, cfg, plain=True)
    got = klt.track(s1, s2, x, y, val, ref)
    for a, b in zip(want, got):
        assert _bits_equal(a, b)
    assert (got[2] >= 0).any() and (got[2] < 0).any()
    r_want = corner_response_plain(s2[0][1], s2[0][2], 7, 7)
    r_got = klt.corner_response(s2[0][1], s2[0][2], ref)
    assert _bits_equal(r_want, r_got)


@pytest.mark.parametrize("lost", [4, 30, 64])
def test_replace_equal_and_judged_greedy(lost):
    cfg, ref = kt.TrackingConfig(), klt.Config()
    s = build_pyramid_stacks_plain(_frames()[1], cfg)
    resp = corner_response_plain(s[0][1], s[0][2], 7, 7)
    g = torch.Generator().manual_seed(lost)
    n = 64
    x = torch.rand(n, generator=g) * 100 + 30
    y = torch.rand(n, generator=g) * 60 + 30
    val = torch.full((n,), 5, dtype=torch.int32)
    val[torch.randperm(n, generator=g)[:lost]] = -2
    want = [t.clone() for t in (x, y, val)]
    replace_lost_plain_(resp, *want, cfg)
    got = klt.replace(resp, x, y, val, ref)
    for a, b in zip(want, got):
        assert _bits_equal(a, b)
    assert check.replace_faults(resp, (x, y, val), tuple(got), ref) == 0
    # a point that is not the best left is no greedy pick
    bad = [t.clone() for t in got]
    slot = int((val < 0).nonzero()[0])
    bad[0][slot] += 1.0
    assert check.replace_faults(resp, (x, y, val), tuple(bad), ref) >= 1


def test_tie_member_is_greedy():
    """Either member of a tie of truncated values is a greedy pick (the
    reference's quicksort may take the later one), a third point is
    not, and a slot left lost while candidates remain is a fault."""
    ref = klt.Config()
    resp = torch.zeros(120, 160)
    resp[40, 40] = 900.25
    resp[80, 120] = 900.75          # the same truncated value
    resp[60, 60] = 500.0
    x = torch.tensor([-1.0, -1.0, 100.0])
    y = torch.tensor([-1.0, -1.0, 30.0])
    val = torch.tensor([-2, -3, 7], dtype=torch.int32)
    later = (torch.tensor([120.0, 40.0, 100.0]),
             torch.tensor([80.0, 40.0, 30.0]),
             torch.tensor([900, 900, 7], dtype=torch.int32))
    assert check.replace_faults(resp, (x, y, val), later, ref) == 0
    third = (torch.tensor([60.0, 40.0, 100.0]), later[1].clone(),
             torch.tensor([500, 900, 7], dtype=torch.int32))
    third[1][0] = 60.0
    assert check.replace_faults(resp, (x, y, val), third, ref) >= 1
    left = (torch.tensor([120.0, -1.0, 100.0]),
            torch.tensor([80.0, -1.0, 30.0]),
            torch.tensor([900, -1, 7], dtype=torch.int32))
    assert check.replace_faults(resp, (x, y, val), left, ref) == 1


def _slam_problem(seed=0, n_pose=6, n_lm=120):
    """Observations of landmarks 3-6 units ahead by a camera moving 0.1
    to the side a keyframe, with 0.3 px of noise."""
    rng = np.random.default_rng(seed)
    lm = np.c_[rng.uniform(-1, 1, n_lm), rng.uniform(-1, 1, n_lm),
               rng.uniform(3, 6, n_lm)].astype(np.float32)
    fx = fy = 576.0
    cx, cy = 320.0, 240.0
    cam, lmi, us, vs = [], [], [], []
    for p in range(n_pose):
        pc = lm + np.array([-0.1 * p, 0, 0], np.float32)
        seen = rng.random(n_lm) < 0.8
        cam += [p] * int(seen.sum())
        lmi += list(np.nonzero(seen)[0])
        us += list((fx * pc[:, 0] / pc[:, 2] + cx +
                    rng.normal(0, 0.3, n_lm))[seen])
        vs += list((fy * pc[:, 1] / pc[:, 2] + cy +
                    rng.normal(0, 0.3, n_lm))[seen])
    cam = np.array(cam, np.int32)
    lmi = np.unique(np.array(lmi), return_inverse=True)[1].astype(np.int32)
    return (lmi, cam, np.array(us, np.float32), np.array(vs, np.float32),
            n_pose, (fx, fy, cx, cy))


SLAM = {"pair_iters": 8, "pg_iters": 10, "ba_rounds": 3, "ba_iterations": 17,
        "robust_delta": 2.0, "gate_px": 2.0}


def test_slam_reference_agrees_with_the_port():
    """The float64 back end (benchmark/reference/slam/solve.py), written
    from the math, against the port's on the CPU: the pose graph's poses
    within 1e-4, and the gated bundle adjustment's loss within 1e-3 of
    the descent, from the same observations."""
    from benchmark.reference.slam import handoff, solve
    from klt_tpu_torch.slam import ba as pba
    from klt_tpu_torch.slam.frontend import keyframe_pose_graph_init
    lmi, cam, u, v, n_pose, intr = _slam_problem()
    k = solve.Intrinsics(*intr)
    R0, t0, _ = keyframe_pose_graph_init(lmi, cam, u, v, n_pose, *intr,
                                         device="cpu")
    ref = solve.back_end(lmi, cam, u, v, n_pose, k, SLAM)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    assert solve.pose_gap(on(R0), on(t0), ref["pg_R"], ref["pg_t"]) < 1e-4
    first = handoff.first_observation(lmi)
    X0 = np.stack([(u[first] - k.cx) / k.fx, (v[first] - k.cy) / k.fy,
                   np.ones(len(first))], -1).astype(np.float32)
    prob = pba.BAProblem(R=on(R0), t=on(t0), landmarks=on(X0),
                         cam_idx=on(cam), lm_idx=on(lmi),
                         uv=on(np.stack([u, v], -1)),
                         weight=torch.ones(len(cam)), fx=k.fx, fy=k.fy,
                         cx=k.cx, cy=k.cy)
    R, t, X, _, _ = pba.bundle_adjust_gated(prob, rounds=3, iterations=17)
    assert abs(solve.loss_gap(R, t, X, ref, k, 2.0)) < 1e-3
    # the adjustment's start falls short of the whole descent
    assert solve.loss_gap(*ref["start"], ref, k, 2.0) == pytest.approx(1.0)


def test_reference_jacobians_match_differences():
    """The reference's analytic reprojection Jacobians against central
    differences of its residuals, in float64."""
    from benchmark.reference.slam import solve
    g = torch.Generator().manual_seed(1)
    m = 5
    R = solve.so3_exp(torch.rand(m, 3, generator=g, dtype=torch.float64))
    t = torch.rand(m, 3, generator=g, dtype=torch.float64)
    X = torch.rand(m, 3, generator=g, dtype=torch.float64) + \
        torch.tensor([0.0, 0.0, 4.0], dtype=torch.float64)
    obs = solve.Observations(torch.arange(m), torch.arange(m),
                             torch.zeros(m, 2, dtype=torch.float64))
    k = solve.Intrinsics(500.0, 480.0, 320.0, 240.0)
    r0, pc = solve.residuals(R, t, X, obs, k)
    jp, jl = solve.jacobians(R, pc, obs, k)
    h = 1e-6
    for c in range(6):
        dx = torch.zeros(m, 6, dtype=torch.float64)
        dx[:, c] = h
        a = solve.residuals(*solve._update(R, t, dx), X, obs, k)[0]
        b = solve.residuals(*solve._update(R, t, -dx), X, obs, k)[0]
        assert torch.allclose((a - b) / (2 * h), jp[:, :, c], atol=1e-5)
    for c in range(3):
        d = torch.zeros(m, 3, dtype=torch.float64)
        d[:, c] = h
        a = solve.residuals(R, t, X + d, obs, k)[0]
        b = solve.residuals(R, t, X - d, obs, k)[0]
        assert torch.allclose((a - b) / (2 * h), jl[:, :, c], atol=1e-5)


def test_handoff_equals_the_ports():
    """The reference's hand-off (chains, keyframes, observations) against
    the port's examples/slam_pipeline.py on a table with selections,
    tracks and losses: the same arrays."""
    import types
    from benchmark.reference.slam import handoff
    from klt_tpu_torch.examples import slam_pipeline
    rng = np.random.default_rng(4)
    n, t = 60, 50
    val = np.zeros((n, t), np.int32)
    val[:, 0] = 9
    for row in range(n):
        for col in rng.choice(np.arange(1, t), 6, replace=False):
            val[row, col] = -1 if rng.random() < 0.5 else 17
    x = rng.uniform(0, 600, (n, t)).astype(np.float32)
    y = rng.uniform(0, 400, (n, t)).astype(np.float32)
    want = slam_pipeline.keyframe_observations(
        types.SimpleNamespace(x=x, y=y, val=val))
    got = handoff.observations(x, y, val, 0.8, 3)
    assert len(want[0]) >= 3
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
