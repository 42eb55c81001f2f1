"""Multi-process worker: one rank of an N-process torch.distributed run.

The counterpart of klt_tpu's tools/multihost_worker.py.  Exercises the
multi-process path: `initialize_multihost` on a FileStore ->
`global_data_mesh` over every rank -> `process_local_batch` host slicing
-> `make_batch_step` and `track_batch` over the mesh -> compared with the
same computation in this process alone, bit for bit; then the
observation-sharded bundle adjustments (dense, CG, gated) and the
edge-sharded pose graph (dense, CG), each within klt_tpu's tolerances of
the one-process run (bit for bit in a world of one).

    python -m klt_tpu_torch.parallel.worker <store> <rank> <nproc>
        [--feat F] [--features N] [--device cpu]

<store> is a file path for torch.distributed's FileStore (absent or empty
at the start), shared by the N ranks.  Prints "MULTIHOST OK" and exits 0
on success.  It runs on the card (one card a rank, NCCL) unless given
--device cpu (gloo).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrackingConfig
from ..device import default_device

# klt_tpu's own tolerances for its mesh runs (its tests/test_slam.py):
# costs; landmarks (and pose-graph t)
COST_RTOL = 2e-4
STATE_RTOL, STATE_ATOL = 1e-3, 1e-5


def synthetic_batch(b: int, n_feat: int, h: int = 80, w: int = 96,
                    t_len: int = 3):
    """uint8 [b, t_len, h, w] frames (a shared seeded texture, rolled by a
    per-sequence shift each frame) and features x, y f32 / val i32 [b,
    n_feat] at seeded places, one a sequence outside the frame, one in ten
    lost."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (h, w)).astype(np.uint8)
    for axis in (0, 1):   # some smoothness, so LK has gradients
        base = ((base.astype(np.int32) + np.roll(base, 1, axis)) // 2
                ).astype(np.uint8)
    frames = np.stack([np.stack([np.roll(base, s * (1 + q % 2) + q % 3, 1)
                                 for s in range(t_len)])
                       for q in range(b)])
    x = rng.uniform(20, w - 20, (b, n_feat)).astype(np.float32)
    y = rng.uniform(20, h - 20, (b, n_feat)).astype(np.float32)
    x[:, 0] = -3.0    # one feature outside the frame a sequence
    val = np.where(rng.rand(b, n_feat) < 0.1, -1, 0).astype(np.int32)
    return frames, x, y, val


def synthetic_ba(seed: int = 1, n_pose: int = 5, n_lm: int = 30,
                 noise: float = 0.3):
    """Numpy fields of a BAProblem (slam/ba.py): n_lm landmarks seen by
    every pose, uv with `noise` px, poses and landmarks perturbed, one
    observation in ten moved by 20 px (for the gate)."""
    from ..slam.geometry import project, so3_exp

    rng = np.random.RandomState(seed)
    lm = rng.uniform([-2, -2, 4], [2, 2, 8], (n_lm, 3)).astype(np.float32)
    R = np.stack([so3_exp(torch.from_numpy(rng.randn(3).astype(np.float32)
                                           * 0.02)).numpy()
                  for _ in range(n_pose)])
    t = np.stack([[0.1 * p, 0, 0] for p in range(n_pose)]).astype(np.float32)
    cam = np.repeat(np.arange(n_pose, dtype=np.int32), n_lm)
    lmi = np.tile(np.arange(n_lm, dtype=np.int32), n_pose)
    pc = np.einsum("mij,mj->mi", R[cam], lm[lmi]) + t[cam]
    uv = project(torch.from_numpy(pc.astype(np.float32)), 300.0, 300.0,
                 160.0, 120.0).numpy()
    uv = uv + noise * rng.randn(*uv.shape).astype(np.float32)
    uv[::10] += 20.0
    t0 = t + 0.02 * rng.randn(*t.shape).astype(np.float32)
    t0[0] = t[0]
    lm0 = lm + 0.05 * rng.randn(*lm.shape).astype(np.float32)
    return dict(R=R.astype(np.float32), t=t0.astype(np.float32),
                landmarks=lm0.astype(np.float32), cam_idx=cam, lm_idx=lmi,
                uv=uv.astype(np.float32),
                weight=np.ones(len(cam), np.float32),
                fx=300.0, fy=300.0, cx=160.0, cy=120.0)


def synthetic_pose_graph(seed: int = 2, n_pose: int = 7,
                         noise: float = 0.01):
    """Numpy fields of a PoseGraph (slam/pose_graph.py): an odometry
    chain with one loop closure, measurements with `noise`, initial poses
    perturbed."""
    from ..slam.geometry import so3_exp

    rng = np.random.RandomState(seed)
    rot = lambda s: so3_exp(torch.from_numpy(
        rng.randn(3).astype(np.float32) * s)).numpy()
    R_true = np.stack([rot(0.1) for _ in range(n_pose)])
    t_true = rng.randn(n_pose, 3).astype(np.float32)
    ei = np.asarray(list(range(n_pose - 1)) + [0], np.int32)
    ej = np.asarray(list(range(1, n_pose)) + [n_pose - 1], np.int32)
    Rz, tz = [], []
    for i, j in zip(ei, ej):
        Rr = R_true[i] @ R_true[j].T
        Rz.append(rot(noise) @ Rr)
        tz.append(t_true[i] - Rr @ t_true[j] +
                  noise * rng.randn(3).astype(np.float32))
    R0 = np.stack([R_true[0]] + [rot(0.05) @ R_true[p]
                                 for p in range(1, n_pose)])
    t0 = t_true + 0.05 * rng.randn(n_pose, 3).astype(np.float32)
    t0[0] = t_true[0]
    return dict(R=R0.astype(np.float32), t=t0.astype(np.float32), ei=ei,
                ej=ej, Rz=np.stack(Rz).astype(np.float32),
                tz=np.stack(tz).astype(np.float32),
                weight=np.ones(len(ei), np.float32))


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (-0.0 and +0.0 differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


def tracking_runs(mesh, feat_axis, n_features: int, dev):
    """make_batch_step and track_batch over the mesh and without one, on
    `synthetic_batch` (the features padded for the feat axis), every rank
    loading its process_local_batch slice of the frames and the ranks
    gathering the global batch.  Returns [(name, sharded outputs, one
    process's outputs), ...]."""
    from .batch import make_batch_step, pad_features_for_mesh, track_batch
    from .distributed import process_local_batch
    from .mesh import axis_size

    b = 2 * axis_size(mesh, "data")
    frames, x, y, val = synthetic_batch(b, n_features)
    x, y, val, n_orig = pad_features_for_mesh(
        x, y, val, axis_size(mesh, feat_axis))
    # the data-loading contract: each process reads its slice alone
    local, off = process_local_batch(b)
    mine = torch.from_numpy(frames[off:off + local]).to(dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    frames_t = torch.cat(parts)
    assert np.array_equal(frames_t.cpu().numpy(), frames)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    feats = [to(a) for a in (x, y, val)]
    cfg = TrackingConfig()
    pair = (frames_t[:, 0].contiguous(), frames_t[:, 1].contiguous())
    runs = [("make_batch_step",
             make_batch_step(cfg, mesh, feat_axis=feat_axis)(*pair, *feats),
             make_batch_step(cfg)(*pair, *feats)),
            ("track_batch",
             track_batch(frames_t, *feats, cfg, mesh, feat_axis),
             track_batch(frames_t, *feats, cfg))]
    return [(name, [o[..., :n_orig] for o in got],
             [o[..., :n_orig] for o in ref]) for name, got, ref in runs]


def solver_runs(mesh, dev):
    """The bundle adjustments and the pose graph over the mesh's "data"
    axis and without a mesh.  Returns [(name, sharded outputs, one
    process's outputs), ...] with the outputs' tensors (and the gated
    BA's active mask as a tensor)."""
    from ..interop import ba_problem_from_numpy, pose_graph_from_numpy
    from ..slam import (bundle_adjust, bundle_adjust_cg, bundle_adjust_gated,
                        optimize_pose_graph)

    prob = ba_problem_from_numpy(synthetic_ba(), dev)
    pg = pose_graph_from_numpy(synthetic_pose_graph(), dev)
    solves = {
        "bundle_adjust": lambda m: bundle_adjust(prob, m, iterations=5),
        "bundle_adjust_cg": lambda m: bundle_adjust_cg(prob, m,
                                                       iterations=5),
        "bundle_adjust_gated": lambda m: bundle_adjust_gated(
            prob, m, rounds=2, iterations=3),
        "optimize_pose_graph": lambda m: optimize_pose_graph(
            pg, m, iterations=5),
        "optimize_pose_graph cg": lambda m: optimize_pose_graph(
            pg, m, iterations=5, solver="cg"),
    }
    as_t = lambda out: [o if isinstance(o, torch.Tensor) else
                        torch.from_numpy(o) for o in out]
    return [(name, as_t(solve(mesh)), as_t(solve(None)))
            for name, solve in solves.items()]


def check_close(name, got, ref) -> None:
    """A solver's outputs against the one-process run: costs (the last
    tensor but the gated BA's mask) within COST_RTOL, states within
    STATE_RTOL / STATE_ATOL, the gated BA's mask equal."""
    gated = got[-1].dtype == torch.bool
    costs = -2 if gated else -1
    if gated and not torch.equal(got[-1], ref[-1]):
        raise AssertionError(f"{name}: gate decisions differ")
    np.testing.assert_allclose(got[costs].cpu().numpy(),
                               ref[costs].cpu().numpy(), rtol=COST_RTOL,
                               err_msg=f"{name}: costs")
    for a, b in zip(got[:costs], ref[:costs]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=f"{name}: state")


def main(argv=None) -> int:
    from .distributed import global_data_mesh, initialize_multihost

    ap = argparse.ArgumentParser()
    ap.add_argument("store")
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("--feat", type=int, default=1)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = default_device(a.device)
    if a.nproc > 1:
        initialize_multihost(f"file://{a.store}", a.nproc, a.rank, dev)
    else:   # initialize_multihost is a no-op for one process
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{a.store}", rank=0,
                                world_size=1)
    assert dist.get_world_size() == a.nproc
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = global_data_mesh(a.feat, dev)
        feat_axis = "feat" if a.feat > 1 else None
        for name, got, ref in tracking_runs(mesh, feat_axis, a.features,
                                            dev):
            if not all(bits_equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"{name} over the mesh differs from "
                                     f"one process")
        tracked = f"{int((got[2] == 0).sum())} of {got[2].numel()}"
        worst = 0.0
        for name, got, ref in solver_runs(mesh, dev):
            if a.nproc == 1:
                if not all(bits_equal(g, r) for g, r in zip(got, ref)):
                    raise AssertionError(f"{name} in a world of one "
                                         f"differs from mesh=None")
            else:
                check_close(name, got, ref)
            c = -2 if got[-1].dtype == torch.bool else -1
            worst = max(worst, float(((got[c] - ref[c]).abs() /
                                      ref[c].abs()).max()))
        print(f"MULTIHOST OK rank={a.rank}/{a.nproc} mesh="
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"features={a.features} device={dev}; track_batch lanes "
              f"tracked {tracked}; solver costs within {worst:.3g} of one "
              f"process", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
