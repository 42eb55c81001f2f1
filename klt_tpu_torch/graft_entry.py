"""Entry points of the port: a frame-pair step with its example
arguments, and a dry run of the multi-device layout.

The counterparts of klt_tpu's `__graft_entry__.py`.  Both run on the card
unless the caller asks for the CPU (device="cpu"), and raise without one
(device.py::default_device).

    python -m klt_tpu_torch.graft_entry      # entry(), then a world of one
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .config import TrackingConfig
from .device import default_device


def entry(device=None):
    """(fn, example_args): the frame-pair tracking step on the flagship
    config (150 features, 320x240, 2-level pyramid) and klt_tpu's seeded
    inputs as tensors on `device` (the card by default)."""
    from .parallel.batch import make_pair_step

    dev = default_device(device)
    fn = make_pair_step(TrackingConfig())
    rng = np.random.RandomState(0)
    img1 = rng.randint(0, 256, (240, 320), dtype=np.uint8)
    img2 = rng.randint(0, 256, (240, 320), dtype=np.uint8)
    n = 150
    x = rng.uniform(30, 290, n).astype(np.float32)
    y = rng.uniform(30, 210, n).astype(np.float32)
    val = np.zeros(n, np.int32)
    return fn, tuple(torch.from_numpy(a).to(dev)
                     for a in (img1, img2, x, y, val))


def _ba_problem(rng, dev):
    """klt_tpu's dry-run BA problem: 4 poses at the identity, 16
    landmarks seen 64 times, landmarks perturbed by 0.05."""
    from .slam.ba import BAProblem

    n_pose, n_lm, m = 4, 16, 64
    lm = np.concatenate([rng.uniform(-1, 1, (n_lm, 2)),
                         rng.uniform(3, 6, (n_lm, 1))], 1).astype(np.float32)
    cam = np.tile(np.arange(n_pose, dtype=np.int32), m // n_pose)
    lmi = rng.randint(0, n_lm, m).astype(np.int32)
    p = lm[lmi]
    uv = np.stack([100.0 * p[:, 0] / p[:, 2] + 50.0,
                   100.0 * p[:, 1] / p[:, 2] + 50.0], -1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return BAProblem(
        R=t(np.broadcast_to(np.eye(3, dtype=np.float32), (n_pose, 3, 3))),
        t=t(np.zeros((n_pose, 3), np.float32)), landmarks=t(lm + 0.05),
        cam_idx=t(cam), lm_idx=t(lmi), uv=t(uv),
        weight=t(np.ones(m, np.float32)), fx=100.0, fy=100.0, cx=50.0,
        cy=50.0)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the batched tracking step over a mesh of n_devices ranks
    (sequences over 'data', features over 'feat') on tiny shapes, then an
    uneven feature count padded for the mesh, then the
    observation-sharded bundle adjustment.

    Every rank of an existing world of n_devices ranks calls it (a single
    process with no process group: n_devices = 1, a world of one is
    started).  On the card (the default) each rank needs its own card:
    with fewer cards than n_devices this raises; it never drops to a CPU
    mesh."""
    from .parallel.batch import make_batch_step, pad_features_for_mesh
    from .parallel.mesh import default_device_count, make_mesh
    from .slam.ba import bundle_adjust

    dev = default_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks on the card need "
                           f"{n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    have = default_device_count()
    if have != n_devices:
        raise RuntimeError(f"a mesh of {n_devices} ranks needs a world of "
                           f"{n_devices}, have {have}")
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count()
                           if dist.is_initialized() else 0)

    # 2-D mesh when possible: sequences over 'data', features over 'feat'
    feat = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh({"data": n_devices // feat, "feat": feat}, dev)
    step = make_batch_step(TrackingConfig(), mesh, feat_axis="feat")

    b = mesh.size(0) * 2          # 2 sequences per data shard
    n = feat * 64                 # features divisible by the feat axis
    h, w = 64, 64
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(a).to(dev)
    img1 = rng.randint(0, 256, (b, h, w), dtype=np.uint8)
    img2 = rng.randint(0, 256, (b, h, w), dtype=np.uint8)
    x = rng.uniform(25, 39, (b, n)).astype(np.float32)
    y = rng.uniform(25, 39, (b, n)).astype(np.float32)
    val = np.zeros((b, n), np.int32)
    xn, yn, vn = step(t(img1), t(img2), t(x), t(y), t(val))
    assert xn.shape == (b, n) and vn.shape == (b, n)

    # an uneven feature split: pad with dead lanes, slice back
    if feat > 1:
        n_odd = feat * 64 + 17
        x2, y2, v2, n_orig = pad_features_for_mesh(
            rng.uniform(25, 39, (b, n_odd)).astype(np.float32),
            rng.uniform(25, 39, (b, n_odd)).astype(np.float32),
            np.zeros((b, n_odd), np.int32), feat)
        xo, _, _ = step(t(img1), t(img2), t(x2), t(y2), t(v2))
        assert xo[:, :n_orig].shape == (b, n_odd)

    # observation-sharded bundle adjustment over every rank
    prob = _ba_problem(rng, dev)
    _, _, _, costs = bundle_adjust(prob, mesh=make_mesh(
        {"data": n_devices}, dev), iterations=3)
    costs = costs.cpu().numpy()
    assert costs[-1] <= costs[0], costs


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(1)
    print("dryrun_multichip ok")
