"""Multi-device in the port (klt_tpu_torch/parallel/{mesh,distributed,
worker}.py, the `mesh` argument of the batch and SLAM entry points) on
the CPU with gloo: the mesh axis rules against klt_tpu's for n = 8 (its
virtual CPU devices, tests/conftest.py), every mesh entry point in a
world of one bit-equal to mesh=None, and one 2-process and one 4-process
run of the worker (a 2x2 data x feat mesh with an uneven feature count):
tracking bit-equal to one process, the solvers within klt_tpu's
tolerances."""

import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist

from klt_tpu.parallel.mesh import make_mesh as jmake_mesh
from klt_tpu_torch.parallel import default_device_count, make_mesh
from klt_tpu_torch.parallel.distributed import (global_data_mesh,
                                                process_local_batch)
from klt_tpu_torch.parallel.mesh import mesh_shape
from klt_tpu_torch.parallel.worker import (bits_equal, solver_runs,
                                           tracking_runs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120  # s a run; a hang fails the test, not the suite

AXIS_CASES = [None, {"data": -1}, {"data": 2, "feat": -1},
              {"data": 4, "feat": 2}, {"feat": 8, "data": 1},
              {"data": -1, "feat": -1}, {"data": 3, "feat": -1},
              {"data": 3}, {"data": 2, "feat": 2}]


@pytest.mark.parametrize("axis_sizes", AXIS_CASES, ids=str)
def test_mesh_rules_match_klt_tpus(axis_sizes):
    """mesh_shape(axis_sizes, 8) gives klt_tpu's make_mesh shape over its
    8 devices, or raises the same ValueError."""
    assert len(jax.devices()) == 8
    try:
        ref = dict(jmake_mesh(axis_sizes).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(axis_sizes, 8)
        assert str(got.value) == str(e)
        return
    names, sizes = mesh_shape(axis_sizes, 8)
    assert dict(zip(names, sizes)) == ref
    assert list(names) == list(ref)


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one started by make_mesh (no process group yet),
    destroyed after the module."""
    assert not dist.is_initialized()
    mesh = make_mesh(devices="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(world_of_one):
    """Every mesh entry point over world-of-one meshes and without a
    mesh, by name."""
    out = {}
    for mesh, feat in ((world_of_one, None),
                       (make_mesh({"data": 1, "feat": 1}, "cpu"), "feat")):
        for name, got, ref in tracking_runs(mesh, feat, 16, "cpu"):
            out[f"{name}, feat axis {feat}"] = (got, ref)
    for name, got, ref in solver_runs(world_of_one, "cpu"):
        out[name] = (got, ref)
    return out


def test_world_of_one(world_of_one):
    assert dict(zip(world_of_one.mesh_dim_names, world_of_one.shape)) == \
        {"data": 1}
    assert default_device_count() == 1
    assert process_local_batch(6) == (6, 0)
    mesh = global_data_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "feat") and mesh.shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh({"data": 2}, "cpu")


@pytest.mark.parametrize("name", [
    "make_batch_step, feat axis None", "make_batch_step, feat axis feat",
    "track_batch, feat axis None", "track_batch, feat axis feat",
    "bundle_adjust", "bundle_adjust_cg", "bundle_adjust_gated",
    "optimize_pose_graph", "optimize_pose_graph cg"])
def test_mesh_entry_point_in_a_world_of_one_is_bit_equal(runs, name):
    got, ref = runs[name]
    assert len(got) == len(ref) >= 3
    for g, r in zip(got, ref):
        assert bits_equal(g, r), name
    if name.startswith("track_batch"):
        assert (got[2] == 0).any() and (got[2] != 0).any()


class _Mesh:
    """The face of a DeviceMesh that parallel/mesh.py::block reads: a
    rank at coordinates `at` of a mesh of `shape`."""

    def __init__(self, names, shape, at):
        self.mesh_dim_names, self.shape, self.at = names, shape, at

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, dim):
        return self.at[dim]


def test_blocks_split_evenly_or_raise():
    from klt_tpu_torch.parallel.mesh import block
    mesh = _Mesh(("data", "feat"), (2, 4), (1, 3))
    assert block(mesh, "data", 6, "sequences") == slice(3, 6)
    assert block(mesh, "feat", 64, "features") == slice(48, 64)
    assert block(mesh, None, 7, "features") == slice(0, 7)
    with pytest.raises(ValueError, match="pad_features_for_mesh"):
        block(mesh, "feat", 64 + 17, "features")
    with pytest.raises(ValueError, match="no axis 'model'"):
        block(mesh, "model", 8, "features")


def test_mesh_step_checks_its_axes(world_of_one):
    from klt_tpu_torch.config import TrackingConfig
    from klt_tpu_torch.parallel import make_batch_step
    mesh = make_mesh({"data": 1, "feat": 1}, "cpu")
    img = torch.zeros(2, 64, 64, dtype=torch.uint8)
    x = torch.full((2, 5), 30.0)
    val = torch.zeros(2, 5, dtype=torch.int32)
    step = make_batch_step(TrackingConfig(), mesh, feat_axis="feat")
    assert step(img, img, x, x, val)[0].shape == (2, 5)
    with pytest.raises(ValueError, match="no axis 'model'"):
        make_batch_step(TrackingConfig(), mesh, feat_axis="model")(
            img, img, x, x, val)


def test_process_local_batch_without_a_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert default_device_count() == 1
    assert process_local_batch(4) == (4, 0)


def _run_workers(tmp_path, nproc: int, *extra) -> list[str]:
    """nproc ranks of parallel/worker.py on a FileStore under tmp_path;
    each child gets OMP_NUM_THREADS=1 and at most WORKER_TIMEOUT s."""
    store = tmp_path / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "klt_tpu_torch.parallel.worker", str(store),
         str(r), str(nproc), "--device", "cpu", *extra], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        assert "MULTIHOST OK" in out, out[-3000:]
    return outs


def test_two_process_gloo_run(tmp_path):
    outs = _run_workers(tmp_path, 2)
    assert "mesh={'data': 2, 'feat': 1}" in outs[0]


def test_four_process_gloo_run_2x2_uneven_features(tmp_path):
    outs = _run_workers(tmp_path, 4, "--feat", "2", "--features", "37")
    assert "mesh={'data': 2, 'feat': 2}" in outs[0]
    assert "features=37" in outs[3]
