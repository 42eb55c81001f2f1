"""Device-mesh construction over torch.distributed.

The reference has no distributed backend (SURVEY.md §2: single process,
single device).  klt_tpu scales with a named `jax.sharding.Mesh`; the
port's counterpart is PyTorch's own idiom: one process per device under
`torch.distributed`, and a named `DeviceMesh` over the world's ranks.
Sequences batch across the `data` axis, the feature axis shards across
`feat`, and the entry points that take a mesh (parallel/batch.py,
slam/ba.py, slam/pose_graph.py) slice, compute and reduce or gather
with explicit collectives.  Each rank passes the same global arrays and
gets the same global result, as a jitted JAX function with shardings
returns.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import default_device


def default_device_count() -> int:
    """The world's size: the number of ranks (one device each), 1
    without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(axis_sizes: dict[str, int] | None,
               n: int) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """(names, sizes) of a mesh of n devices, by klt_tpu's rules:
    axis_sizes maps axis name -> size, a single -1 entry absorbs the
    remaining devices, and the sizes must multiply to n.  Default: all
    devices on one 'data' axis."""
    if axis_sizes is None:
        axis_sizes = {"data": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    return tuple(names), tuple(sizes)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _start_world_of_one(device: torch.device) -> None:
    """A process group of one rank on an in-process store
    (torch.distributed.HashStore), so that a single process can build a
    mesh with no launcher, as klt_tpu's make_mesh() does on one host."""
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(_backend(device), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None):
    """A named `torch.distributed.device_mesh.DeviceMesh` over every rank
    of the world, laid out row-major as klt_tpu lays out its devices.

    axis_sizes maps axis name -> size (a single -1 absorbs the remaining
    ranks; default: all ranks on one 'data' axis; rules of `mesh_shape`).
    devices: the device the ranks compute on (a torch.device or its
    name); by default the card, and without one this raises
    (device.py::default_device).  Without a process group a world of one
    is started first (`_start_world_of_one`).  Every rank of the world
    must call this with the same arguments."""
    from torch.distributed.device_mesh import DeviceMesh

    device = default_device(devices)
    if not dist.is_initialized():
        _start_world_of_one(device)
    names, sizes = mesh_shape(axis_sizes, dist.get_world_size())
    return DeviceMesh(device.type, torch.arange(int(np.prod(sizes)))
                      .reshape(sizes), mesh_dim_names=names)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None) -> None:
    """Join an N-process run: `init_process_group` on NCCL for the card,
    gloo for the CPU (device: a torch.device or its name; the card by
    default, raising without one).  coordinator: an init_method such as
    "tcp://host:port" or "file:///path/to/store" ("host:port" as
    klt_tpu takes it means tcp).  No-op in single-process runs."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    device = default_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(_backend(device), init_method=coordinator,
                            world_size=num_processes, rank=process_id)


# ------------------------------------------------------------------ #
# what the mesh entry points share: a rank's block, gathers, reduces   #
# ------------------------------------------------------------------ #

def _dim(mesh, axis: str) -> int:
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{mesh.mesh_dim_names}")
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh, axis: str | None) -> int:
    """The mesh's size along `axis` (1 for None)."""
    return 1 if axis is None else mesh.size(_dim(mesh, axis))


def block(mesh, axis: str | None, n: int, what: str) -> slice:
    """This rank's contiguous block of n entries split evenly over
    `axis` (all of them for None); an uneven split raises."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} {what} do not split evenly over the mesh's "
                         f"{axis!r} axis of {size}; pad them first "
                         f"(parallel.batch.pad_features_for_mesh)")
    if size == 1:
        return slice(0, n)
    i = mesh.get_local_rank(_dim(mesh, axis))
    return slice(i * (n // size), (i + 1) * (n // size))


def gather(t: torch.Tensor, mesh, axis: str | None, dim: int
           ) -> torch.Tensor:
    """The blocks of every rank along `axis` concatenated along `dim`, in
    the axis' order, on every rank (t itself for None).  On an axis of
    one rank the all_gather is a copy."""
    if axis is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t, group=mesh.get_group(_dim(mesh, axis)))
    return torch.cat(parts, dim)


def all_reduce_sum(tensors, mesh, axis: str) -> list[torch.Tensor]:
    """Each tensor summed over the ranks of `axis`, on every rank: one
    all_reduce of the tensors flattened into one buffer.  On an axis of
    one rank the sum is a copy, bit for bit."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                    group=mesh.get_group(_dim(mesh, axis)))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out
