"""Multi-process runtime helpers.

The reference is single-process/single-device (SURVEY.md section 2:
"Distributed communication backend: none exists").  The counterparts of
klt_tpu's parallel/distributed.py, on torch.distributed (one process per
device, brought up by mesh.initialize_multihost): a global mesh whose
`data` axis spans every rank, and the per-process batch-slicing
contract.
"""

from __future__ import annotations

import torch.distributed as dist

from .mesh import initialize_multihost, make_mesh  # noqa: F401


def global_data_mesh(feat: int = 1, device=None):
    """Mesh over every rank of the world: ('data', 'feat').

    The data axis carries independent sequences (no collectives on the
    tracking hot path beyond the final gather); the feat axis optionally
    splits very large feature sets.  Bundle adjustment's all-reduces ride
    the same mesh's data axis.  device: as `make_mesh`'s (the card by
    default)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % feat != 0:
        raise ValueError(f"{n} devices not divisible by feat={feat}")
    return make_mesh({"data": n // feat, "feat": feat}, device)


def process_local_batch(b_global: int) -> tuple[int, int]:
    """(local batch size, offset) for this process's shard of a global
    batch — the host-side data-loading contract for multi-process
    runs."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if b_global % n_proc != 0:
        raise ValueError(f"global batch {b_global} not divisible by "
                         f"{n_proc} processes")
    local = b_global // n_proc
    rank = dist.get_rank() if dist.is_initialized() else 0
    return local, rank * local
