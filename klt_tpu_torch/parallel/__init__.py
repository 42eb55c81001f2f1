"""Multi-sequence tracking: the batched tier (batched_lk.py, and
batched_affine.py with the affine consistency check), klt_tpu's batch
entry points (batch.py), and meshes of ranks over torch.distributed
(mesh.py, distributed.py)."""

from .mesh import make_mesh, default_device_count
from .batch import (make_pair_step, make_batch_step, track_batch,
                    pad_features_for_mesh)
from .batched_affine import track_sequences_affine_batched
from .batched_lk import (make_fused_pair_step, track_features_pyramid_batched,
                         track_sequences_batched)

__all__ = ["make_mesh", "default_device_count", "make_pair_step",
           "make_batch_step", "track_batch", "pad_features_for_mesh",
           "make_fused_pair_step", "track_features_pyramid_batched",
           "track_sequences_batched", "track_sequences_affine_batched"]
