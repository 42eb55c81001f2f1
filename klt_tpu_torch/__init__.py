"""klt_tpu_torch — the KLT feature tracker in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

The port of `klt_tpu` (JAX/XLA/Pallas on a TPU), module for module at the
same relative paths.  The pyramid (one frame or a batch), the LK level
loop (one sequence or a batch), the corner response and lost-feature
replacement run as CUDA kernels for tensors on a CUDA device
(klt_tpu_torch/csrc, built with nvcc at first use) and as plain torch for
tensors on the CPU.

Quick start::

    import klt_tpu_torch as klt

    cfg = klt.TrackingConfig(sequential_mode=True)
    tracker = klt.KLTracker(cfg, device="cuda")
    fl = klt.FeatureList.create(150)
    tracker.select_good_features(img0, fl)     # uint8 [H, W] numpy
    tracker.track_features(img0, img1, fl)
    tracker.replace_lost_features(img1, fl)

    # B sequences at once: frames uint8 [B, T, H, W], features [B, N]
    xs, ys, vals = klt.track_sequences_batched(frames, x, y, val, cfg)

    # the replace loop with the reference C tracker's table, to the bit
    xs, ys, vals = klt.track_sequence_replace_exact(frames, x, y, val, cfg)
"""

from .config import (TrackingConfig, TRACKED, NOT_FOUND, SMALL_DET,
                     MAX_ITERATIONS, OOB, LARGE_RESIDUE)
from .features import FeatureList, FeatureHistory, FeatureTable
from .runtime.tracker import KLTracker, set_verbosity
from .runtime.pipeline import track_sequence_replace_exact
from .io.pnm import read_pgm, write_pgm, read_ppm, write_ppm
from .io.features_io import (write_feature_list, write_feature_history,
                             write_feature_table, read_feature_list,
                             read_feature_history, read_feature_table)
from .utils.viz import feature_overlay, write_feature_list_ppm
from .parallel import (make_pair_step, make_batch_step, track_batch,
                       pad_features_for_mesh, make_fused_pair_step,
                       track_sequences_batched,
                       track_sequences_affine_batched)

__version__ = "0.1.0"

__all__ = [
    "TrackingConfig", "KLTracker", "FeatureList", "FeatureHistory",
    "FeatureTable", "set_verbosity",
    "TRACKED", "NOT_FOUND", "SMALL_DET", "MAX_ITERATIONS", "OOB",
    "LARGE_RESIDUE",
    "read_pgm", "write_pgm", "read_ppm", "write_ppm",
    "write_feature_list", "write_feature_history", "write_feature_table",
    "read_feature_list", "read_feature_history", "read_feature_table",
    "feature_overlay", "write_feature_list_ppm",
    "make_pair_step", "make_batch_step", "track_batch",
    "pad_features_for_mesh", "make_fused_pair_step",
    "track_sequences_batched", "track_sequences_affine_batched",
    "track_sequence_replace_exact",
]
