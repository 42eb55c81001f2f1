"""klt_tpu_torch — the KLT feature tracker in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

The port of `klt_tpu` (JAX/XLA/Pallas on a TPU), module for module at the
same relative paths.  The pyramid and the LK level loop run as CUDA
kernels for tensors on a CUDA device (klt_tpu_torch/csrc, built with nvcc
at first use) and as plain torch for tensors on the CPU.

Quick start::

    import klt_tpu_torch as klt

    cfg = klt.TrackingConfig(sequential_mode=True)
    tracker = klt.KLTracker(cfg, device="cuda")
    fl = klt.FeatureList.create(150)
    tracker.select_good_features(img0, fl)     # uint8 [H, W] numpy
    tracker.track_features(img0, img1, fl)
"""

from .config import (TrackingConfig, TRACKED, NOT_FOUND, SMALL_DET,
                     MAX_ITERATIONS, OOB, LARGE_RESIDUE)
from .features import FeatureList, FeatureHistory, FeatureTable
from .runtime.tracker import KLTracker, set_verbosity
from .io.pnm import read_pgm, write_pgm, read_ppm, write_ppm
from .io.features_io import (write_feature_list, write_feature_history,
                             write_feature_table, read_feature_list,
                             read_feature_history, read_feature_table)

__version__ = "0.1.0"

__all__ = [
    "TrackingConfig", "KLTracker", "FeatureList", "FeatureHistory",
    "FeatureTable", "set_verbosity",
    "TRACKED", "NOT_FOUND", "SMALL_DET", "MAX_ITERATIONS", "OOB",
    "LARGE_RESIDUE",
    "read_pgm", "write_pgm", "read_ppm", "write_ppm",
    "write_feature_list", "write_feature_history", "write_feature_table",
    "read_feature_list", "read_feature_history", "read_feature_table",
]
