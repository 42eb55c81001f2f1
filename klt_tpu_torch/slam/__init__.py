"""SLAM back end: from the tracked feature table to bundle adjustment.

The counterpart of klt_tpu/slam on one device, in plain torch (klt_tpu
computes all of it in XLA, outside any Pallas kernel):

* chains     — feature table -> observation chains, keyframe selection
               (numpy, host)
* geometry   — batched SE(3) / pinhole camera ops
* pose_graph — SE(3) pose-graph LM over relative-pose edges (dense or
               matrix-free CG normal equations)
* ba         — bundle adjustment via the Schur complement (dense, or
               matrix-free CG), with Huber IRLS and reprojection gating
* frontend   — keyframe pair solves -> pose graph -> BA initialization

Jacobians come from torch.func.jacfwd under torch.func.vmap; normal
equations are summed in a fixed order (solvers.py), so runs on the card
repeat to the bit.  With a mesh (parallel/mesh.py) the bundle adjustments
and the pose graph shard their observation (edge) sums over its "data"
axis, one all_reduce per sum, as klt_tpu psums them.
"""

from .chains import tracks_from_table, select_keyframes
from .geometry import se3_exp, se3_apply, project
from .ba import (BAProblem, bundle_adjust, bundle_adjust_cg,
                 bundle_adjust_gated)
from .pose_graph import PoseGraph, optimize_pose_graph

__all__ = [
    "tracks_from_table", "select_keyframes",
    "se3_exp", "se3_apply", "project",
    "BAProblem", "bundle_adjust", "bundle_adjust_cg",
    "bundle_adjust_gated",
    "PoseGraph", "optimize_pose_graph",
]
