"""The median over the window's maps of the host time of keyframe_pose_graph_init: the pair solves and the pose graph."""

import numpy as np


def read(run):
    spans = run.spans.get("pose_graph")
    return float(np.median(spans)) if spans else None
