"""The 95th percentile, over every frame of the window, of the host time
of a frame: the call into the tracker until its results are in host
memory."""

import numpy as np


def read(run):
    spans = run.spans.get("frame")
    if not spans:
        return None
    return float(np.percentile(np.asarray(spans), 95)) * 1e3
