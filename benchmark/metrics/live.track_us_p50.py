"""The median host time of `KLTracker.track_features` over the window."""

import numpy as np


def read(run):
    spans = run.spans.get("track")
    return float(np.median(spans)) * 1e6 if spans else None
