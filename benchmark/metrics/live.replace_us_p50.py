"""The median host time of `KLTracker.replace_lost_features` over the
window."""

import numpy as np


def read(run):
    spans = run.spans.get("replace")
    return float(np.median(spans)) * 1e6 if spans else None
