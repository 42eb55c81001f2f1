"""The median host time of one call of the sequence entry (one clip of
64 frame pairs), each called with the card idle, so that no call waits
for room in the card's queue: what the host spends to enqueue a clip's
graphs and copies.  While it stays under a clip's device time the card
sets the rate."""

import numpy as np


def read(run):
    spans = run.spans.get("clip_idle_card")
    if not spans:
        return None
    return float(np.median(spans)) * 1e3
