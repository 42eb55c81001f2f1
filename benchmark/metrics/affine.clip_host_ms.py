"""The median host time of one request (one call of the batched affine
entry over every stream's clip), each called with the card idle, so that
no call waits for room in the card's queue: what the host spends to
enqueue a request's graphs and copies.  While it stays under a request's
device time the card sets the rate."""

import numpy as np


def read(run):
    spans = run.spans.get("request_idle_card")
    if not spans:
        return None
    return float(np.median(spans)) * 1e3
