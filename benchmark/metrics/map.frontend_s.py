"""The median over the window's maps of the host time of the front end: track_sequence_replace(precomp=True) over the clip, the table to the host, the chains, the keyframes and the hand-off to the back end."""

import numpy as np


def read(run):
    spans = run.spans.get("frontend")
    return float(np.median(spans)) if spans else None
