"""The median over the window's maps of the host time of bundle_adjust_gated, until the card is synchronised."""

import numpy as np


def read(run):
    spans = run.spans.get("ba")
    return float(np.median(spans)) if spans else None
