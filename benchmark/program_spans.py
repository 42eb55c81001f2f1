"""The program's own spans and counters (klt_tpu_torch/utils/profiling.py)
as the per-layer metrics read them: the spans from the store that the
run's one profiled segment (the `--trace 1` segment) left, the counters
as they stand at the run's end.  A program that has neither (an older
commit) gives None, and the result line leaves the metric out."""

from __future__ import annotations

import numpy as np


def profiling():
    """The program's profiling module, or None when it keeps no spans."""
    from klt_tpu_torch.utils import profiling as prof
    return prof if hasattr(prof, "spans") else None


def median_us(seconds) -> float | None:
    return float(np.median(seconds)) * 1e6 if len(seconds) else None


def span_median_us(name: str, root: str | None = None) -> float | None:
    """The median duration (us) of the spans named `name` (of requests
    whose root is `root`, when given)."""
    prof = profiling()
    return None if prof is None else median_us(prof.span_seconds(name, root))


def traced(name: str) -> int | None:
    """How many spans named `name` the profiled segment recorded; None
    when it recorded none at all."""
    prof = profiling()
    if prof is None or not prof.spans():
        return None
    return sum(s.name == name for s in prof.spans())


def counter(name: str) -> float | None:
    """Counter `name` at the run's end (0 when never counted)."""
    prof = profiling()
    return None if prof is None else float(prof.counters().get(name, 0))
