"""The median host time of the greedy minimum-distance suppression over
the sorted candidates (span `select.suppress`), in the profiled
segment."""

from benchmark import program_spans


def read(run):
    return program_spans.span_median_us("select.suppress")
