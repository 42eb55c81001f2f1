"""The median time of the blocking copy of the tracked features to the
host (span `track.readback`), which waits for the step's graph on the
card, in the profiled segment."""

from benchmark import program_spans


def read(run):
    return program_spans.span_median_us("track.readback")
