"""The median host time of one graph replay of the sequence entry (span
`graph.replay` under a `sequence` root), in the profiled segment: a few
tens of us when the launch does not wait, about a chunk's device time
when each replay waits for the one before it."""

from benchmark import program_spans


def read(run):
    return program_spans.span_median_us("graph.replay", root="sequence")
