"""The median time of the copy of the corner response map to the host
(span `select.readback`), which waits for kernel D, in the profiled
segment."""

from benchmark import program_spans


def read(run):
    return program_spans.span_median_us("select.readback")
