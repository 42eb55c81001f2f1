"""The median host time of the affine state's reset at the start of a
sequence call (span `affine.reset` in runtime/pipeline.py::_load), in
the profiled segment.  None for a program without the span."""

from benchmark import program_spans


def read(run):
    return program_spans.span_median_us("affine.reset")
