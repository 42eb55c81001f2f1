"""The median host time of the native sort of the candidate list (span
`select.sort`), in the profiled segment."""

from benchmark import program_spans


def read(run):
    return program_spans.span_median_us("select.sort")
