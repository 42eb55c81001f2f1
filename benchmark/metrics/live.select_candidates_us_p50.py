"""The median host time of building the candidate list from the response
map (span `select.candidates`), in the profiled segment."""

from benchmark import program_spans


def read(run):
    return program_spans.span_median_us("select.candidates")
