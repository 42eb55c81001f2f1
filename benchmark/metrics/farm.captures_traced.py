"""CUDA graphs captured inside the profiled segment (spans
`graph.capture`): 0 when the steady state captures nothing."""

from benchmark import program_spans


def read(run):
    return program_spans.traced("graph.capture")
