"""Lanes that kernel F's step entry was launched over per consistency
step: the program's counters `affine.lanes` over `affine.steps`, over the
whole run (credited at every graph replay).  Every lane of every stream
today, whether its feature lives or not.  None for a program that does
not count `affine.steps`."""

from benchmark import program_spans


def read(run):
    prof = program_spans.profiling()
    if prof is None or "affine.steps" not in prof.counters():
        return None
    steps = program_spans.counter("affine.steps")
    if not steps:
        return None
    return program_spans.counter("affine.lanes") / steps
