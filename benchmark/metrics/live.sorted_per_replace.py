"""Candidate rows the lazy sort made final per selection: the program's
counters `select.sorted` over `select.calls`, over the whole run.  None
for a program that does not count `select.sorted` (one that sorts the
whole list)."""

from benchmark import program_spans


def read(run):
    prof = program_spans.profiling()
    if prof is None or "select.sorted" not in prof.counters():
        return None
    calls = program_spans.counter("select.calls")
    if not calls:
        return None
    return program_spans.counter("select.sorted") / calls
