"""The share of selections that found the tracker's list buffers already
made: the program's counters `select.lists_reused` over `select.calls`,
over the whole run, in %.  None for a program that does not count
`select.lists_reused` (one that builds a fresh list a call)."""

from benchmark import program_spans


def read(run):
    prof = program_spans.profiling()
    if prof is None or "select.lists_reused" not in prof.counters():
        return None
    calls = program_spans.counter("select.calls")
    if not calls:
        return None
    return 100.0 * program_spans.counter("select.lists_reused") / calls
