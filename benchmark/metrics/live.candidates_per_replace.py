"""Candidates sorted per selection: the program's counters
`select.candidates` over `select.calls`, over the whole run."""

from benchmark import program_spans


def read(run):
    calls = program_spans.counter("select.calls")
    if not calls:
        return None
    return program_spans.counter("select.candidates") / calls
