"""Graph replays per call of the sequence entry: spans `graph.replay`
under a `sequence` root over the `sequence` roots, in the profiled
segment."""

from benchmark import program_spans


def read(run):
    prof = program_spans.profiling()
    if prof is None:
        return None
    calls = len(prof.span_seconds("sequence"))
    if not calls:
        return None
    return len(prof.span_seconds("graph.replay", root="sequence")) / calls
