"""The share of selections whose candidate list was made on the card and
whose walk read no row past the head that came back: the program's
counters `select.card_lists` less `select.card_spills`, over
`select.calls`, over the whole run, in %.  None for a program that does
not count `select.card_lists` (one that makes every list on the host)."""

from benchmark import program_spans


def read(run):
    prof = program_spans.profiling()
    if prof is None or "select.card_lists" not in prof.counters():
        return None
    calls = program_spans.counter("select.calls")
    if not calls:
        return None
    made = program_spans.counter("select.card_lists")
    return 100.0 * (made - program_spans.counter("select.card_spills")) / calls
