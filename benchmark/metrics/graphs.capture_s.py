"""Seconds of CUDA graph capture and instantiation over the whole run
(the program's counter `graph.capture_s`): the part of set-up that
captures take, and any capture in the steady state."""

from benchmark import program_spans


def read(run):
    return program_spans.counter("graph.capture_s")
