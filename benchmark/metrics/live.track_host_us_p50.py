"""The median host time of one `KLTracker.track_features` call less its
blocking read of the tracked features: the span `tracker.track` less its
child `track.readback` (the staging, the graph launch and the unpacking),
in the profiled segment."""

from benchmark import program_spans


def read(run):
    prof = program_spans.profiling()
    if prof is None:
        return None
    return program_spans.median_us(
        prof.self_seconds("tracker.track", children=("track.readback",)))
