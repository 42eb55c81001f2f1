"""Kernel launches of the port's kernels (its own counts, credited per
graph replay) over the window, per frame."""


def read(run):
    n = run.counters.get("launches")
    if n is None or not run.frames_done:
        return None
    return n / run.frames_done
