"""Frames tracked in the window over the window's length (host clock,
the card synchronised at its end): every frame of every request."""


def read(run):
    if not run.frames_done or run.window_s <= 0:
        return None
    return run.frames_done / run.window_s
