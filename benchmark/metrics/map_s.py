"""The window over the maps completed in it: every map started in the
window is completed, and the window ends with the last of them."""


def read(run):
    maps = run.counters.get("maps")
    if not maps:
        return None
    return run.window_s / maps
