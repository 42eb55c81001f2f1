"""Device busy time of the traced segment over its frames."""


def read(run):
    if run.trace is None:
        return None
    frames = run.counters["traced_requests"] * int(run.traffic["pool"])
    return run.trace.busy_s / frames * 1e6
