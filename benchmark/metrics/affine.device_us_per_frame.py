"""Device busy time of the traced segment over its frames (every stream's
pool frame pairs a request)."""


def read(run):
    if run.trace is None:
        return None
    frames = run.counters["traced_requests"] * int(run.traffic["pool"]) * \
        int(run.traffic["streams"])
    return run.trace.busy_s / frames * 1e6
