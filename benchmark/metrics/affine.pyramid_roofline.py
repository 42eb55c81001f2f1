"""Kernel E (all its launches) against its roofline: the least time of
the traced segment's pyramids (rooflines/klt_build_pyramid_batched.py,
the published peaks; a request builds pool + 1 pyramids of every stream)
over its device time, in %."""

from benchmark import peaks
from benchmark.rooflines import klt_build_pyramid_batched as roof


def read(run):
    if run.trace is None:
        return None
    sec, n = run.trace.kernel(roof.KERNELS)
    if n == 0 or sec <= 0:
        return None
    pyramids = run.counters["traced_requests"] * \
        (int(run.traffic["pool"]) + 1) * int(run.traffic["streams"])
    least, kind = peaks.bound(*roof.work(run.config["width"],
                                         run.config["height"], run.ref_cfg,
                                         pyramids))
    run.counters.setdefault("roofline_lines", []).append(
        f"roofline klt_build_pyramid_batched: bound by {kind}, "
        f"{least / pyramids * 1e6:.4f} us a pyramid against "
        f"{sec / pyramids * 1e6:.4f} us measured ({n} launches for "
        f"{pyramids} pyramids)")
    return 100.0 * least / sec
