"""Kernel A (all its launches) against its roofline: the least time of
the traced segment's pyramids (rooflines/klt_build_pyramid.py, the
published peaks; a clip builds pool + 1 pyramids) over its device time,
in %."""

from benchmark import peaks
from benchmark.rooflines import klt_build_pyramid as roof


def read(run):
    if run.trace is None:
        return None
    sec, n = run.trace.kernel(roof.KERNELS)
    if n == 0 or sec <= 0:
        return None
    pyramids = run.counters["traced_requests"] * (int(run.traffic["pool"])
                                                   + 1)
    least, kind = peaks.bound(*roof.work(run.config["width"],
                                         run.config["height"], run.ref_cfg))
    run.counters.setdefault("roofline_lines", []).append(
        f"roofline klt_build_pyramid: bound by {kind}, {least * 1e6:.4f} us "
        f"a pyramid against {sec / pyramids * 1e6:.4f} us measured "
        f"({n} launches for {pyramids} pyramids)")
    return 100.0 * least * pyramids / sec
