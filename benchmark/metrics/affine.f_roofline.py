"""Kernel F's step entry against its roofline: the least time of one
consistency step over every stream (rooflines/klt_affine_step.py, from
the reference's counts of the followed stream's steps, each stream
counted as that one; the published peaks), over its mean device time per
launch in the traced segment, in %."""

from benchmark import peaks
from benchmark.reference import affine
from benchmark.rooflines import klt_affine_step as roof


def read(run):
    stats = run.counters.get("affine_stats")
    if run.trace is None or not stats:
        return None
    sec, n = run.trace.kernel(roof.KERNELS)
    if n == 0 or sec <= 0:
        return None
    streams = int(run.traffic["streams"])
    acfg = affine.AffineConfig(**run.config["affine"])
    lanes = streams * int(run.config["n_features"])
    frame_px = streams * run.config["width"] * run.config["height"]
    bounds = [peaks.bound(*roof.work(streams * saved, streams * verified,
                                     streams * iters, lanes, acfg,
                                     frame_px))
              for saved, verified, iters, _ in stats]
    least = sum(b for b, _ in bounds) / len(bounds)
    kinds = sorted({k for _, k in bounds})
    run.counters.setdefault("roofline_lines", []).append(
        f"roofline klt_affine_step: bound by {'/'.join(kinds)}, "
        f"{least * 1e6:.4f} us a step (mean of {len(bounds)} followed "
        f"steps, x {streams} streams) against {sec / n * 1e6:.4f} us a "
        f"launch measured")
    return 100.0 * least / (sec / n)
