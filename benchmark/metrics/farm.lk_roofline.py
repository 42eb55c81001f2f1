"""Kernel B's pyramid entry against its roofline: the least time of one
frame pair (rooflines/klt_lk_pyramid.py, on the checked steps of the
window, the published peaks), over its mean device time per launch in
the traced segment, in %."""

from benchmark import peaks
from benchmark.reference import klt
from benchmark.rooflines import klt_lk_pyramid as roof


def read(run):
    if run.trace is None or not run.lk_stats:
        return None
    sec, n = run.trace.kernel(roof.KERNELS)
    if n == 0 or sec <= 0:
        return None
    cfg = run.ref_cfg
    shapes = klt.pyramid_shapes(run.config["width"], run.config["height"],
                                cfg)
    levels = cfg.n_pyramid_levels
    pairs = [run.lk_stats[i:i + levels]
             for i in range(0, len(run.lk_stats), levels)]
    bounds = [peaks.bound(*roof.work(p, run.config["n_features"], shapes,
                                     cfg)) for p in pairs]
    least = sum(b for b, _ in bounds) / len(bounds)
    kinds = sorted({k for _, k in bounds})
    run.counters.setdefault("roofline_lines", []).append(
        f"roofline klt_lk_pyramid: bound by {'/'.join(kinds)}, "
        f"{least * 1e6:.4f} us a frame pair (mean of {len(bounds)} checked "
        f"steps) against {sec / n * 1e6:.4f} us a launch measured")
    return 100.0 * least / (sec / n)
