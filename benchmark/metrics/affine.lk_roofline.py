"""Kernel C's pyramid entry against its roofline: the least time of one
frame pair of every stream (rooflines/klt_lk_pyramid_batched.py, from the
reference's lanes and iterations on the followed stream's steps, each
stream counted as that one; the published peaks), over its mean device
time per launch in the traced segment, in %."""

from benchmark import peaks
from benchmark.reference import klt
from benchmark.rooflines import klt_lk_pyramid_batched as roof


def read(run):
    if run.trace is None or not run.lk_stats:
        return None
    sec, n = run.trace.kernel(roof.KERNELS)
    if n == 0 or sec <= 0:
        return None
    cfg = run.ref_cfg
    streams = int(run.traffic["streams"])
    shapes = klt.pyramid_shapes(run.config["width"], run.config["height"],
                                cfg)
    levels = cfg.n_pyramid_levels
    pairs = [run.lk_stats[i:i + levels]
             for i in range(0, len(run.lk_stats), levels)]
    bounds = [peaks.bound(*roof.work(p, run.config["n_features"], shapes,
                                     cfg, streams)) for p in pairs]
    least = sum(b for b, _ in bounds) / len(bounds)
    kinds = sorted({k for _, k in bounds})
    run.counters.setdefault("roofline_lines", []).append(
        f"roofline klt_lk_pyramid_batched: bound by {'/'.join(kinds)}, "
        f"{least * 1e6:.4f} us a step (mean of {len(bounds)} followed "
        f"steps, x {streams} streams) against {sec / n * 1e6:.4f} us a "
        f"launch measured")
    return 100.0 * least / (sec / n)
