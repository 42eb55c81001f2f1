"""Kernel B's pyramid entry (`klt_lk_pyramid`, the `lk_pyramid_kernel`
launch): the bytes and operations one frame pair of LK needs on a given
state.  Per level, for the lanes that reach it and the Newton iterations
they run (the reference's level loop gives both): each live lane's
(w+1) x (h+1) three-channel footprint read once in each frame; per window
cell 3 first-image samples, per iteration 3 second-image samples, 3
differences and 5 products and sums, and at level 0 the residue's
sample; the lanes' x, y and val read and written once."""

from __future__ import annotations

from benchmark.reference import klt

KERNELS = ("lk_pyramid_kernel",)
SAMPLE_FLOPS = 7           # a bilinear sample: 4 products, 3 sums


def level_work(act: int, iters: int, cfg: klt.Config, residue: bool
               ) -> tuple[float, float]:
    w, h = cfg.window_width, cfg.window_height
    n_bytes = act * 2 * 3 * (w + 1) * (h + 1) * 4
    per_cell = act * 3 * SAMPLE_FLOPS + iters * (3 * SAMPLE_FLOPS + 13) + \
        (act * (SAMPLE_FLOPS + 3) if residue else 0)
    return n_bytes, w * h * per_cell


def work(stats: list, n_lanes: int, shapes: list, cfg: klt.Config
         ) -> tuple[float, float]:
    """(bytes, flops) of one frame pair: stats are the reference's
    (level, lanes in the loop, iterations) of the pair, shapes each
    level's (cols, rows)."""
    n_bytes, n_flops = 2 * 12 * n_lanes, 0
    for r, in_loop, iters in stats:
        cols, rows = shapes[r]
        if rows < cfg.window_height + 1 or cols < cfg.window_width + 1:
            continue
        by, fl = level_work(int(in_loop.sum()), int(iters.sum()), cfg,
                            r == 0)
        n_bytes, n_flops = n_bytes + by, n_flops + fl
    return n_bytes, n_flops
