"""Kernel A (`klt_build_pyramid`, the `pyramid_tiles` launches): the
bytes and operations one frame's pyramid needs.  The frame is read once
and every level's three maps written once; per level a separable
smoothing at the source resolution (the pre-smoothing for level 0, the
pyramid smoothing after) and two separable gradient maps, a multiply and
an add per tap."""

from __future__ import annotations

from benchmark.reference import klt

# the profiler's names of the kernel's launches
KERNELS = ("pyramid_tiles", "hpass_global", "vpass_global")


def work(width: int, height: int, cfg: klt.Config,
         frame_bytes: int = 1) -> tuple[float, float]:
    """(bytes, flops) of one pyramid of a width x height frame."""
    taps = [len(klt.gaussian_kernels(sig)[0]) for sig in
            (cfg.smooth_sigma, cfg.grad_sigma, cfg.pyramid_sigma)]
    n_bytes, n_flops, src = width * height * frame_bytes, 0, width * height
    for lvl, (c, r) in enumerate(klt.pyramid_shapes(width, height, cfg)):
        n_bytes += 3 * r * c * 4
        n_flops += 2 * 2 * taps[0 if lvl == 0 else 2] * src
        n_flops += 2 * 2 * 2 * taps[1] * r * c
        src = r * c
    return n_bytes, n_flops
