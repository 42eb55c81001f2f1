"""Kernel F's step entry (`klt_affine_step`, the `affine_step_kernel`
launch): the bytes and operations one consistency step needs on a given
state, from the reference's counts of the step (lanes that saved a patch,
lanes verified, the Gauss-Newton iterations they ran).

Bytes: each saved patch's three [ph, pw] planes read from image 1 and
written once; each verified lane's (w+1) x (h+1) cells of its patch that
its bilinear samples touch, in the planes the mode reads (mode 0 all
three, modes 1 and 2 the intensity alone), and its (w+1) x (h+1)
three-plane footprint in image 2 once (the window moves by under a pixel
from one iteration to the next), all footprints together at most the
frames' three planes; every lane's positions and status in and out, and
the state (patch centre and map) of the lanes that saved or verified, in
and out.  Operations: per window cell the patch sample once, per
iteration three samples of image 2, the design columns and the products
and sums of the normal equations, and once the residue's sample; per
iteration the elimination."""

from __future__ import annotations

KERNELS = ("affine_step_kernel",)
SAMPLE_FLOPS = 7           # a bilinear sample: 4 products, 3 sums
LANE_BYTES = 4 * 4 + 4 + 1 + 3 * 4   # x_old, y_old, xn, yn, vn, valid; out
STATE_BYTES = 2 * 6 * 4              # centre and map, in and out


def work(saved: int, verified: int, iters: int, lanes: int, acfg,
         frame_px: int) -> tuple[float, float]:
    """(bytes, flops) of one step over `lanes` lanes in frames of frame_px
    pixels in all; acfg: the check's settings (reference.affine's
    AffineConfig)."""
    aw, ah = acfg.affine_window_width, acfg.affine_window_height
    mode = acfg.affine_consistency_check
    n_par = (2, 4, 6)[mode]
    planes = 3 if mode == 0 else 1
    cells = (aw + 1) * (ah + 1)
    n_bytes = (saved * 2 * 3 * (aw + 2) * (ah + 2) * 4 +
               verified * planes * cells * 4 +
               min(verified * 3 * cells * 4, 3 * frame_px * 4) +
               lanes * LANE_BYTES + (saved + verified) * STATE_BYTES)
    per_iter = 3 * SAMPLE_FLOPS + 1 + 2 * n_par + \
        2 * (n_par * (n_par + 1) // 2 + n_par)
    per_cell = verified * planes * SAMPLE_FLOPS + iters * per_iter + \
        verified * (SAMPLE_FLOPS + 2)
    return n_bytes, aw * ah * per_cell + iters * 2 * n_par ** 3
