/* One lane of the bit-exact LK tier: the reference's _trackFeature loop
 * (src/V1/trackFeatures.c:381-486) and the coarse-to-fine walk with its
 * write-back (:1343-1501), for one feature, in plain C.
 *
 * This is the program of the scalar host oracle (native/lk_exact_ref.c,
 * built with cc -O0 -ffp-contract=off), one feature after another.  Kernel
 * G (csrc/exact.cu) spreads a lane over a warp and compiles this header's
 * per-cell helpers (klt_x_oob, klt_x_cell, klt_x_blend) and its write-back
 * (klt_x_write_back) from the same lines; its warp program keeps every
 * sum below one chain in the same order, so the two agree to the bit.
 * The operation order is klt_tpu/ops/lk_exact.py's, which cites
 * trackFeatures.c line by line:
 *
 *   - a window sample at (x + i, y + j): cx = x + (float)i, xt = (int)cx
 *     (truncation), ax = cx - (float)xt, the blend grouped
 *     ((w00*c00 + w01*c01) + w10*c10) + w11*c11 with w00 = (1-ax)*(1-ay),
 *     w01 = ax*(1-ay), w10 = (1-ax)*ay, w11 = ax*ay;
 *   - each window sum one sequential row-major chain seeded with its
 *     first term (seeding with -0.0f is the same: -0.0f + t == t for
 *     every t, signed zeros included);
 *   - ex, ey scaled by step_factor; det = gxx*gyy - gxy*gxy; SMALL_DET when
 *     det < min_determinant (or NaN); dx = (gyy*ex - gxy*ey) / det;
 *   - the out-of-bounds test in the reference's mixed int/f32 order, at
 *     entry and at the top of every further iteration, then once more
 *     after the loop (it overrides every other status);
 *   - the residue: the mean |img1 - img2| over the window, a chain divided
 *     by (float)(w*w), LARGE_RESIDUE above max_residue; then
 *     MAX_ITERATIONS for a lane that is still TRACKED with the iteration
 *     cap reached;
 *   - the level walk: the position divided by the subsampling once per
 *     level, then per level (coarsest first) every coordinate multiplied
 *     by it; SMALL_DET or OOB ends the walk (the coordinates keep being
 *     scaled); the last level's status decides, a lane outside the border
 *     band becomes OOB unless it is SMALL_DET (klt_tpu's order, see
 *     klt_tpu/ops/lk_exact.py:382; C records OOB there).
 *
 * Samples are read straight from the level planes: a lane only samples at
 * positions the bounds test passed, where every read lies in the image.
 * Square windows only (klt_tpu asserts it, lk_exact.py:224).
 */
#ifndef KLT_LK_EXACT_LANE_H
#define KLT_LK_EXACT_LANE_H

#ifdef __CUDACC__
#define KLT_LANE static __device__ __forceinline__
#else
#include <math.h>
#define KLT_LANE static
#endif

#define KLT_EXACT_MAX_LEVELS 8

#define KLT_X_TRACKED 0
#define KLT_X_SMALL_DET (-2)
#define KLT_X_MAX_ITERATIONS (-3)
#define KLT_X_OOB (-4)
#define KLT_X_LARGE_RESIDUE (-5)

typedef struct {
  /* finest-first [3, rows, cols] stacks (intensity, gradx, grady) */
  const float* st1[KLT_EXACT_MAX_LEVELS];
  const float* st2[KLT_EXACT_MAX_LEVELS];
  int rows[KLT_EXACT_MAX_LEVELS];
  int cols[KLT_EXACT_MAX_LEVELS];
  int nlev;
  int win;            /* square window side, odd */
  int max_iterations;
  int check_residue;  /* max_residue > 0 */
  /* f32 constants, as the reference rounds them */
  float subsampling, min_determinant, min_displacement, step_factor;
  float max_residue;
  /* level 0's border band: borderx, (float)(cols0 - 1 - borderx), same y */
  float border_x0, border_x1, border_y0, border_y1;
} KltExactArgs;

/* The window at (x, y) out of bounds on a rows x cols level. */
KLT_LANE int klt_x_oob(float x, float y, int hw, int rows, int cols) {
  const float fhw = (float)hw;
  return (x - fhw < 0.0f) || ((float)cols - (x + fhw) < 1.001f) ||
         (y - fhw < 0.0f) || ((float)rows - (y + fhw) < 1.001f);
}

/* The bilinear sample of one plane at the cell whose corner is (xt, yt). */
KLT_LANE float klt_x_blend(const float* p, int cols, int xt, int yt,
                           float w00, float w01, float w10, float w11) {
  const float* r0 = p + (long)yt * cols + xt;
  const float* r1 = r0 + cols;
  return ((w00 * r0[0] + w01 * r0[1]) + w10 * r1[0]) + w11 * r1[1];
}

/* The bilinear weights and corner of the window cell (i, j) at (x, y). */
KLT_LANE void klt_x_cell(float x, float y, int i, int j, int* xt, int* yt,
                         float* w00, float* w01, float* w10, float* w11) {
  const float cx = x + (float)i, cy = y + (float)j;
  const int tx = (int)cx, ty = (int)cy;
  const float ax = cx - (float)tx, ay = cy - (float)ty;
  const float bx = 1.0f - ax, by = 1.0f - ay;
  *xt = tx;
  *yt = ty;
  *w00 = bx * by;
  *w01 = ax * by;
  *w10 = bx * ay;
  *w11 = ax * ay;
}

/* One level of _trackFeature for one lane: (x1, y1) in image 1, the
 * guess (*x2, *y2) in image 2, updated in place.  Returns the status. */
KLT_LANE int klt_x_track_level(const KltExactArgs* a, int r, float x1,
                               float y1, float* x2p, float* y2p) {
  const int rows = a->rows[r], cols = a->cols[r];
  const long plane = (long)rows * cols;
  const float* i1 = a->st1[r];
  const float* i2 = a->st2[r];
  const int hw = a->win / 2;
  float x2 = *x2p, y2 = *y2p;
  int status = KLT_X_TRACKED, iters = 0;
  int run = !klt_x_oob(x1, y1, hw, rows, cols) &&
            !klt_x_oob(x2, y2, hw, rows, cols);
  if (!run) status = KLT_X_OOB;
  if (a->max_iterations <= 0) run = 0;
  while (run) {
    float gxx = -0.0f, gxy = -0.0f, gyy = -0.0f, ex = -0.0f, ey = -0.0f;
    for (int j = -hw; j <= hw; ++j) {
      for (int i = -hw; i <= hw; ++i) {
        int ax1, ay1, ax2, ay2;
        float a00, a01, a10, a11, b00, b01, b10, b11;
        klt_x_cell(x1, y1, i, j, &ax1, &ay1, &a00, &a01, &a10, &a11);
        klt_x_cell(x2, y2, i, j, &ax2, &ay2, &b00, &b01, &b10, &b11);
        const float g1 = klt_x_blend(i1, cols, ax1, ay1, a00, a01, a10, a11);
        const float gx1 =
            klt_x_blend(i1 + plane, cols, ax1, ay1, a00, a01, a10, a11);
        const float gy1 =
            klt_x_blend(i1 + 2 * plane, cols, ax1, ay1, a00, a01, a10, a11);
        const float g2 = klt_x_blend(i2, cols, ax2, ay2, b00, b01, b10, b11);
        const float gx2 =
            klt_x_blend(i2 + plane, cols, ax2, ay2, b00, b01, b10, b11);
        const float gy2 =
            klt_x_blend(i2 + 2 * plane, cols, ax2, ay2, b00, b01, b10, b11);
        const float diff = g1 - g2;
        const float gx = gx1 + gx2, gy = gy1 + gy2;
        gxx = gxx + gx * gx;
        gxy = gxy + gx * gy;
        gyy = gyy + gy * gy;
        ex = ex + diff * gx;
        ey = ey + diff * gy;
      }
    }
    ex = ex * a->step_factor;
    ey = ey * a->step_factor;
    const float det = gxx * gyy - gxy * gxy;
    if (!(det >= a->min_determinant)) {
      status = KLT_X_SMALL_DET;
      break;
    }
    const float dx = (gyy * ex - gxy * ey) / det;
    const float dy = (gxx * ey - gxy * ex) / det;
    x2 = x2 + dx;
    y2 = y2 + dy;
    iters += 1;
    run = (fabsf(dx) >= a->min_displacement ||
           fabsf(dy) >= a->min_displacement) && iters < a->max_iterations;
    if (run && klt_x_oob(x2, y2, hw, rows, cols)) {
      status = KLT_X_OOB;
      run = 0;
    }
  }
  if (klt_x_oob(x2, y2, hw, rows, cols)) status = KLT_X_OOB;
  if (status == KLT_X_TRACKED && a->check_residue) {
    float resid = -0.0f;
    for (int j = -hw; j <= hw; ++j) {
      for (int i = -hw; i <= hw; ++i) {
        int ax1, ay1, ax2, ay2;
        float a00, a01, a10, a11, b00, b01, b10, b11;
        klt_x_cell(x1, y1, i, j, &ax1, &ay1, &a00, &a01, &a10, &a11);
        klt_x_cell(x2, y2, i, j, &ax2, &ay2, &b00, &b01, &b10, &b11);
        const float g1 = klt_x_blend(i1, cols, ax1, ay1, a00, a01, a10, a11);
        const float g2 = klt_x_blend(i2, cols, ax2, ay2, b00, b01, b10, b11);
        resid = resid + fabsf(g1 - g2);
      }
    }
    if (resid / (float)(a->win * a->win) > a->max_residue)
      status = KLT_X_LARGE_RESIDUE;
  }
  if (status == KLT_X_TRACKED && iters >= a->max_iterations)
    status = KLT_X_MAX_ITERATIONS;
  *x2p = x2;
  *y2p = y2;
  return status;
}

/* The write-back of a live lane from the last level's status and
 * position: a lane outside level 0's border band becomes OOB unless it is
 * SMALL_DET; a killed lane goes to (-1, -1) with its status. */
KLT_LANE void klt_x_write_back(const KltExactArgs* a, int status, float xout,
                               float yout, float* xo, float* yo, int* vo) {
  const int border = xout < a->border_x0 || xout > a->border_x1 ||
                     yout < a->border_y0 || yout > a->border_y1;
  const int is_oob = status == KLT_X_OOB ||
                     (status != KLT_X_SMALL_DET && border);
  if (is_oob || status < 0) {
    *xo = -1.0f;
    *yo = -1.0f;
    *vo = is_oob ? KLT_X_OOB : status;
  } else {
    *xo = xout;
    *yo = yout;
    *vo = KLT_X_TRACKED;
  }
}

/* The whole coarse-to-fine track of one feature and its write-back. */
KLT_LANE void klt_x_track_lane(const KltExactArgs* a, float x, float y,
                               int val, float* xo, float* yo, int* vo) {
  if (val < 0) { /* a lost slot is left as it is */
    *xo = x;
    *yo = y;
    *vo = val;
    return;
  }
  const float ss = a->subsampling;
  float xloc = x, yloc = y;
  for (int l = 0; l < a->nlev; ++l) {
    xloc = xloc / ss;
    yloc = yloc / ss;
  }
  float xout = xloc, yout = yloc;
  int status = KLT_X_TRACKED, alive = 1;
  for (int r = a->nlev - 1; r >= 0; --r) {
    xloc = xloc * ss;
    yloc = yloc * ss;
    xout = xout * ss;
    yout = yout * ss;
    if (!alive) continue;
    status = klt_x_track_level(a, r, xloc, yloc, &xout, &yout);
    if (status == KLT_X_SMALL_DET || status == KLT_X_OOB) alive = 0;
  }
  klt_x_write_back(a, status, xout, yout, xo, yo, vo);
}

#endif /* KLT_LK_EXACT_LANE_H */
