/* Scalar host oracle of the bit-exact LK tier: the lane program of
 * csrc/lk_exact_lane.h (whose per-cell helpers and write-back kernel G
 * shares) run one feature after another on the CPU.
 *
 * Built with cc -O0 -ffp-contract=off (no contraction of a * b + c into an
 * FMA, every f32 operation rounded on its own, as the reference C tracker
 * is built for its goldens), and called through ctypes by the tests, which
 * hold the plain torch version (ops/lk_exact.py) against it lane by lane.
 */
#include "../csrc/lk_exact_lane.h"

/* stacks1, stacks2: nlev pointers to finest-first [3, rows, cols] f32
 * stacks; x, y, val: n lanes in; xo, yo, vo: n lanes out.  Returns 0, or
 * -1 when nlev is out of range. */
int klt_exact_track_ref(const float* const* stacks1,
                        const float* const* stacks2, const int* rows,
                        const int* cols, int nlev, const float* x,
                        const float* y, const int* val, int n, int win,
                        int max_iterations, int check_residue,
                        float subsampling, float min_determinant,
                        float min_displacement, float step_factor,
                        float max_residue, float border_x0, float border_x1,
                        float border_y0, float border_y1, float* xo,
                        float* yo, int* vo) {
  KltExactArgs a;
  int l, f;
  if (nlev < 1 || nlev > KLT_EXACT_MAX_LEVELS) return -1;
  for (l = 0; l < nlev; ++l) {
    a.st1[l] = stacks1[l];
    a.st2[l] = stacks2[l];
    a.rows[l] = rows[l];
    a.cols[l] = cols[l];
  }
  a.nlev = nlev;
  a.win = win;
  a.max_iterations = max_iterations;
  a.check_residue = check_residue;
  a.subsampling = subsampling;
  a.min_determinant = min_determinant;
  a.min_displacement = min_displacement;
  a.step_factor = step_factor;
  a.max_residue = max_residue;
  a.border_x0 = border_x0;
  a.border_x1 = border_x1;
  a.border_y0 = border_y0;
  a.border_y1 = border_y1;
  for (f = 0; f < n; ++f)
    klt_x_track_lane(&a, x[f], y[f], val[f], xo + f, yo + f, vo + f);
  return 0;
}
