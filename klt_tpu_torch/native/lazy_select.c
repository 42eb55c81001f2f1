/* Lazy descending sort of (x, y, v) candidate triples, driven by the
 * greedy minimum-distance walk that reads it.
 *
 * The walk (klt_min_dist_suppress in kltnative.c) stops once the free
 * slots are filled, and then has read only the head of the sorted list:
 * a replacement of about 10 slots of 500 in a 640x480 frame reads some
 * thousands of its 255,744 rows.  So only the ranges that meet that head
 * are partitioned here.
 *
 * The partition step is klt_sort_points_desc's: the middle element
 * swapped to the front as the pivot, then Hoare's loop, with the same
 * swaps.  Once a range is partitioned its two sides are sorted on their
 * own, so the final contents of positions [0, K) depend only on the
 * partitions of the ranges that meet [0, K), whatever order the sides are
 * finished in.  Partitioning exactly those ranges gives the full sort's
 * first K rows bit for bit, ties in the same order, and the walk over
 * them accepts what klt_min_dist_suppress accepts over the full sort.
 *
 * The caller owns the state, int64 state[3 + 2 * cap]:
 *   state[0]  cap, the most ranges that may be pending (>= 1, set by the
 *             caller);
 *   state[1]  the number of pending ranges;
 *   state[2]  the rows final: every row before the leftmost pending range
 *             (a range of one row and every pivot are final at once);
 *   state[3 + 2k], state[4 + 2k]  pending range k as [lo, hi), the
 *             leftmost range last.
 * Pending ranges are disjoint and hold at least two rows each.  Where a
 * partition would leave more than cap pending (partitions nested deeper
 * than cap), the range is sorted whole by klt_sort_points_desc instead:
 * the same partitions, all at once.  So the state never overflows and its
 * size does not grow with n; a few dozen ranges are pending in practice.
 *
 * The list the sort starts from is written by klt_candidate_list, into a
 * buffer the caller owns and reuses.  Where the response lies on the card,
 * kernel S (csrc/select_sort.cu) writes the list there and makes the
 * partitions of the ranges that the walk's head meets, in this state's
 * layout; only the head of the list comes back, and klt_lazy_walk_begin /
 * klt_lazy_walk take the sort up from that state, asking for the rest of
 * the list only if the walk reads past the head.
 *
 * Built as a shared library of its own, bound via ctypes (__init__.py).
 * It includes kltnative.c for the reference's swap_triple,
 * stamp_neighborhood and KLT_NOT_FOUND; kltnative.c stays a copy of the
 * JAX package's source.
 */

#include "kltnative.c"

/* C's (int) cast of a response value: truncation toward zero where the
 * cast is defined; elsewhere (NaN, beyond int32) INT32_MIN, what x86's
 * cvttss2si and so numpy's astype(int32) give. */
static inline int32_t truncate_value(float v)
{
  if (v >= -2147483648.0f && v < 2147483648.0f)
    return (int32_t)v;
  return INT32_MIN;
}

/* The candidate list of _KLTSelectGoodFeatures
 * (src/V1/selectGoodFeatures.c:394-424): for y from bordery below
 * nrows - bordery and x from borderx below ncols - borderx, both by step,
 * row-major, the row (x, y, (int)resp[y][x]) into out, int32 [n, 3].
 * resp is float32 with rows of `stride` floats.  Every row of out is
 * written; returns n. */
int64_t klt_candidate_list(const float *resp, int64_t stride, int32_t ncols,
                           int32_t nrows, int32_t borderx, int32_t bordery,
                           int32_t step, int32_t *out)
{
  int32_t *row = out;
  int32_t x, y;
  for (y = bordery; y < nrows - bordery; y += step) {
    const float *line = resp + (int64_t)y * stride;
    for (x = borderx; x < ncols - borderx; x += step) {
      row[0] = x;
      row[1] = y;
      row[2] = truncate_value(line[x]);
      row += 3;
    }
  }
  return (row - out) / 3;
}

/* One step of klt_sort_points_desc on a range of n >= 2 rows: returns
 * the pivot's final position j; rows [0, j) hold values >= the pivot's,
 * rows (j, n) values <= it. */
static int64_t partition_desc(int32_t *a, int64_t n)
{
  int64_t i = 0, j = n;
  swap_triple(a, 0, n / 2); /* median-guess pivot to the front */
  for (;;) {
    do {
      j--;
    } while (a[3 * j + 2] < a[2]);
    do {
      i++;
    } while (i < j && a[3 * i + 2] > a[2]);
    if (i >= j)
      break;
    swap_triple(a, i, j);
  }
  swap_triple(a, j, 0);
  return j;
}

/* partition_desc for callers outside this file: the loop that the card's
 * partitions (csrc/select_sort.cu) are held against. */
int64_t klt_partition_desc(int32_t *a, int64_t n)
{
  return n < 2 ? 0 : partition_desc(a, n);
}

/* Partitions the leftmost pending range until row p (< n) is final. */
static void finalize_through(int32_t *a, int64_t n, int64_t *state,
                             int64_t p)
{
  int64_t *ranges = state + 3;
  while (state[2] <= p) {
    int64_t k = state[1] - 1;
    int64_t lo = ranges[2 * k], hi = ranges[2 * k + 1];
    if (k + 2 > state[0]) {
      klt_sort_points_desc(a + 3 * lo, hi - lo);
    } else {
      int64_t j = lo + partition_desc(a + 3 * lo, hi - lo);
      /* the right side below the left, so the leftmost stays last */
      if (hi - (j + 1) >= 2) {
        ranges[2 * k] = j + 1;
        ranges[2 * k + 1] = hi;
        k++;
      }
      if (j - lo >= 2) {
        ranges[2 * k] = lo;
        ranges[2 * k + 1] = j;
        k++;
      }
    }
    state[1] = k;
    state[2] = k ? ranges[2 * (k - 1)] : n;
  }
}

/* Starts the lazy sort of the n triples at a: partitions the leftmost
 * ranges until row 0 holds the best candidate. */
void klt_lazy_sort_begin(int32_t *a, int64_t n, int64_t *state)
{
  state[1] = 0;
  state[2] = n;
  if (n < 2)
    return;
  state[1] = 1;
  state[2] = 0;
  state[3] = 0;
  state[4] = n;
  finalize_through(a, n, state, 0);
}

/* the walk works with mindist-1 */
static inline int32_t stamp_radius(int32_t mindist)
{
  return mindist - 1 < -1 ? -1 : mindist - 1;
}

/* klt_min_dist_suppress over the triples whose sort klt_lazy_sort_begin
 * started (or kernel S, csrc/select_sort.cu, on the card), each row made
 * final just before the walk reads it, in steps, for a list of which only
 * the head may have arrived.  klt_lazy_walk_begin zeroes the caller's
 * ncols x nrows map, stamps the live features (fval >= 0) into it unless
 * every slot is overwritten, and starts at[] (int64 [2]: the row and the
 * slot the walk stands at). */
void klt_lazy_walk_begin(uint8_t *map, int64_t *at, const float *fx,
                         const float *fy, const int32_t *fval, int64_t nfeat,
                         int32_t ncols, int32_t nrows, int32_t mindist,
                         int32_t overwrite_all)
{
  int32_t rad = stamp_radius(mindist);
  int64_t p;

  memset(map, 0, (size_t)ncols * nrows);
  at[0] = 0;
  at[1] = 0;
  if (overwrite_all)
    return;
  for (p = 0; p < nfeat; p++)
    if (fval[p] >= 0)
      stamp_neighborhood(map, (int32_t)fx[p], (int32_t)fy[p], rad, ncols,
                         nrows);
}

/* The walk from row at[0] and slot at[1], reading only rows [0, avail) of
 * the npts in the list (no pending range may straddle row avail).
 * Returns 1, with at[] where the walk stands, when it needs row avail;
 * called again with more rows it goes on where it stopped.  Else returns
 * 0, after the slots still writable became NOT_FOUND; state[2] is then
 * the number of rows the sort made final. */
int32_t klt_lazy_walk(int32_t *pts, int64_t npts, int64_t avail,
                      int64_t *state, uint8_t *map, int64_t *at, float *fx,
                      float *fy, int32_t *fval, int64_t nfeat, int32_t ncols,
                      int32_t nrows, int32_t mindist, int32_t min_eigenvalue,
                      int32_t overwrite_all)
{
  int32_t rad = stamp_radius(mindist);
  int64_t slot = at[1], p;

  if (min_eigenvalue < 1)
    min_eigenvalue = 1;
  for (p = at[0]; p < npts; p++) {
    int32_t x, y, v;

    while (!overwrite_all && slot < nfeat && fval[slot] >= 0)
      slot++;
    if (slot >= nfeat)
      break;

    if (p >= avail) {
      at[0] = p;
      at[1] = slot;
      return 1;
    }
    if (p >= state[2])
      finalize_through(pts, npts, state, p);
    x = pts[3 * p];
    y = pts[3 * p + 1];
    v = pts[3 * p + 2];
    if (!map[(int64_t)y * ncols + x] && v >= min_eigenvalue) {
      fx[slot] = (float)x;
      fy[slot] = (float)y;
      fval[slot] = v;
      slot++;
      stamp_neighborhood(map, x, y, rad, ncols, nrows);
    }
  }

  /* Candidates exhausted: remaining writable slots become NOT_FOUND. */
  for (; slot < nfeat; slot++) {
    if (overwrite_all || fval[slot] < 0) {
      fx[slot] = -1.0f;
      fy[slot] = -1.0f;
      fval[slot] = KLT_NOT_FOUND;
    }
  }
  at[0] = p;
  at[1] = slot;
  return 0;
}
