/* Native host runtime for the TPU KLT engine.
 *
 * Holds the inherently sequential scalar algorithms that surround the TPU
 * compute path: the tie-exact descending quicksort over (x, y, response)
 * candidate triples and the greedy minimum-distance suppression.  Both
 * follow the behavioural contract of the reference's selection stage
 * (src/V1/selectGoodFeatures.c:62-96 sort scheme, :102-239 suppression) so
 * that equal-response candidates are ordered and accepted identically —
 * a prerequisite for matching the reference's golden feature tables.
 *
 * Built as a shared library, bound via ctypes (see __init__.py).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define KLT_NOT_FOUND (-1)

/* ------------------------------------------------------------------ */
/* Descending sort of (x, y, v) int32 triples by v.                    */
/*                                                                     */
/* Hoare partition with the middle element swapped to the front as the */
/* pivot, recursing into the smaller side — the exact scheme the       */
/* reference uses, so ties land in the same relative order.            */
/* ------------------------------------------------------------------ */

static inline void swap_triple(int32_t *a, int64_t i, int64_t j)
{
  int32_t t0 = a[3 * i], t1 = a[3 * i + 1], t2 = a[3 * i + 2];
  a[3 * i] = a[3 * j];
  a[3 * i + 1] = a[3 * j + 1];
  a[3 * i + 2] = a[3 * j + 2];
  a[3 * j] = t0;
  a[3 * j + 1] = t1;
  a[3 * j + 2] = t2;
}

void klt_sort_points_desc(int32_t *a, int64_t n)
{
  while (n > 1) {
    int64_t i = 0, j = n, left;
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
    left = j;
    /* tail-recurse into the larger side, recurse into the smaller */
    if (left < n - (j + 1)) {
      klt_sort_points_desc(a, left);
      a += 3 * (j + 1);
      n = n - (j + 1);
    } else {
      klt_sort_points_desc(a + 3 * (j + 1), n - (j + 1));
      n = left;
    }
  }
}

/* ------------------------------------------------------------------ */
/* Greedy minimum-distance suppression.                                */
/* ------------------------------------------------------------------ */

static inline void stamp_neighborhood(uint8_t *map, int32_t x, int32_t y,
                                      int32_t rad, int32_t ncols,
                                      int32_t nrows)
{
  int32_t x0 = x - rad, x1 = x + rad, y0 = y - rad, y1 = y + rad;
  int32_t ix, iy;
  if (x0 < 0) x0 = 0;
  if (y0 < 0) y0 = 0;
  if (x1 > ncols - 1) x1 = ncols - 1;
  if (y1 > nrows - 1) y1 = nrows - 1;
  for (iy = y0; iy <= y1; iy++)
    for (ix = x0; ix <= x1; ix++)
      map[(int64_t)iy * ncols + ix] = 1;
}

/* Walks the sorted candidate list, accepting each point whose
 * neighborhood is still empty and whose response clears min_eigenvalue.
 * With overwrite_all == 0, surviving features (fval[i] >= 0) keep their
 * slots and pre-stamp the occupancy map (replacement mode).  Slots left
 * unfilled are marked NOT_FOUND with x = y = -1.
 */
void klt_min_dist_suppress(const int32_t *pts, int64_t npts,
                           float *fx, float *fy, int32_t *fval,
                           int64_t nfeat, int32_t ncols, int32_t nrows,
                           int32_t mindist, int32_t min_eigenvalue,
                           int32_t overwrite_all)
{
  uint8_t *map = (uint8_t *)calloc((size_t)ncols * nrows, 1);
  int64_t slot = 0, p;
  int32_t rad = mindist - 1; /* the scan below works with mindist-1 */

  if (min_eigenvalue < 1)
    min_eigenvalue = 1;
  if (rad < -1)
    rad = -1;

  if (!overwrite_all) {
    for (p = 0; p < nfeat; p++)
      if (fval[p] >= 0)
        stamp_neighborhood(map, (int32_t)fx[p], (int32_t)fy[p], rad,
                           ncols, nrows);
  }

  for (p = 0; p < npts; p++) {
    int32_t x = pts[3 * p], y = pts[3 * p + 1], v = pts[3 * p + 2];

    while (!overwrite_all && slot < nfeat && fval[slot] >= 0)
      slot++;
    if (slot >= nfeat)
      break;

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

  free(map);
}

/* ------------------------------------------------------------------ */
/* Threaded batch PGM loader (the pnmio role at production scale).     */
/*                                                                     */
/* Parses binary P5 headers (comment-skipping, maxval <= 255 — the     */
/* reference's format contract, src/V1/pnmio.c:46-109) and fills a     */
/* caller-provided [n, h, w] uint8 buffer, one worker thread per CPU   */
/* stripe.  Returns 0 on success, else 1-based index of the first      */
/* file that failed.                                                   */
/* ------------------------------------------------------------------ */

#include <pthread.h>
#include <stdio.h>

typedef struct {
  const char *const *paths;
  uint8_t *out;
  int64_t n, h, w;
  int64_t begin, end;
  int64_t failed;     /* 0 ok, else 1-based file index */
  int64_t inline_run; /* 1 if pthread_create failed and the stripe ran
                         inline on the calling thread (no join) */
} loader_job;

static int read_pgm_into(const char *path, uint8_t *dst, int64_t h,
                         int64_t w)
{
  FILE *f = fopen(path, "rb");
  int c, fields = 0;
  long vals[3] = {0, 0, 0};
  if (!f)
    return 1;
  if (fgetc(f) != 'P' || fgetc(f) != '5') {
    fclose(f);
    return 1;
  }
  while (fields < 3) {
    c = fgetc(f);
    if (c == '#') { /* comment to end of line */
      while (c != '\n' && c != EOF)
        c = fgetc(f);
    } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      continue;
    } else if (c >= '0' && c <= '9') {
      long v = 0;
      while (c >= '0' && c <= '9') {
        v = v * 10 + (c - '0');
        c = fgetc(f);
      }
      vals[fields++] = v;
      if (fields == 3)
        break; /* single whitespace after maxval already consumed */
    } else {
      fclose(f);
      return 1;
    }
  }
  if (vals[0] != w || vals[1] != h || vals[2] <= 0 || vals[2] > 255) {
    fclose(f);
    return 1;
  }
  if (fread(dst, 1, (size_t)(h * w), f) != (size_t)(h * w)) {
    fclose(f);
    return 1;
  }
  fclose(f);
  return 0;
}

static void *loader_worker(void *arg)
{
  loader_job *job = (loader_job *)arg;
  int64_t i;
  for (i = job->begin; i < job->end; i++) {
    if (read_pgm_into(job->paths[i], job->out + i * job->h * job->w,
                      job->h, job->w)) {
      job->failed = i + 1;
      return NULL;
    }
  }
  return NULL;
}

int64_t klt_load_pgm_batch(const char *const *paths, int64_t n,
                           uint8_t *out, int64_t h, int64_t w,
                           int64_t n_threads)
{
  pthread_t tids[16];
  loader_job jobs[16];
  int64_t t, nt = n_threads;
  if (nt < 1)
    nt = 1;
  if (nt > 16)
    nt = 16;
  if (nt > n)
    nt = n > 0 ? n : 1;
  for (t = 0; t < nt; t++) {
    jobs[t].paths = paths;
    jobs[t].out = out;
    jobs[t].n = n;
    jobs[t].h = h;
    jobs[t].w = w;
    jobs[t].begin = n * t / nt;
    jobs[t].end = n * (t + 1) / nt;
    jobs[t].failed = 0;
    /* on thread-creation failure, run the stripe inline so it is
       neither skipped nor joined as an uninitialized pthread_t */
    jobs[t].inline_run = pthread_create(&tids[t], NULL, loader_worker,
                                        &jobs[t]) != 0;
    if (jobs[t].inline_run)
      loader_worker(&jobs[t]);
  }
  for (t = 0; t < nt; t++)
    if (!jobs[t].inline_run)
      pthread_join(tids[t], NULL);
  for (t = 0; t < nt; t++)
    if (jobs[t].failed)
      return jobs[t].failed;
  return 0;
}
