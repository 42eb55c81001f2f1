// Kernel F: the affine consistency check, a warp per feature.
//
// No TPU kernel stands behind it: klt_tpu runs this loop as XLA only
// (klt_tpu/ops/affine.py::track_affine), on per-feature resident patches
// with an escape-repair pass and lane compaction, which answer the TPU's
// lack of gathers.  On an H100 the plain torch version (ops/affine.py::
// track_affine_plain) costs some sixty launches an iteration, so the loop
// is a kernel here, in the shape of kernel B (csrc/lk_level.cu).
//
// What it computes (klt_tpu/ops/affine.py, the reference's
// _am_trackFeatureAffine, src/V1/trackFeatures.c:952-1220): for every active
// feature a Gauss-Newton loop of at most max_iterations steps that aligns
// the warped window of image 2 with the feature's saved reference patch
// ([ph, pw] = window + 2, three planes: intensity, gradx, grady).  Mode 0
// moves the window only (2x2 system of the summed gradients of both images,
// error scaled by step_factor, SMALL_DET when det < min_determinant); mode 1
// fits a similarity (4x4) and mode 2 an affine map (6x6) from the warped
// gradients of image 2 (error scaled by 0.5, SMALL_DET only on a pivot that
// is exactly 0).  Each iteration: the bounds check first (mode 0: the
// window in the patch and in image 2; modes 1, 2: the patch window and the
// four warped corners, c < 0 or n - c < 1.001), the samples, the sums, the
// solve, the update, and the stop test (|dx|, |dy| < min_displacement and,
// in modes 1 and 2, every corner coordinate moved by less than
// affine_min_displacement).  After the loop: OOB when the axis-aligned
// window at the final position leaves the image or the position moved from
// its start by more than max_displacement_differ (signed, as the reference
// has it); else LARGE_RESIDUE when the mean |difference| under the final
// warp, sampled without a second bounds check, exceeds max_residue.
// Inactive lanes pass through as TRACKED.  In the step entry a feature
// tracked for the first time copies its reference patch out of image 1
// (integer-aligned, start clamped into the image): the patch save shares
// the launch.
//
// Image 2 is sampled from the full level-0 stack: the corner is the
// truncated coordinate clamped to [0, cols-2] x [0, rows-2], the fractions
// are taken from that corner, the blend is w00 p00 + w01 p01 + w10 p10 +
// w11 p11 added in that order; the patch is sampled the same way at
// coordinates clipped to [0, pw-2] x [0, ph-2].
//
// What bounds it on an H100: latency.  2000 features hold 2000 x 3 x 17 x
// 17 f32 of patches (7 MB) and sample 3 x 225 cells an iteration out of a
// frame that lies in L2; the chain of up to 10 dependent iterations, each
// ending in a 6x6 elimination, is what takes the time.
//
// What the design does about it: a warp per feature and one launch for the
// whole pass: klt_affine_track for the verification alone, klt_affine_step
// for the whole step of the tracker, which also decides which lanes save a
// patch and which are verified and updates the per-feature state in place,
// so that the step costs no launch besides.  The window's cells (at most
// 256, a 15x15 window has 225) are dealt to the warp's threads, cell
// t + 32 k to thread t; the reference
// samples are taken once, into registers; an iteration is 8 rounds of
// samples a thread and 27 warp reductions (21 sums of the upper triangle of
// T and 6 of e in mode 2; 14 in mode 1; 5 in mode 0), after which every
// thread holds the same sums, runs the same elimination and takes every
// branch with its warp.  Lanes without work leave at once.
//
// Summation order, as in kernels B and C (ops/lk.py::_window_sum on the
// plain side): the row-major window padded with +0.0f to a multiple of 32
// cells, thread t adding cells t, t + 32, ... in that order, then the xor
// butterfly 16, 8, 4, 2, 1.  The elimination is utils/linalg.py::
// gj_solve_spd's, column by column; only the entries right of the pivot
// column are computed, the others are never read again.  Built with
// -fmad=false and IEEE division, so kernel and plain version agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define KLT_TRACKED 0
#define KLT_SMALL_DET (-2)
#define KLT_OOB (-4)
#define KLT_LARGE_RESIDUE (-5)
#define KLT_EPS 1.001f  // src/V1/trackFeatures.c:409
#define KLT_AFFINE_MAX_CELLS 256

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kChunks = KLT_AFFINE_MAX_CELLS / 32;  // cells a thread holds

struct AffCfg {
  int aw, ah, ph, pw, max_iter;
  float min_disp, aff_min_disp, max_differ, max_residue, step, min_det;
};

struct AffLanes {
  const float* patches;  // [3, n, ph, pw]
  const float* stack2;   // [3, rows, cols]
  int rows, cols, n;
  const float *x1, *y1, *x2, *y2, *axx, *ayx, *axy, *ayy;
  const uint8_t* active;
  float *x2o, *y2o, *axxo, *ayxo, *axyo, *ayyo;
  int *status, *iters;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(kFullWarp, v, off);
  return v;
}

// Corner (clamped) and the four weights of a bilinear sample in a
// [rows, cols] plane.
struct Tap {
  int off;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Tap make_tap(float xs, float ys, int rows,
                                        int cols) {
  int xt = (int)fminf(fmaxf(xs, 0.0f), (float)(cols - 2));
  int yt = (int)fminf(fmaxf(ys, 0.0f), (float)(rows - 2));
  xt = min(max(xt, 0), cols - 2);
  yt = min(max(yt, 0), rows - 2);
  const float ax = xs - (float)xt, ay = ys - (float)yt;
  Tap tp;
  tp.off = yt * cols + xt;
  tp.w00 = (1.0f - ax) * (1.0f - ay);
  tp.w01 = ax * (1.0f - ay);
  tp.w10 = (1.0f - ax) * ay;
  tp.w11 = ax * ay;
  return tp;
}

__device__ __forceinline__ float blend(const float* plane, int cols,
                                       const Tap& tp) {
  const float* q = plane + tp.off;
  float v = tp.w00 * q[0];
  v = v + tp.w01 * q[1];
  v = v + tp.w10 * q[cols];
  v = v + tp.w11 * q[cols + 1];
  return v;
}

__device__ __forceinline__ bool coord_oob(float c, float n) {
  return c < 0.0f || n - c < KLT_EPS;
}

__device__ __forceinline__ bool window_oob(float x, float y, float hw,
                                           float hh, float nc, float nr) {
  return (x - hw < 0.0f) || (nc - (x + hw) < KLT_EPS) || (y - hh < 0.0f) ||
         (nr - (y + hh) < KLT_EPS);
}

// The warped corners: x and y of the upper-left, lower-left, upper-right,
// lower-right (src/V1/trackFeatures.c:1061-1068).
__device__ __forceinline__ void corners(float axx, float ayx, float axy,
                                        float ayy, float x2, float y2,
                                        float hw, float hh, float* c) {
  c[0] = axx * (-hw) + axy * hh + x2;
  c[1] = ayx * (-hw) + ayy * hh + y2;
  c[2] = axx * (-hw) + axy * (-hh) + x2;
  c[3] = ayx * (-hw) + ayy * (-hh) + y2;
  c[4] = axx * hw + axy * hh + x2;
  c[5] = ayx * hw + ayy * hh + y2;
  c[6] = axx * hw + axy * (-hh) + x2;
  c[7] = ayx * hw + ayy * (-hh) + y2;
}

// utils/linalg.py::gj_solve_spd for one right-hand side: A is [NP][NP + 1],
// the solution is left in column NP.  Returns true where a pivot was 0.
template <int NP>
__device__ __forceinline__ bool gauss_jordan(float (&A)[NP][NP + 1]) {
  bool small = false;
#pragma unroll
  for (int col = 0; col < NP; ++col) {
    const float piv = A[col][col];
    const bool zero = piv == 0.0f;
    small = small || zero;
    const float safe = zero ? 1.0f : piv;
    float arow[NP + 1];
#pragma unroll
    for (int c = col + 1; c <= NP; ++c) arow[c] = A[col][c] / safe;
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      if (r == col) continue;
      const float f = A[r][col];
#pragma unroll
      for (int c = col + 1; c <= NP; ++c) A[r][c] = A[r][c] - f * arow[c];
    }
#pragma unroll
    for (int c = col + 1; c <= NP; ++c) A[col][c] = arow[c];
  }
  return small;
}

// Parameters of a mode: translation 2, similarity 4, affine 6.
template <int MODE>
struct Params {
  static constexpr int n = MODE == 0 ? 2 : MODE == 1 ? 4 : 6;
};

// What a lane carries through the verification: position, map, status and
// the iterations it ran.
struct Lane {
  float x2, y2, axx, ayx, axy, ayy;
  int status, iters;
};

// The patch save (_am_getSubFloatImage, src/V1/trackFeatures.c:665-688): the
// [ph, pw] window of the three planes of stack1 centred on the truncated
// position, its start clamped into the image, copied by the warp into the
// lane's patch planes (pplane floats apart).
__device__ __forceinline__ void save_patch(const AffCfg& p,
                                           const float* stack1, int rows,
                                           int cols, float x_old, float y_old,
                                           float* pat, size_t pplane, int t) {
  const int px0 = min(max((int)x_old - p.pw / 2, 0), cols - p.pw);
  const int py0 = min(max((int)y_old - p.ph / 2, 0), rows - p.ph);
  const size_t plane1 = (size_t)rows * cols;
  for (int idx = t; idx < p.ph * p.pw; idx += 32) {
    const int r = idx / p.pw, c = idx - r * p.pw;
    const float* src = stack1 + (size_t)(py0 + r) * cols + px0 + c;
#pragma unroll
    for (int k = 0; k < 3; ++k) pat[k * pplane + idx] = src[k * plane1];
  }
  __syncwarp();
}

// The verification of one feature by its warp (thread t of 32): from the
// patch centre (x1, y1) and the lane's start position and map in `s`, which
// are updated.  Every thread returns the same values.
template <int MODE>
__device__ __forceinline__ void verify_lane(const AffCfg& p, const float* pat,
                                            size_t pplane,
                                            const float* stack2, int rows,
                                            int cols, float x1, float y1,
                                            Lane& s, int t) {
  constexpr int NP = Params<MODE>::n;
  const int ncell = p.aw * p.ah, nchunks = (ncell + 31) / 32;
  const float x2_in = s.x2, y2_in = s.y2;
  float x2 = x2_in, y2 = y2_in;
  float axx = s.axx, ayx = s.ayx, axy = s.axy, ayy = s.ayy;
  int status = KLT_TRACKED, iters = 0;

  const float hw = (float)(p.aw / 2), hh = (float)(p.ah / 2);
  const float ncf = (float)cols, nrf = (float)rows;
  const float pcf = (float)p.pw, prf = (float)p.ph;
  const size_t plane2 = (size_t)rows * cols;

  // this thread's cells: window offsets, and the reference samples
  float dx_[kChunks], dy_[kChunks], g1[kChunks];
  float gx1[MODE == 0 ? kChunks : 1], gy1[MODE == 0 ? kChunks : 1];
  bool cell[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = t + 32 * k, j = c / p.aw;
    cell[k] = k < nchunks && c < ncell;
    dx_[k] = (float)(c - j * p.aw) - hw;
    dy_[k] = (float)j - hh;
    g1[k] = 0.0f;
    if constexpr (MODE == 0) gx1[k] = gy1[k] = 0.0f;
    if (cell[k]) {
      const float u = fminf(fmaxf(x1 + dx_[k], 0.0f), pcf - 2.0f);
      const float v = fminf(fmaxf(y1 + dy_[k], 0.0f), prf - 2.0f);
      const int ui = (int)u, vi = (int)v;
      const float ax = u - (float)ui, ay = v - (float)vi;
      Tap tp;
      tp.off = vi * p.pw + ui;
      tp.w00 = (1.0f - ax) * (1.0f - ay);
      tp.w01 = ax * (1.0f - ay);
      tp.w10 = (1.0f - ax) * ay;
      tp.w11 = ax * ay;
      g1[k] = blend(pat, p.pw, tp);
      if constexpr (MODE == 0) {
        gx1[k] = blend(pat + pplane, p.pw, tp);
        gy1[k] = blend(pat + 2 * pplane, p.pw, tp);
      }
    }
  }
  const bool src_oob = coord_oob(x1 - hw, pcf) ||
                       (pcf - (x1 + hw) < KLT_EPS) ||
                       coord_oob(y1 - hh, prf) ||
                       (prf - (y1 + hh) < KLT_EPS);

  for (int it = 0; it < p.max_iter; ++it) {
    float old[8];
    bool oob = src_oob;
    if constexpr (MODE == 0) {
      oob = oob || window_oob(x2, y2, hw, hh, ncf, nrf);
    } else {
      corners(axx, ayx, axy, ayy, x2, y2, hw, hh, old);
#pragma unroll
      for (int k = 0; k < 8; k += 2)
        oob = oob || coord_oob(old[k], ncf) || coord_oob(old[k + 1], nrf);
    }
    if (oob) {
      status = KLT_OOB;
      break;
    }
    ++iters;

    // sums of the normal equations over this thread's cells
    constexpr int NT = MODE == 0 ? 3 : NP * (NP + 1) / 2;
    float tt[NT], ee[NP];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      float d[NP], diff = 0.0f;
#pragma unroll
      for (int q = 0; q < NP; ++q) d[q] = 0.0f;
      if (cell[k]) {
        float xs, ys;
        if constexpr (MODE == 0) {
          xs = x2 + dx_[k];
          ys = y2 + dy_[k];
        } else {
          xs = x2 + (axx * dx_[k] + axy * dy_[k]);
          ys = y2 + (ayx * dx_[k] + ayy * dy_[k]);
        }
        const Tap tp = make_tap(xs, ys, rows, cols);
        const float g2 = blend(stack2, cols, tp);
        const float gx = blend(stack2 + plane2, cols, tp);
        const float gy = blend(stack2 + 2 * plane2, cols, tp);
        diff = g1[k] - g2;
        if constexpr (MODE == 0) {
          d[0] = gx1[k] + gx;
          d[1] = gy1[k] + gy;
        } else if constexpr (MODE == 1) {
          d[0] = dx_[k] * gx + dy_[k] * gy;
          d[1] = dx_[k] * gy - dy_[k] * gx;
          d[2] = gx;
          d[3] = gy;
        } else {
          d[0] = dx_[k] * gx;
          d[1] = dx_[k] * gy;
          d[2] = dy_[k] * gx;
          d[3] = dy_[k] * gy;
          d[4] = gx;
          d[5] = gy;
        }
      }
      // a cell past the window adds +0.0f, a chunk past it nothing
      if (k < nchunks) {
        int i = 0;
#pragma unroll
        for (int a = 0; a < NP; ++a) {
#pragma unroll
          for (int b = a; b < NP; ++b) {
            const float v = cell[k] ? d[a] * d[b] : 0.0f;
            tt[i] = k == 0 ? v : tt[i] + v;
            ++i;
          }
          const float v = cell[k] ? d[a] * diff : 0.0f;
          ee[a] = k == 0 ? v : ee[a] + v;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) tt[i] = warp_sum(tt[i]);
#pragma unroll
    for (int a = 0; a < NP; ++a) ee[a] = warp_sum(ee[a]);

    float dx, dy;
    bool small;
    float axx_n = axx, ayx_n = ayx, axy_n = axy, ayy_n = ayy;
    if constexpr (MODE == 0) {
      const float gxx = tt[0], gxy = tt[1], gyy = tt[2];
      const float ex = ee[0] * p.step, ey = ee[1] * p.step;
      const float det = gxx * gyy - gxy * gxy;
      small = det < p.min_det;
      const float safe = small ? 1.0f : det;
      dx = (gyy * ex - gxy * ey) / safe;
      dy = (gxx * ey - gxy * ex) / safe;
    } else {
      float A[NP][NP + 1];
      int i = 0;
#pragma unroll
      for (int a = 0; a < NP; ++a) {
#pragma unroll
        for (int b = a; b < NP; ++b) {
          A[a][b] = tt[i];
          A[b][a] = tt[i];
          ++i;
        }
        A[a][NP] = ee[a] * 0.5f;
      }
      small = gauss_jordan<NP>(A);
      axx_n = axx + A[0][NP];
      ayx_n = ayx + A[1][NP];
      if constexpr (MODE == 1) {
        ayy_n = axx_n;
        axy_n = -ayx_n;
        dx = A[2][NP];
        dy = A[3][NP];
      } else {
        axy_n = axy + A[2][NP];
        ayy_n = ayy + A[3][NP];
        dx = A[NP - 2][NP];
        dy = A[NP - 1][NP];
      }
    }
    if (small) {
      status = KLT_SMALL_DET;
      break;
    }
    x2 = x2 + dx;
    y2 = y2 + dy;
    bool conv = fabsf(dx) < p.min_disp && fabsf(dy) < p.min_disp;
    if constexpr (MODE != 0) {
      axx = axx_n;
      ayx = ayx_n;
      axy = axy_n;
      ayy = ayy_n;
      float now[8];
      corners(axx, ayx, axy, ayy, x2, y2, hw, hh, now);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        conv = conv && fabsf(old[k] - now[k]) < p.aff_min_disp;
    }
    if (conv) break;
  }

  // src/V1/trackFeatures.c:1185-1208
  if (window_oob(x2, y2, hw, hh, ncf, nrf) ||
      (x2 - x2_in) > p.max_differ || (y2 - y2_in) > p.max_differ)
    status = KLT_OOB;
  if (status == KLT_TRACKED) {
    float r = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      float v = 0.0f;
      if (cell[k]) {
        float xs, ys;
        if constexpr (MODE == 0) {
          xs = x2 + dx_[k];
          ys = y2 + dy_[k];
        } else {
          xs = x2 + (axx * dx_[k] + axy * dy_[k]);
          ys = y2 + (ayx * dx_[k] + ayy * dy_[k]);
        }
        const Tap tp = make_tap(xs, ys, rows, cols);
        v = fabsf(g1[k] - blend(stack2, cols, tp));
      }
      if (k < nchunks) r = k == 0 ? v : r + v;
    }
    if (warp_sum(r) / (float)ncell > p.max_residue)
      status = KLT_LARGE_RESIDUE;
  }

  s.x2 = x2;
  s.y2 = y2;
  s.axx = axx;
  s.ayx = ayx;
  s.axy = axy;
  s.ayy = ayy;
  s.status = status;
  s.iters = iters;
}

// A lane of the track entry: the verification for an active lane, else a
// pass through.
template <int MODE>
__device__ __forceinline__ void track_lane(const AffCfg& p,
                                           const AffLanes& l, int f, int t) {
  const size_t patch = (size_t)p.ph * p.pw;
  const float* pat = l.patches + (size_t)f * patch;
  const size_t pplane = (size_t)l.n * patch;
  Lane s = {l.x2[f], l.y2[f], l.axx[f], l.ayx[f], l.axy[f], l.ayy[f],
            KLT_TRACKED, 0};
  if (l.active[f])
    verify_lane<MODE>(p, pat, pplane, l.stack2, l.rows, l.cols, l.x1[f],
                      l.y1[f], s, t);
  if (t == 0) {
    l.x2o[f] = s.x2;
    l.y2o[f] = s.y2;
    l.axxo[f] = s.axx;
    l.ayxo[f] = s.ayx;
    l.axyo[f] = s.axy;
    l.ayyo[f] = s.ayy;
    l.status[f] = s.status;
    l.iters[f] = s.iters;
  }
}

// The whole consistency step of a feature (klt_tpu/ops/affine.py:867-971,
// the tracking loop's part of src/V1/trackFeatures.c:1438-1497), state updated in
// place: a feature tracked for the first time saves its patch, takes the
// patch centre frac(old position) + pw / 2 and the identity map and
// becomes valid; a tracked feature with a patch is verified, keeps the
// translation tracker's position and takes the converged map if it passes,
// and is killed (position -1, the status as val, patch centre -1, no
// longer valid) if not; a feature the tracker lost is no longer valid.
struct StepLanes {
  float* patches;              // [3, n, ph, pw]
  const float *stack1, *stack2;  // [3, rows, cols]
  int rows, cols, n;
  uint8_t* valid;
  float *cx, *cy, *axx, *ayx, *axy, *ayy;  // the state, in place
  const float *x_old, *y_old, *xn, *yn;
  const int* vn;
  float *xo, *yo;
  int *vo, *iters;
};

template <int MODE>
__device__ __forceinline__ void step_lane(const AffCfg& p,
                                          const StepLanes& l, int f, int t) {
  const size_t patch = (size_t)p.ph * p.pw;
  float* pat = l.patches + (size_t)f * patch;
  const size_t pplane = (size_t)l.n * patch;
  const int vn = l.vn[f];
  const bool tracked = vn == KLT_TRACKED, valid = l.valid[f] != 0;
  const float xn = l.xn[f], yn = l.yn[f];
  float cx = l.cx[f], cy = l.cy[f];
  Lane s = {xn, yn, l.axx[f], l.ayx[f], l.axy[f], l.ayy[f], KLT_TRACKED, 0};
  // the state is updated in place by thread 0: every thread has read it
  // before any thread goes on
  __syncwarp();
  if (tracked && !valid) {
    const float x_old = l.x_old[f], y_old = l.y_old[f];
    save_patch(p, l.stack1, l.rows, l.cols, x_old, y_old, pat, pplane, t);
    cx = (x_old - (float)(int)x_old) + (float)(p.pw / 2);
    cy = (y_old - (float)(int)y_old) + (float)(p.ph / 2);
    s.axx = 1.0f;
    s.ayx = 0.0f;
    s.axy = 0.0f;
    s.ayy = 1.0f;
  }
  const bool run = tracked && valid;
  const float axx = s.axx, ayx = s.ayx, axy = s.axy, ayy = s.ayy;
  if (run)
    verify_lane<MODE>(p, pat, pplane, l.stack2, l.rows, l.cols, cx, cy, s, t);
  if (t == 0) {
    const bool killed = run && s.status != KLT_TRACKED;
    const bool keep = run && s.status == KLT_TRACKED;
    l.xo[f] = killed ? -1.0f : xn;
    l.yo[f] = killed ? -1.0f : yn;
    l.vo[f] = run ? s.status : vn;
    l.iters[f] = s.iters;
    l.axx[f] = keep ? s.axx : axx;
    l.ayx[f] = keep ? s.ayx : ayx;
    l.axy[f] = keep ? s.axy : axy;
    l.ayy[f] = keep ? s.ayy : ayy;
    l.valid[f] = tracked ? (valid ? s.status == KLT_TRACKED : 1) : 0;
    l.cx[f] = killed ? -1.0f : cx;
    l.cy[f] = killed ? -1.0f : cy;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    affine_track_kernel(AffCfg p, AffLanes l) {
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= l.n) return;
  track_lane<MODE>(p, l, f, threadIdx.x & 31);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    affine_step_kernel(AffCfg p, StepLanes l) {
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= l.n) return;
  step_lane<MODE>(p, l, f, threadIdx.x & 31);
}

AffCfg make_cfg(int window_width, int window_height, int max_iterations,
                float min_displacement, float affine_min_displacement,
                float max_displacement_differ, float max_residue,
                float step_factor, float min_determinant) {
  AffCfg p;
  p.aw = window_width;
  p.ah = window_height;
  p.ph = window_height + 2;
  p.pw = window_width + 2;
  p.max_iter = max_iterations;
  p.min_disp = min_displacement;
  p.aff_min_disp = affine_min_displacement;
  p.max_differ = max_displacement_differ;
  p.max_residue = max_residue;
  p.step = step_factor;
  p.min_det = min_determinant;
  return p;
}

bool shape_ok(int n, int mode, int window_width, int window_height, int rows,
              int cols) {
  return n >= 1 && mode >= 0 && mode <= 2 && window_width >= 1 &&
         window_height >= 1 &&
         (long long)window_width * window_height <= KLT_AFFINE_MAX_CELLS &&
         rows >= window_height + 2 && cols >= window_width + 2 &&
         (long long)rows * cols <= 0x7fffffffLL;
}

#define KLT_LAUNCH_MODE(kernel, mode, n, stream, ...)                      \
  do {                                                                     \
    const int grid_ = ((n) + kWarpsPerBlock - 1) / kWarpsPerBlock;         \
    cudaStream_t st_ = (cudaStream_t)(stream);                             \
    if ((mode) == 0)                                                       \
      kernel<0><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);                 \
    else if ((mode) == 1)                                                  \
      kernel<1><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);                 \
    else                                                                   \
      kernel<2><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);                 \
  } while (0)

}  // namespace

// The most cells of a window the kernel takes.
extern "C" int klt_affine_max_cells(void) { return KLT_AFFINE_MAX_CELLS; }

// The verify pass of n features in one launch.  Device pointers: patches
// f32 [3, n, window_height + 2, window_width + 2]; stack2 f32 [3, rows,
// cols]; the lanes' inputs and outputs [n], active u8.  Returns
// cudaGetLastError() after the launch.
extern "C" int klt_affine_track(
    const float* patches, const float* stack2, int rows, int cols,
    const float* x1, const float* y1, const float* x2, const float* y2,
    const float* axx, const float* ayx, const float* axy, const float* ayy,
    const uint8_t* active, int n, int mode,
    int window_width, int window_height, int max_iterations,
    float min_displacement, float affine_min_displacement,
    float max_displacement_differ, float max_residue, float step_factor,
    float min_determinant, float* x2_out, float* y2_out, float* axx_out,
    float* ayx_out, float* axy_out, float* ayy_out, int* status, int* iters,
    void* stream) {
  if (!shape_ok(n, mode, window_width, window_height, rows, cols))
    return (int)cudaErrorInvalidValue;
  const AffCfg p = make_cfg(window_width, window_height, max_iterations,
                            min_displacement, affine_min_displacement,
                            max_displacement_differ, max_residue,
                            step_factor, min_determinant);
  AffLanes l;
  l.patches = patches;
  l.stack2 = stack2;
  l.rows = rows;
  l.cols = cols;
  l.n = n;
  l.x1 = x1;
  l.y1 = y1;
  l.x2 = x2;
  l.y2 = y2;
  l.axx = axx;
  l.ayx = ayx;
  l.axy = axy;
  l.ayy = ayy;
  l.active = active;
  l.x2o = x2_out;
  l.y2o = y2_out;
  l.axxo = axx_out;
  l.ayxo = ayx_out;
  l.axyo = axy_out;
  l.ayyo = ayy_out;
  l.status = status;
  l.iters = iters;
  KLT_LAUNCH_MODE(affine_track_kernel, mode, n, stream, p, l);
  return (int)cudaGetLastError();
}

// The whole consistency step of n features in one launch: the patch save
// of the features tracked for the first time, the verification of those
// with a patch, and the update of the state (valid u8, patch centres and
// maps f32 [n]) in place.  x_old, y_old: the positions before the
// translation track; xn, yn, vn: its result; x_out, y_out, val_out [n]:
// the step's.  Returns cudaGetLastError() after the launch.
extern "C" int klt_affine_step(
    float* patches, const float* stack1, const float* stack2, int rows,
    int cols, uint8_t* valid, float* cx, float* cy, float* axx, float* ayx,
    float* axy, float* ayy, const float* x_old, const float* y_old,
    const float* xn, const float* yn, const int* vn, int n, int mode,
    int window_width, int window_height, int max_iterations,
    float min_displacement, float affine_min_displacement,
    float max_displacement_differ, float max_residue, float step_factor,
    float min_determinant, float* x_out, float* y_out, int* val_out,
    int* iters, void* stream) {
  if (!shape_ok(n, mode, window_width, window_height, rows, cols))
    return (int)cudaErrorInvalidValue;
  const AffCfg p = make_cfg(window_width, window_height, max_iterations,
                            min_displacement, affine_min_displacement,
                            max_displacement_differ, max_residue,
                            step_factor, min_determinant);
  StepLanes l;
  l.patches = patches;
  l.stack1 = stack1;
  l.stack2 = stack2;
  l.rows = rows;
  l.cols = cols;
  l.n = n;
  l.valid = valid;
  l.cx = cx;
  l.cy = cy;
  l.axx = axx;
  l.ayx = ayx;
  l.axy = axy;
  l.ayy = ayy;
  l.x_old = x_old;
  l.y_old = y_old;
  l.xn = xn;
  l.yn = yn;
  l.vn = vn;
  l.xo = x_out;
  l.yo = y_out;
  l.vo = val_out;
  l.iters = iters;
  KLT_LAUNCH_MODE(affine_step_kernel, mode, n, stream, p, l);
  return (int)cudaGetLastError();
}
