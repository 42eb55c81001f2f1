// Kernels B and C: Lucas-Kanade tracking with a warp per feature.
//
// Four entries share one warp-cooperative Newton loop:
//   klt_lk_level            kernel B, one pyramid level of one sequence;
//   klt_lk_level_batched    kernel C, one level of B sequences;
//   klt_lk_pyramid          kernel B with the whole coarse-to-fine loop of
//                           a frame pair in one launch;
//   klt_lk_pyramid_batched  kernel C likewise, for B sequences.
//
// Kernel B replaces klt_tpu/pallas/lk2.py::_make_kernel (entry
// lk_level_inner_flat), which runs the masked Newton loop on per-feature
// patches that an extraction pass copies into VMEM and re-anchors whenever a
// feature walks off its patch.  Kernel C replaces klt_tpu/pallas/lk.py::
// _make_kernel (entry lk_level_inner), the same loop in the v1 layout
// ([F, K, 3K] patches, 512-lane feature blocks), which klt_tpu's batched
// tier runs over the B sequences' flattened features.  The pyramid entries
// also take in the level loop that klt_tpu leaves to XLA around those
// kernels (klt_tpu/ops/lk.py::track_features_pyramid_stacks).
//
// Semantics of a level (klt_tpu/ops/lk.py::_track_level_gather, the C
// reference's _trackFeature, src/V1/trackFeatures.c:381-486), in the check
// order of every iteration:
//   1. OOB, against the first image's window and the current position,
//      with the 1.001 margin;
//   2. sample the 3 channels of both windows bilinearly;
//   3. SMALL_DET when det < min_determinant;
//   4. update the position;
//   5. iters += 1;
//   6. stop on |dx| < th and |dy| < th, or after max_iterations updates.
// Then, with want_residue (the finest level only), the mean |difference|
// at the final position.  The lighting-insensitive variant keeps the
// reference's two gains, the gradient gain from plain-intensity means
// (the misnamed accumulators of src/V1/trackFeatures.c:180-220).  The level
// entries leave MAX_ITERATIONS, LARGE_RESIDUE and the final OOB to their
// caller (ops/lk.py::_final_status), as their plain versions do.
//
// Semantics of a frame pair (the pyramid entries; the reference's
// KLTTrackFeatures, src/V1/trackFeatures.c:1343-1437; the plain version is
// the torch loop ops/lk.py::track_features_pyramid_levels): lanes with
// val < 0 pass through; the position is divided by the subsampling once per
// level (IEEE /), then per level, coarsest first, multiplied back, tracked
// and classified (final OOB overrides, then LARGE_RESIDUE, then
// MAX_ITERATIONS); a level smaller than the window plus one is OOB without
// sampling; SMALL_DET or OOB ends the loop and leaves the coordinates at
// that level's scale; a result outside the border margin is OOB; lost
// features get x = y = -1 and their status as val.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A frame pair
// holds 150 to a few thousand features, each with two 8x8x3 f32 windows
// (about 1.5 KB) per level and up to 10 dependent Newton iterations of
// 3 x 49 bilinear samples and five 49-term sums: under a microsecond of
// memory traffic or arithmetic for the card, but a long dependent chain when
// one thread walks it alone, and around it the launches of a level loop
// written in torch cost more than every kernel together.
//
// What the design does about it:
// * A warp owns a feature.  Thread t of the warp holds cells t, t + 32, ...
//   of the row-major w x h window (a 7x7 window: 1 or 2 cells), so a
//   Newton iteration is 2 rounds of samples per thread and five warp
//   reductions instead of 49 rounds and five 49-term chains; 150 features
//   are 150 warps spread over the SMs, 4,800 lanes 4,800 warps.  Every
//   thread holds the same sums after a reduction (xor butterfly), so the
//   warp takes every branch together and needs no shared memory.
// * The first image's samples never change during a level: they are taken
//   once, into registers (windows of up to 256 cells; larger ones resample,
//   which gives the same values).
// * Windows are read straight from the level stacks through L1/L2
//   (neighbouring threads read neighbouring cells of a window row): no
//   patch canvas, no extraction pass, nothing to re-anchor.
// * The pyramid entries run the division chain, every level and the final
//   classification in the same launch: one launch per frame pair, for one
//   sequence or for all B (lane b * F + f reads sequence b's planes).
// * Lanes without a live feature (inactive, val < 0) leave at once.
//
// Summation order (the plain versions follow it, ops/lk.py::_window_sum, so
// kernel and plain agree bit for bit; -fmad=false keeps every multiply and
// add separately rounded): pad the row-major window with +0.0f to a
// multiple of 32 cells; thread t starts from cell t and adds cells t + 32,
// t + 64, ... in that order (padding included); then the 32 partials fold
// 32 -> 16 -> 8 -> 4 -> 2 -> 1 by adding partial i + half to partial i,
// which is what the xor butterfly with offsets 16, 8, 4, 2, 1 leaves in
// every thread, IEEE addition being commutative.
//
// Window starts are clamped to [0, cols-(w+1)] x [0, rows-(h+1)] of the
// lane's own sequence like the plain version's gather (klt_tpu's
// dynamic_slice), so the residue sampled at a final position off the image
// stays in bounds; the level entries refuse a level smaller than the window
// plus one.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define KLT_TRACKED 0
#define KLT_SMALL_DET (-2)
#define KLT_MAX_ITERATIONS (-3)
#define KLT_OOB (-4)
#define KLT_LARGE_RESIDUE (-5)
#define KLT_EPS 1.001f  // src/V1/trackFeatures.c:409
#define KLT_MAX_LEVELS 8

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kFullWarp = 0xffffffffu;

// What every lane of a launch shares.
struct LkCfg {
  int w, h;
  float min_disp, min_det, step;
  int max_iter, lighting;
};

// One lane's level stacks [3, rows, cols] in both frames.
struct Level {
  const float *s1, *s2;
  int rows, cols;
};

// Per-lane inputs and outputs of a level entry, flat over the lanes.
struct LkLanes {
  const float *x1, *y1, *x2, *y2;
  const uint8_t* active;
  float *x2o, *y2o;
  int *status, *iters;
  float* res;
};

// The levels of both frames' pyramids, finest first: base pointers, the
// stride in floats from one sequence's stack to the next, and sizes.
struct PyrLevels {
  const float* s1[KLT_MAX_LEVELS];
  const float* s2[KLT_MAX_LEVELS];
  long long stride1[KLT_MAX_LEVELS], stride2[KLT_MAX_LEVELS];
  int rows[KLT_MAX_LEVELS], cols[KLT_MAX_LEVELS];
  int nlev;
};

// The frame-pair constants, f32 as the torch loop holds them.
struct PyrCfg {
  float subsampling, max_residue;
  float border_x, border_y, limit_x, limit_y;
};

struct PyrLanes {
  const float *x, *y;
  const int* val;
  float *xo, *yo;
  int* vo;
  int n;  // lanes in the launch
  int f;  // lanes per sequence
};

// Integer-aligned window corner (C (int) truncation, clamped start) and
// the four bilinear weights, which are constant over a window.
struct Win {
  int off;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Win make_win(float x, float y, const LkCfg& p,
                                        const Level& lv) {
  const int xt = (int)x, yt = (int)y;
  const float ax = x - (float)xt, ay = y - (float)yt;
  const int x0 = min(max(xt - p.w / 2, 0), lv.cols - (p.w + 1));
  const int y0 = min(max(yt - p.h / 2, 0), lv.rows - (p.h + 1));
  Win win;
  win.off = y0 * lv.cols + x0;
  win.w00 = (1.0f - ax) * (1.0f - ay);
  win.w01 = ax * (1.0f - ay);
  win.w10 = (1.0f - ax) * ay;
  win.w11 = ax * ay;
  return win;
}

// The bilinear sample of the window cell at offset cell = j * cols + i.
__device__ __forceinline__ float sample(const float* plane, int cols,
                                        const Win& win, int cell) {
  const float* q = plane + win.off + cell;
  float v = win.w00 * q[0];
  v = v + win.w01 * q[1];
  v = v + win.w10 * q[cols];
  v = v + win.w11 * q[cols + 1];
  return v;
}

__device__ __forceinline__ bool window_oob(float x, float y, const LkCfg& p,
                                           const Level& lv) {
  const float hw = (float)(p.w / 2), hh = (float)(p.h / 2);
  return (x - hw < 0.0f) || ((float)lv.cols - (x + hw) < KLT_EPS) ||
         (y - hh < 0.0f) || ((float)lv.rows - (y + hh) < KLT_EPS);
}

// Fold of the warp's 32 partials; every thread returns the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(kFullWarp, v, off);
  return v;
}

// Chunk k of a thread holds window cell t + 32 k.  With NC > 0 the loop
// over a thread's chunks unrolls, so per-chunk values live in registers;
// NC == 0 is the loop of any length for windows above 32 * 8 cells.
#define KLT_FOR_CHUNKS(k)                                     \
  _Pragma("unroll") for (int k = 0; k < (NC > 0 ? NC : nchunks); ++k) \
    if (k < nchunks)

// Offset j * cols + i of each cell this thread owns, -1 past the window.
template <int NC>
struct CellOffsets {
  int off[NC];
  __device__ __forceinline__ void init(int t, int w, int ncell, int cols) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = t + 32 * k, j = c / w;
      off[k] = c < ncell ? j * cols + (c - j * w) : -1;
    }
  }
  __device__ __forceinline__ int operator()(int k) const { return off[k]; }
};

template <>
struct CellOffsets<0> {
  int t, w, ncell, cols;
  __device__ __forceinline__ void init(int t_, int w_, int ncell_, int cols_) {
    t = t_;
    w = w_;
    ncell = ncell_;
    cols = cols_;
  }
  __device__ __forceinline__ int operator()(int k) const {
    const int c = t + 32 * k, j = c / w;
    return c < ncell ? j * cols + (c - j * w) : -1;
  }
};

// The 3 channels of one window at this thread's cells (+0.0f past the
// window): sampled once into registers, or with NC == 0 on every read.
template <int NC>
struct Samples {
  float g_[NC], gx_[NC], gy_[NC];
  __device__ __forceinline__ void load(const float* s, size_t plane, int cols,
                                       const Win& win,
                                       const CellOffsets<NC>& off,
                                       int nchunks) {
    KLT_FOR_CHUNKS(k) {
      const int o = off(k);
      g_[k] = o < 0 ? 0.0f : sample(s, cols, win, o);
      gx_[k] = o < 0 ? 0.0f : sample(s + plane, cols, win, o);
      gy_[k] = o < 0 ? 0.0f : sample(s + 2 * plane, cols, win, o);
    }
  }
  __device__ __forceinline__ float g(int k) const { return g_[k]; }
  __device__ __forceinline__ float gx(int k) const { return gx_[k]; }
  __device__ __forceinline__ float gy(int k) const { return gy_[k]; }
};

template <>
struct Samples<0> {
  const float* s;
  size_t plane;
  int cols;
  Win win;
  const CellOffsets<0>* off;
  __device__ __forceinline__ void load(const float* s_, size_t plane_,
                                       int cols_, const Win& win_,
                                       const CellOffsets<0>& off_, int) {
    s = s_;
    plane = plane_;
    cols = cols_;
    win = win_;
    off = &off_;
  }
  __device__ __forceinline__ float at(const float* p, int k) const {
    const int o = (*off)(k);
    return o < 0 ? 0.0f : sample(p, cols, win, o);
  }
  __device__ __forceinline__ float g(int k) const { return at(s, k); }
  __device__ __forceinline__ float gx(int k) const {
    return at(s + plane, k);
  }
  __device__ __forceinline__ float gy(int k) const {
    return at(s + 2 * plane, k);
  }
};

// Sum and sum of squares of a window's intensities, over the warp.
template <int NC>
__device__ __forceinline__ void intensity_sums(const Samples<NC>& a,
                                               int nchunks, float* s,
                                               float* sq) {
  float u = 0.0f, v = 0.0f;
  KLT_FOR_CHUNKS(k) {
    const float g = a.g(k);
    u = k == 0 ? g : u + g;
    v = k == 0 ? g * g : v + g * g;
  }
  *s = warp_sum(u);
  *sq = warp_sum(v);
}

// The Newton loop of one feature at one level, run by its warp (thread t of
// 32): from the first-image position (x1, y1) and the guess (xc, yc), which
// is updated.  Every thread returns the same values.
template <int NC>
__device__ __forceinline__ void newton_level(const Level& lv, const LkCfg& p,
                                             int t, float x1, float y1,
                                             float& xc, float& yc,
                                             bool want_residue, int& status,
                                             int& iters, float& res) {
  const int ncell = p.w * p.h, nchunks = (ncell + 31) / 32;
  const size_t plane = (size_t)lv.rows * lv.cols;
  const float area = (float)ncell;
  CellOffsets<NC> off;
  off.init(t, p.w, ncell, lv.cols);

  const Win w1 = make_win(x1, y1, p, lv);
  const bool oob1 = window_oob(x1, y1, p, lv);
  Samples<NC> a;
  a.load(lv.s1, plane, lv.cols, w1, off, nchunks);
  float sum1 = 0.0f, sq1 = 0.0f;
  if (p.lighting) intensity_sums<NC>(a, nchunks, &sum1, &sq1);

  status = KLT_TRACKED;
  iters = 0;
  for (int it = 0; it < p.max_iter; ++it) {
    if (oob1 || window_oob(xc, yc, p, lv)) {
      status = KLT_OOB;
      break;
    }
    const Win w2 = make_win(xc, yc, p, lv);
    Samples<NC> b;
    b.load(lv.s2, plane, lv.cols, w2, off, nchunks);
    float alpha = 1.0f, beta = 0.0f, alpha_g = 1.0f;
    if (p.lighting) {
      float sum2, sq2;
      intensity_sums<NC>(b, nchunks, &sum2, &sq2);
      alpha = sqrtf((sq1 / area) / (sq2 / area));
      beta = sum1 / area - alpha * (sum2 / area);
      alpha_g = sqrtf((sum1 / area) / (sum2 / area));
    }
    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, ex = 0.0f, ey = 0.0f;
    KLT_FOR_CHUNKS(k) {
      float diff, gx, gy;
      if (p.lighting) {
        diff = (a.g(k) - b.g(k) * alpha) - beta;
        gx = a.gx(k) + b.gx(k) * alpha_g;
        gy = a.gy(k) + b.gy(k) * alpha_g;
      } else {
        diff = a.g(k) - b.g(k);
        gx = a.gx(k) + b.gx(k);
        gy = a.gy(k) + b.gy(k);
      }
      const bool cell = off(k) >= 0;
      const float txx = cell ? gx * gx : 0.0f, txy = cell ? gx * gy : 0.0f;
      const float tyy = cell ? gy * gy : 0.0f;
      const float tx = cell ? diff * gx : 0.0f, ty = cell ? diff * gy : 0.0f;
      gxx = k == 0 ? txx : gxx + txx;
      gxy = k == 0 ? txy : gxy + txy;
      gyy = k == 0 ? tyy : gyy + tyy;
      ex = k == 0 ? tx : ex + tx;
      ey = k == 0 ? ty : ey + ty;
    }
    gxx = warp_sum(gxx);
    gxy = warp_sum(gxy);
    gyy = warp_sum(gyy);
    ex = warp_sum(ex) * p.step;
    ey = warp_sum(ey) * p.step;
    const float det = gxx * gyy - gxy * gxy;
    if (det < p.min_det) {
      status = KLT_SMALL_DET;
      break;
    }
    const float dx = (gyy * ex - gxy * ey) / det;
    const float dy = (gxx * ey - gxy * ex) / det;
    xc = xc + dx;
    yc = yc + dy;
    ++iters;
    if (fabsf(dx) < p.min_disp && fabsf(dy) < p.min_disp) break;
  }

  res = 0.0f;
  if (want_residue) {
    const Win w2 = make_win(xc, yc, p, lv);
    Samples<NC> b;
    b.load(lv.s2, plane, lv.cols, w2, off, nchunks);
    float alpha = 1.0f, beta = 0.0f;
    if (p.lighting) {
      float sum2, sq2;
      intensity_sums<NC>(b, nchunks, &sum2, &sq2);
      alpha = sqrtf((sq1 / area) / (sq2 / area));
      beta = sum1 / area - alpha * (sum2 / area);
    }
    float r = 0.0f;
    KLT_FOR_CHUNKS(k) {
      const float diff = p.lighting ? (a.g(k) - b.g(k) * alpha) - beta
                                    : a.g(k) - b.g(k);
      const float v = off(k) >= 0 ? fabsf(diff) : 0.0f;
      r = k == 0 ? v : r + v;
    }
    res = warp_sum(r) / area;
  }
}

// A level entry's lane f, whose level stacks start at lv.s1 and lv.s2.
template <int NC>
__device__ __forceinline__ void level_lane(const Level& lv, const LkCfg& p,
                                           bool want_residue, int f, int t,
                                           const LkLanes& l) {
  float xc = l.x2[f], yc = l.y2[f];
  int status = KLT_TRACKED, iters = 0;
  float res = 0.0f;
  if (l.active[f])
    newton_level<NC>(lv, p, t, l.x1[f], l.y1[f], xc, yc, want_residue,
                     status, iters, res);
  if (t == 0) {
    l.x2o[f] = xc;
    l.y2o[f] = yc;
    l.status[f] = status;
    l.iters[f] = iters;
    l.res[f] = res;
  }
}

// A pyramid entry's lane f of sequence seq: the whole frame pair.
template <int NC>
__device__ __forceinline__ void pyramid_lane(const PyrLevels& L, size_t seq,
                                             const LkCfg& p, const PyrCfg& q,
                                             int f, int t,
                                             const PyrLanes& l) {
  const float x0 = l.x[f], y0 = l.y[f];
  const int v0 = l.val[f];
  if (v0 < 0) {  // a lost feature passes through
    if (t == 0) {
      l.xo[f] = x0;
      l.yo[f] = y0;
      l.vo[f] = v0;
    }
    return;
  }
  const float s = q.subsampling;
  float xloc = x0, yloc = y0;
  for (int r = 0; r < L.nlev; ++r) {
    xloc = xloc / s;
    yloc = yloc / s;
  }
  float xout = xloc, yout = yloc;
  int status = KLT_TRACKED;
  for (int r = L.nlev - 1; r >= 0; --r) {
    xloc = xloc * s;
    yloc = yloc * s;
    xout = xout * s;
    yout = yout * s;
    Level lv;
    lv.s1 = L.s1[r] + seq * (size_t)L.stride1[r];
    lv.s2 = L.s2[r] + seq * (size_t)L.stride2[r];
    lv.rows = L.rows[r];
    lv.cols = L.cols[r];
    if (lv.rows < p.h + 1 || lv.cols < p.w + 1) {
      // no window fits the level: the first OOB check fails everywhere
      status = KLT_OOB;
    } else {
      int iters;
      float res;
      newton_level<NC>(lv, p, t, xloc, yloc, xout, yout, r == 0, status,
                       iters, res);
      // src/V1/trackFeatures.c:459-484
      if (window_oob(xout, yout, p, lv))
        status = KLT_OOB;
      else if (status == KLT_TRACKED && res > q.max_residue)
        status = KLT_LARGE_RESIDUE;
      else if (status == KLT_TRACKED && iters >= p.max_iter)
        status = KLT_MAX_ITERATIONS;
    }
    // the reference's break: the coordinates stay at this level's scale
    if (status == KLT_SMALL_DET || status == KLT_OOB) break;
  }
  if (status != KLT_OOB &&
      (xout < q.border_x || xout > q.limit_x || yout < q.border_y ||
       yout > q.limit_y))
    status = KLT_OOB;
  if (t == 0) {
    const bool lost = status != KLT_TRACKED;
    l.xo[f] = lost ? -1.0f : xout;
    l.yo[f] = lost ? -1.0f : yout;
    l.vo[f] = status;
  }
}

// Kernel B, one level: lanes [n], stacks [3, rows, cols].
template <int NC>
__global__ void __launch_bounds__(kThreads)
    lk_level_kernel(Level lv, LkCfg p, int want_residue, int n, LkLanes l) {
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= n) return;
  level_lane<NC>(lv, p, want_residue != 0, f, threadIdx.x & 31, l);
}

// Kernel C, one level: stacks [batch, 3, rows, cols]; lane i = b * nf + f
// reads sequence b's planes.
template <int NC>
__global__ void __launch_bounds__(kThreads)
    lk_level_batched_kernel(Level lv, LkCfg p, int want_residue, int n,
                            int nf, LkLanes l) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const size_t off = (size_t)(i / nf) * 3 * lv.rows * lv.cols;
  lv.s1 += off;
  lv.s2 += off;
  level_lane<NC>(lv, p, want_residue != 0, i, threadIdx.x & 31, l);
}

// Kernel B, a frame pair: lanes [n], level stacks [3, rows_l, cols_l].
template <int NC>
__global__ void __launch_bounds__(kThreads)
    lk_pyramid_kernel(const __grid_constant__ PyrLevels L, LkCfg p, PyrCfg q,
                      PyrLanes l) {
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= l.n) return;
  pyramid_lane<NC>(L, 0, p, q, f, threadIdx.x & 31, l);
}

// Kernel C, a frame pair: lane i = b * l.f + f reads sequence b's levels.
template <int NC>
__global__ void __launch_bounds__(kThreads)
    lk_pyramid_batched_kernel(const __grid_constant__ PyrLevels L, LkCfg p,
                              PyrCfg q, PyrLanes l) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= l.n) return;
  pyramid_lane<NC>(L, (size_t)(i / l.f), p, q, i, threadIdx.x & 31, l);
}

// One warp per lane; the cells a thread holds in registers follow from the
// window's size.
#define KLT_LAUNCH(kernel, p, lanes, stream, ...)                          \
  do {                                                                     \
    const int grid_ = ((lanes) + kWarpsPerBlock - 1) / kWarpsPerBlock;     \
    const int ncell_ = (p).w * (p).h;                                      \
    if (ncell_ <= 64)                                                      \
      kernel<2><<<grid_, kThreads, 0, (cudaStream_t)(stream)>>>(           \
          __VA_ARGS__);                                                    \
    else if (ncell_ <= 256)                                                \
      kernel<8><<<grid_, kThreads, 0, (cudaStream_t)(stream)>>>(           \
          __VA_ARGS__);                                                    \
    else                                                                   \
      kernel<0><<<grid_, kThreads, 0, (cudaStream_t)(stream)>>>(           \
          __VA_ARGS__);                                                    \
  } while (0)

LkCfg make_cfg(int window_width, int window_height, float min_displacement,
               float min_determinant, float step_factor, int max_iterations,
               int lighting) {
  LkCfg p;
  p.w = window_width;
  p.h = window_height;
  p.min_disp = min_displacement;
  p.min_det = min_determinant;
  p.step = step_factor;
  p.max_iter = max_iterations;
  p.lighting = lighting;
  return p;
}

LkLanes make_lanes(const float* x1, const float* y1, const float* x2,
                   const float* y2, const uint8_t* active, float* x2_out,
                   float* y2_out, int* status, int* iters, float* residue) {
  LkLanes l;
  l.x1 = x1;
  l.y1 = y1;
  l.x2 = x2;
  l.y2 = y2;
  l.active = active;
  l.x2o = x2_out;
  l.y2o = y2_out;
  l.status = status;
  l.iters = iters;
  l.res = residue;
  return l;
}

Level make_level(const float* stack1, const float* stack2, int rows,
                 int cols) {
  Level lv;
  lv.s1 = stack1;
  lv.s2 = stack2;
  lv.rows = rows;
  lv.cols = cols;
  return lv;
}

bool window_ok(int window_width, int window_height) {
  return window_width >= 1 && window_height >= 1 &&
         (long long)window_width * window_height <= INT_MAX / 2;
}

// Fills L from the host arrays of a pyramid entry; false when a level
// cannot be a level.
bool make_levels(PyrLevels* L, const void* const* stacks1,
                 const void* const* stacks2, const long long* stride1,
                 const long long* stride2, const int* rows, const int* cols,
                 int nlev) {
  if (nlev < 1 || nlev > KLT_MAX_LEVELS) return false;
  L->nlev = nlev;
  for (int r = 0; r < KLT_MAX_LEVELS; ++r) {
    const bool in = r < nlev;
    if (in && (rows[r] < 1 || cols[r] < 1 || !stacks1[r] || !stacks2[r]))
      return false;
    L->s1[r] = in ? (const float*)stacks1[r] : nullptr;
    L->s2[r] = in ? (const float*)stacks2[r] : nullptr;
    L->stride1[r] = in && stride1 ? stride1[r] : 0;
    L->stride2[r] = in && stride2 ? stride2[r] : 0;
    L->rows[r] = in ? rows[r] : 0;
    L->cols[r] = in ? cols[r] : 0;
  }
  return true;
}

PyrCfg make_pyr_cfg(float subsampling, float max_residue, float border_x,
                    float border_y, float limit_x, float limit_y) {
  PyrCfg q;
  q.subsampling = subsampling;
  q.max_residue = max_residue;
  q.border_x = border_x;
  q.border_y = border_y;
  q.limit_x = limit_x;
  q.limit_y = limit_y;
  return q;
}

PyrLanes make_pyr_lanes(const float* x, const float* y, const int* val,
                        float* x_out, float* y_out, int* val_out, int n,
                        int f) {
  PyrLanes l;
  l.x = x;
  l.y = y;
  l.val = val;
  l.xo = x_out;
  l.yo = y_out;
  l.vo = val_out;
  l.n = n;
  l.f = f;
  return l;
}

}  // namespace

// The most pyramid levels a pyramid entry takes.
extern "C" int klt_lk_max_levels(void) { return KLT_MAX_LEVELS; }

// One level of LK for n features.  Device pointers: stacks [3, rows, cols]
// f32, positions [n] f32, active [n] u8, outputs [n].  Returns
// cudaGetLastError() after the launch.
extern "C" int klt_lk_level(const float* stack1, const float* stack2, int rows,
                            int cols, const float* x1, const float* y1,
                            const float* x2, const float* y2,
                            const uint8_t* active, int n, int window_width,
                            int window_height, float min_displacement,
                            float min_determinant, float step_factor,
                            int max_iterations, int lighting,
                            int want_residue, float* x2_out, float* y2_out,
                            int* status, int* iters, float* residue,
                            void* stream) {
  if (n < 1 || !window_ok(window_width, window_height) ||
      rows < window_height + 1 || cols < window_width + 1)
    return (int)cudaErrorInvalidValue;
  const LkCfg p = make_cfg(window_width, window_height, min_displacement,
                           min_determinant, step_factor, max_iterations,
                           lighting);
  KLT_LAUNCH(lk_level_kernel, p, n, stream,
             make_level(stack1, stack2, rows, cols), p, want_residue, n,
             make_lanes(x1, y1, x2, y2, active, x2_out, y2_out, status, iters,
                        residue));
  return (int)cudaGetLastError();
}

// One level of LK for batch sequences of n features each, in one launch.
// Device pointers: stacks [batch, 3, rows, cols] f32, positions
// [batch, n] f32, active [batch, n] u8, outputs [batch, n].  Returns
// cudaGetLastError() after the launch.
extern "C" int klt_lk_level_batched(
    const float* stack1, const float* stack2, int batch, int rows, int cols,
    const float* x1, const float* y1, const float* x2, const float* y2,
    const uint8_t* active, int n, int window_width, int window_height,
    float min_displacement, float min_determinant, float step_factor,
    int max_iterations, int lighting, int want_residue, float* x2_out,
    float* y2_out, int* status, int* iters, float* residue, void* stream) {
  if (batch < 1 || n < 1 || (long long)batch * n > INT_MAX ||
      !window_ok(window_width, window_height) || rows < window_height + 1 ||
      cols < window_width + 1)
    return (int)cudaErrorInvalidValue;
  const int lanes = batch * n;
  const LkCfg p = make_cfg(window_width, window_height, min_displacement,
                           min_determinant, step_factor, max_iterations,
                           lighting);
  KLT_LAUNCH(lk_level_batched_kernel, p, lanes, stream,
             make_level(stack1, stack2, rows, cols), p, want_residue, lanes,
             n,
             make_lanes(x1, y1, x2, y2, active, x2_out, y2_out, status, iters,
                        residue));
  return (int)cudaGetLastError();
}

// A whole frame pair of LK for n features, in one launch.  Host arrays of
// nlev entries, finest level first: stacks1/stacks2 device pointers to
// [3, rows[r], cols[r]] f32 stacks.  Device pointers: x, y f32 [n], val
// i32 [n], outputs [n].  border_* and limit_* bound the tracked position
// at level 0.  Returns cudaGetLastError() after the launch.
extern "C" int klt_lk_pyramid(
    const void* const* stacks1, const void* const* stacks2, const int* rows,
    const int* cols, int nlev, const float* x, const float* y, const int* val,
    int n, int window_width, int window_height, float min_displacement,
    float min_determinant, float step_factor, int max_iterations,
    int lighting, float subsampling, float max_residue, float border_x,
    float border_y, float limit_x, float limit_y, float* x_out, float* y_out,
    int* val_out, void* stream) {
  PyrLevels L;
  if (n < 1 || !window_ok(window_width, window_height) ||
      !make_levels(&L, stacks1, stacks2, nullptr, nullptr, rows, cols, nlev))
    return (int)cudaErrorInvalidValue;
  const LkCfg p = make_cfg(window_width, window_height, min_displacement,
                           min_determinant, step_factor, max_iterations,
                           lighting);
  KLT_LAUNCH(lk_pyramid_kernel, p, n, stream, L, p,
             make_pyr_cfg(subsampling, max_residue, border_x, border_y,
                          limit_x, limit_y),
             make_pyr_lanes(x, y, val, x_out, y_out, val_out, n, n));
  return (int)cudaGetLastError();
}

// The same for batch sequences of n features each: level r of frame k is
// [batch, 3, rows[r], cols[r]] with stride_k[r] floats from one sequence
// to the next; x, y, val and the outputs are [batch, n].
extern "C" int klt_lk_pyramid_batched(
    const void* const* stacks1, const void* const* stacks2,
    const long long* stride1, const long long* stride2, const int* rows,
    const int* cols, int nlev, int batch, const float* x, const float* y,
    const int* val, int n, int window_width, int window_height,
    float min_displacement, float min_determinant, float step_factor,
    int max_iterations, int lighting, float subsampling, float max_residue,
    float border_x, float border_y, float limit_x, float limit_y,
    float* x_out, float* y_out, int* val_out, void* stream) {
  PyrLevels L;
  if (batch < 1 || n < 1 || (long long)batch * n > INT_MAX || !stride1 ||
      !stride2 || !window_ok(window_width, window_height) ||
      !make_levels(&L, stacks1, stacks2, stride1, stride2, rows, cols, nlev))
    return (int)cudaErrorInvalidValue;
  const int lanes = batch * n;
  const LkCfg p = make_cfg(window_width, window_height, min_displacement,
                           min_determinant, step_factor, max_iterations,
                           lighting);
  KLT_LAUNCH(lk_pyramid_batched_kernel, p, lanes, stream, L, p,
             make_pyr_cfg(subsampling, max_residue, border_x, border_y,
                          limit_x, limit_y),
             make_pyr_lanes(x, y, val, x_out, y_out, val_out, lanes, n));
  return (int)cudaGetLastError();
}
