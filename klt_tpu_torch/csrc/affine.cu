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
// the launch.  Both entries take the level-0 stacks of nseq sequences
// ([nseq, 3, rows, cols]) with the lanes flattened sequence-major: lane f
// reads sequence f / (n / nseq) (the batched affine check).
//
// Image 2 is sampled from the full level-0 stack: the corner is the
// truncated coordinate clamped to [0, cols-2] x [0, rows-2], the fractions
// are taken from that corner, the blend is w00 p00 + w01 p01 + w10 p10 +
// w11 p11 added in that order; the patch is sampled the same way at
// coordinates clipped to [0, pw-2] x [0, ph-2].
//
// What bounds it on an H100: one lane's dependent chain, and at many lanes
// the warps' latencies.  2000 features hold 2000 x 3 x 17 x 17 f32 of
// patches (7 MB) and sample 3 x 225 cells an iteration out of a frame that
// lies in L2: microseconds of bytes for the card.  But a lane runs up to
// 10 dependent iterations, each ending in a 6x6 elimination, and the launch
// ends with the lanes that run all 10 (37 of 954 at the laptops cell).
// With 8 sequences (7,700 live lanes) the card holds a few waves of warps,
// and the sum of the lanes' iterations sets the time.
//
// What the design does about it: a warp per feature and one launch for the
// whole pass: klt_affine_track for the verification alone, klt_affine_step
// for the whole step of the tracker, which also decides which lanes save a
// patch and which are verified and updates the per-feature state in place,
// so that the step costs no launch besides.  The window's cells (at most
// 256, a 15x15 window has 225) are dealt to the warp's threads, cell
// t + 32 k to thread t; the reference samples are taken once, into
// registers.  Then per iteration:
// * image 2 is sampled in global memory (the frame lies in L2 and a lane's
//   footprint in L1), a tap's 12 loads before its blends; for a window of
//   8 chunks (225 to 256 cells, the main path) the chunks run without a
//   branch (a loop over the chunk count read at run time was about 20%
//   slower at both affine cells on an H100, PERF.md section 6): a cell
//   past the window samples the window's centre and adds +0.0f, as the
//   padded window sums do.  (A box of image 2 staged per warp in shared
//   memory was slower: its staging moves more bytes than the window
//   reads.);
// * the 5 / 14 / 27 window sums (modes 0 / 1 / 2) are reduced by recursive
//   halving over the offsets 16, 8, 4, 2, 1 (31 shuffles in mode 2, where
//   27 xor butterflies took 135): every sum is built of the pairs the
//   butterfly builds, in its order, and thread j ends with sum j;
// * the system is solved with a column of [T | e] a thread: for each pivot
//   column the pivot column is broadcast by __shfl_sync and each thread
//   divides its own entry of the pivot row, so an iteration's chain holds
//   6 IEEE divisions instead of 21, and no thread holds the matrix;
// * the window offsets of a cell come from a block-wide table in shared
//   memory instead of registers.
// The step entry's registers are bounded at 128 a thread (16 warps an
// SM) and a block holds 4 warps; PERF.md section 6 has the times of other
// register bounds and block sizes at both affine cells.

// Summation order, as in kernels B and C (ops/lk.py::_window_sum on the
// plain side): the row-major window padded with +0.0f to a multiple of 32
// cells, thread t adding cells t, t + 32, ... in that order, then pairs
// formed over the offsets 16, 8, 4, 2, 1, own partial first.  The
// elimination is utils/linalg.py::gj_solve_spd's, column by column; only
// the entries right of the pivot column are computed, the others are never
// read again.  Built with -fmad=false and IEEE division, so kernel and
// plain version agree bit for bit.

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
constexpr int kMinBlocks = 4;  // 16 warps an SM: at most 128 registers
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kChunks = KLT_AFFINE_MAX_CELLS / 32;  // cells a thread holds

struct AffCfg {
  int aw, ah, ph, pw, max_iter;
  float min_disp, aff_min_disp, max_differ, max_residue, step, min_det;
};

// The block's table of window offsets (dx, dy) of every cell, (0, 0) past
// the window.
__device__ __forceinline__ void fill_offsets(float2* offs, const AffCfg& p) {
  const int ncell = p.aw * p.ah;
  const float hw = (float)(p.aw / 2), hh = (float)(p.ah / 2);
  for (int c = threadIdx.x; c < KLT_AFFINE_MAX_CELLS; c += kThreads) {
    float2 o = make_float2(0.0f, 0.0f);
    if (c < ncell) {
      const int j = c / p.aw;
      o.x = (float)(c - j * p.aw) - hw;
      o.y = (float)j - hh;
    }
    offs[c] = o;
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(kFullWarp, v, off);
  return v;
}

// Parameters and window sums of a mode: translation 2 and 5 (gxx, gxy,
// gyy, ex, ey), similarity 4 and 14, affine 6 and 27 (the upper triangle of
// T row by row, then e); m, the sums padded to a power of two; sum j ends
// on thread j << shift.
template <int MODE>
struct Mode {
  static constexpr int np = MODE == 0 ? 2 : MODE == 1 ? 4 : 6;
  static constexpr int nt = MODE == 0 ? 3 : np * (np + 1) / 2;
  static constexpr int ns = nt + np;
  static constexpr int m = ns <= 8 ? 8 : ns <= 16 ? 16 : 32;
  static constexpr int shift = m == 8 ? 2 : m == 16 ? 1 : 0;  // 5 - log2 m
};

// One step of the recursive halving at lane offset `off`: a thread keeps
// the upper HALF of its slots where its lane bit is set, the lower where
// not, and adds its partner's partials of those slots to its own.
template <int M, int HALF>
__device__ __forceinline__ void halve(float (&w)[M], int t, int off) {
  const bool hi = (t & off) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = hi ? w[j] : w[j + HALF];
    const float keep = hi ? w[j + HALF] : w[j];
    w[j] = keep + __shfl_xor_sync(kFullWarp, send, off);
  }
}

// The window sums of the warp from each thread's partials v[0 .. NS-1], by
// recursive halving over the offsets 16, 8, 4, 2, 1 (M = 8, 16 or 32 slots;
// once one slot is left, the xor butterfly goes on).  Every index is known
// at compile time, so the slots stay in registers.  Thread t returns sum
// t >> (5 - log2 M).
template <int NS, int M>
__device__ __forceinline__ float reduce_scatter(const float (&v)[NS], int t) {
  float w[M];
#pragma unroll
  for (int j = 0; j < M; ++j) w[j] = j < NS ? v[j] : 0.0f;
  halve<M, M / 2>(w, t, 16);
  halve<M, M / 4>(w, t, 8);
  halve<M, M / 8>(w, t, 4);
  if constexpr (M >= 16)
    halve<M, M / 16>(w, t, 2);
  else
    w[0] = w[0] + __shfl_xor_sync(kFullWarp, w[0], 2);
  if constexpr (M >= 32)
    halve<M, M / 32>(w, t, 1);
  else
    w[0] = w[0] + __shfl_xor_sync(kFullWarp, w[0], 1);
  return w[0];
}

// Corner (clamped) and the four weights of a bilinear sample in a
// [rows, cols] plane.
struct Tap {
  int off;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Tap make_tap(float xs, float ys, int rows,
                                        int cols) {
  const int xt =
      min((int)fminf(fmaxf(xs, 0.0f), (float)(cols - 2)), cols - 2);
  const int yt =
      min((int)fminf(fmaxf(ys, 0.0f), (float)(rows - 2)), rows - 2);
  const float ax = xs - (float)xt, ay = ys - (float)yt;
  Tap tp;
  tp.off = yt * cols + xt;
  tp.w00 = (1.0f - ax) * (1.0f - ay);
  tp.w01 = ax * (1.0f - ay);
  tp.w10 = (1.0f - ax) * ay;
  tp.w11 = ax * ay;
  return tp;
}

__device__ __forceinline__ float blend(const Tap& tp, float q00, float q01,
                                       float q10, float q11) {
  float v = tp.w00 * q00;
  v = v + tp.w01 * q01;
  v = v + tp.w10 * q10;
  v = v + tp.w11 * q11;
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

// What a lane carries through the verification: position, map, status and
// the iterations it ran.
struct Lane {
  float x2, y2, axx, ayx, axy, ayy;
  int status, iters;
};

// Image 2 of a lane: its three level-0 planes.
struct Image2 {
  const float *p0, *p1, *p2;
  int rows, cols;
};

// The coordinates in image 2 of the cell at window offset (dx, dy).
template <int MODE>
__device__ __forceinline__ void warp_at(float dx, float dy, float x2,
                                        float y2, float axx, float ayx,
                                        float axy, float ayy, float& xs,
                                        float& ys) {
  if constexpr (MODE == 0) {
    xs = x2 + dx;
    ys = y2 + dy;
  } else {
    xs = x2 + (axx * dx + axy * dy);
    ys = y2 + (ayx * dx + ayy * dy);
  }
}

// The three samples (intensity, gradx, grady) of image 2 at (xs, ys), all
// 12 loads before the blends.
__device__ __forceinline__ void sample3(const Image2& im, float xs, float ys,
                                        float& g, float& gx, float& gy) {
  const int cols = im.cols;
  const Tap tp = make_tap(xs, ys, im.rows, cols);
  const float *q0 = im.p0 + tp.off, *q1 = im.p1 + tp.off,
              *q2 = im.p2 + tp.off;
  const float a0 = q0[0], a1 = q0[1], a2 = q0[cols], a3 = q0[cols + 1];
  const float b0 = q1[0], b1 = q1[1], b2 = q1[cols], b3 = q1[cols + 1];
  const float c0 = q2[0], c1 = q2[1], c2 = q2[cols], c3 = q2[cols + 1];
  g = blend(tp, a0, a1, a2, a3);
  gx = blend(tp, b0, b1, b2, b3);
  gy = blend(tp, c0, c1, c2, c3);
}

// The intensity sample alone (the residue).
__device__ __forceinline__ float sample1(const Image2& im, float xs,
                                         float ys) {
  const Tap tp = make_tap(xs, ys, im.rows, im.cols);
  const float* q = im.p0 + tp.off;
  return blend(tp, q[0], q[1], q[im.cols], q[im.cols + 1]);
}

// Whether this thread has chunk k: NCH > 0, exactly NCH chunks (known at
// compile time); 0, nchunks.
template <int NCH>
__device__ __forceinline__ bool has_chunk(int k, int nchunks) {
  return NCH > 0 ? k < NCH : k < nchunks;
}

// This thread's partials of the window sums under the current warp: cells
// t + 32 k of its chunks.  A cell past the window (only the last chunk
// has one) samples the window's centre and adds +0.0f.
template <int MODE, int NCH>
__device__ __forceinline__ void window_sums(
    const Image2& im, const float2* offs, int ncell, int nchunks,
    const float* g1, const float* gx1, const float* gy1, float x2, float y2,
    float axx, float ayx, float axy, float ayy, int t,
    float (&acc)[Mode<MODE>::ns]) {
  constexpr int NP = Mode<MODE>::np, NT = Mode<MODE>::nt;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (!has_chunk<NCH>(k, nchunks)) break;
    const int c = t + 32 * k;
    const float2 o = offs[c];
    float xs, ys;
    warp_at<MODE>(o.x, o.y, x2, y2, axx, ayx, axy, ayy, xs, ys);
    float g2, gx, gy;
    sample3(im, xs, ys, g2, gx, gy);
    float diff = g1[k] - g2;
    float d[NP];
    if constexpr (MODE == 0) {
      d[0] = gx1[k] + gx;
      d[1] = gy1[k] + gy;
    } else if constexpr (MODE == 1) {
      d[0] = o.x * gx + o.y * gy;
      d[1] = o.x * gy - o.y * gx;
      d[2] = gx;
      d[3] = gy;
    } else {
      d[0] = o.x * gx;
      d[1] = o.x * gy;
      d[2] = o.y * gx;
      d[3] = o.y * gy;
      d[4] = gx;
      d[5] = gy;
    }
    if (!has_chunk<NCH>(k + 1, nchunks) && c >= ncell) {
      diff = 0.0f;
#pragma unroll
      for (int q = 0; q < NP; ++q) d[q] = 0.0f;
    }
    int i = 0;
#pragma unroll
    for (int a = 0; a < NP; ++a) {
#pragma unroll
      for (int b = a; b < NP; ++b) {
        const float v = d[a] * d[b];
        acc[i] = k == 0 ? v : acc[i] + v;
        ++i;
      }
    }
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      const float v = d[a] * diff;
      acc[NT + a] = k == 0 ? v : acc[NT + a] + v;
    }
  }
}

// Index of the sum of T[a][b], a <= b, in the upper triangle row by row.
template <int NP>
__device__ __forceinline__ int tri(int a, int b) {
  return a * NP - a * (a - 1) / 2 + (b - a);
}

// utils/linalg.py::gj_solve_spd of the warp's system, a column a thread:
// thread c <= NP gathers column c of [T | 0.5 e] from the threads that
// hold its sums (T is symmetric, so column c is row c of T; column NP is
// 0.5 e).  For each pivot column the pivot and the pivot column's entries
// are broadcast, and thread c divides its own entry of the pivot row by
// the pivot (1 where it is 0) and subtracts its multiples from the other
// rows: one division a thread a column, where a thread holding the matrix
// would divide NP - col entries one after the other.  Every thread gets
// the solution; returns whether a pivot was 0.
template <int MODE>
__device__ __forceinline__ bool solve(float red, int t,
                                      float (&sol)[Mode<MODE>::np]) {
  constexpr int NP = Mode<MODE>::np, NT = Mode<MODE>::nt;
  constexpr int SH = Mode<MODE>::shift;
  const int c = min(t, NP);
  float col_[NP];  // this thread's column: A[r][c], r < NP
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    const int src = c < NP ? tri<NP>(min(r, c), max(r, c)) : NT + r;
    const float v = __shfl_sync(kFullWarp, red, src << SH);
    col_[r] = c < NP ? v : v * 0.5f;
  }
  bool small = false;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    // the pivot column's entries (the pivot among them) from thread k
    float f[NP];
#pragma unroll
    for (int r = 0; r < NP; ++r)
      f[r] = __shfl_sync(kFullWarp, col_[r], k);
    const bool zero = f[k] == 0.0f;
    small = small || zero;
    const float safe = zero ? 1.0f : f[k];
    const float a = col_[k] / safe;  // A[k][c] / pivot
#pragma unroll
    for (int r = 0; r < NP; ++r)
      col_[r] = r == k ? a : col_[r] - f[r] * a;
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) sol[q] = __shfl_sync(kFullWarp, col_[q], NP);
  return small;
}

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
// are updated.  stack2: the lane's sequence's [3, rows, cols]; offs: the
// block's table of window offsets.  Every thread returns the same values.
template <int MODE, int NCH>
__device__ __forceinline__ void verify_lane(const AffCfg& p, const float* pat,
                                            size_t pplane,
                                            const float* stack2, int rows,
                                            int cols, const float2* offs,
                                            float x1, float y1, Lane& s,
                                            int t) {
  constexpr int NP = Mode<MODE>::np, NS = Mode<MODE>::ns;
  constexpr int M = Mode<MODE>::m, SH = Mode<MODE>::shift;
  const int ncell = p.aw * p.ah, nchunks = (ncell + 31) / 32;
  const float x2_in = s.x2, y2_in = s.y2;
  float x2 = x2_in, y2 = y2_in;
  float axx = s.axx, ayx = s.ayx, axy = s.axy, ayy = s.ayy;
  int status = KLT_TRACKED, iters = 0;

  const float hw = (float)(p.aw / 2), hh = (float)(p.ah / 2);
  const float ncf = (float)cols, nrf = (float)rows;
  const float pcf = (float)p.pw, prf = (float)p.ph;
  const size_t plane2 = (size_t)rows * cols;

  const Image2 im = {stack2, stack2 + plane2, stack2 + 2 * plane2, rows,
                     cols};

  // this thread's reference samples; a cell past the window holds 0
  float g1[kChunks];
  float gx1[MODE == 0 ? kChunks : 1], gy1[MODE == 0 ? kChunks : 1];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (!has_chunk<NCH>(k, nchunks)) break;
    const int c = t + 32 * k;
    const float2 o = offs[c];
    const float u = fminf(fmaxf(x1 + o.x, 0.0f), pcf - 2.0f);
    const float v = fminf(fmaxf(y1 + o.y, 0.0f), prf - 2.0f);
    const int ui = (int)u, vi = (int)v;
    const float ax = u - (float)ui, ay = v - (float)vi;
    Tap tp;
    tp.off = vi * p.pw + ui;
    tp.w00 = (1.0f - ax) * (1.0f - ay);
    tp.w01 = ax * (1.0f - ay);
    tp.w10 = (1.0f - ax) * ay;
    tp.w11 = ax * ay;
    const float* q = pat + tp.off;
    const bool cell = c < ncell;
    const float v0 = blend(tp, q[0], q[1], q[p.pw], q[p.pw + 1]);
    g1[k] = cell ? v0 : 0.0f;
    if constexpr (MODE == 0) {
      const float* qx = q + pplane;
      const float* qy = q + 2 * pplane;
      const float vx = blend(tp, qx[0], qx[1], qx[p.pw], qx[p.pw + 1]);
      const float vy = blend(tp, qy[0], qy[1], qy[p.pw], qy[p.pw + 1]);
      gx1[k] = cell ? vx : 0.0f;
      gy1[k] = cell ? vy : 0.0f;
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

    float acc[NS];
    window_sums<MODE, NCH>(im, offs, ncell, nchunks, g1, gx1, gy1, x2, y2,
                           axx, ayx, axy, ayy, t, acc);
    const float red = reduce_scatter<NS, M>(acc, t);

    float dx, dy;
    bool small;
    float axx_n = axx, ayx_n = ayx, axy_n = axy, ayy_n = ayy;
    if constexpr (MODE == 0) {
      const float gxx = __shfl_sync(kFullWarp, red, 0 << SH);
      const float gxy = __shfl_sync(kFullWarp, red, 1 << SH);
      const float gyy = __shfl_sync(kFullWarp, red, 2 << SH);
      const float ex = __shfl_sync(kFullWarp, red, 3 << SH) * p.step;
      const float ey = __shfl_sync(kFullWarp, red, 4 << SH) * p.step;
      const float det = gxx * gyy - gxy * gxy;
      small = det < p.min_det;
      const float safe = small ? 1.0f : det;
      dx = (gyy * ex - gxy * ey) / safe;
      dy = (gxx * ey - gxy * ex) / safe;
    } else {
      float sol[NP];
      small = solve<MODE>(red, t, sol);
      axx_n = axx + sol[0];
      ayx_n = ayx + sol[1];
      if constexpr (MODE == 1) {
        ayy_n = axx_n;
        axy_n = -ayx_n;
        dx = sol[2];
        dy = sol[3];
      } else {
        axy_n = axy + sol[2];
        ayy_n = ayy + sol[3];
        dx = sol[NP - 2];
        dy = sol[NP - 1];
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
      if (!has_chunk<NCH>(k, nchunks)) break;
      const int c = t + 32 * k;
      const float2 o = offs[c];
      float xs, ys;
      warp_at<MODE>(o.x, o.y, x2, y2, axx, ayx, axy, ayy, xs, ys);
      const float v = c < ncell ? fabsf(g1[k] - sample1(im, xs, ys)) : 0.0f;
      r = k == 0 ? v : r + v;
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

struct AffLanes {
  const float* patches;    // [3, n, ph, pw]
  const float* stack2;     // [nseq, 3, rows, cols]
  int rows, cols, n, per;  // per: lanes of a sequence
  const float *x1, *y1, *x2, *y2, *axx, *ayx, *axy, *ayy;
  const uint8_t* active;
  float *x2o, *y2o, *axxo, *ayxo, *axyo, *ayyo;
  int *status, *iters;
};

// A lane of the track entry: the verification for an active lane, else a
// pass through.
template <int MODE, int NCH>
__device__ __forceinline__ void track_lane(const AffCfg& p, const AffLanes& l,
                                           const float2* offs, int f, int t) {
  const size_t patch = (size_t)p.ph * p.pw;
  const float* pat = l.patches + (size_t)f * patch;
  const size_t pplane = (size_t)l.n * patch;
  Lane s = {l.x2[f], l.y2[f], l.axx[f], l.ayx[f], l.axy[f], l.ayy[f],
            KLT_TRACKED, 0};
  const float* stack2 = l.stack2 + (size_t)(f / l.per) * 3 * l.rows * l.cols;
  if (l.active[f])
    verify_lane<MODE, NCH>(p, pat, pplane, stack2, l.rows, l.cols, offs,
                           l.x1[f], l.y1[f], s, t);
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
// the tracking loop's part of src/V1/trackFeatures.c:1438-1497), state
// updated in place: a feature tracked for the first time saves its patch,
// takes the patch centre frac(old position) + pw / 2 and the identity map
// and becomes valid; a tracked feature with a patch is verified, keeps the
// translation tracker's position and takes the converged map if it passes,
// and is killed (position -1, the status as val, patch centre -1, no
// longer valid) if not; a feature the tracker lost is no longer valid.
struct StepLanes {
  float* patches;                // [3, n, ph, pw]
  const float *stack1, *stack2;  // [nseq, 3, rows, cols]
  int rows, cols, n, per;        // per: lanes of a sequence
  uint8_t* valid;
  float *cx, *cy, *axx, *ayx, *axy, *ayy;  // the state, in place
  const float *x_old, *y_old, *xn, *yn;
  const int* vn;
  float *xo, *yo;
  int *vo, *iters;
};

template <int MODE, int NCH>
__device__ __forceinline__ void step_lane(const AffCfg& p, const StepLanes& l,
                                          const float2* offs, int f, int t) {
  const size_t patch = (size_t)p.ph * p.pw;
  float* pat = l.patches + (size_t)f * patch;
  const size_t pplane = (size_t)l.n * patch;
  const int vn = l.vn[f];
  const bool tracked = vn == KLT_TRACKED, valid = l.valid[f] != 0;
  const float xn = l.xn[f], yn = l.yn[f];
  float cx = l.cx[f], cy = l.cy[f];
  Lane s = {xn, yn, l.axx[f], l.ayx[f], l.axy[f], l.ayy[f], KLT_TRACKED, 0};
  const size_t seq = (size_t)(f / l.per) * 3 * l.rows * l.cols;
  // the state is updated in place by thread 0: every thread has read it
  // before any thread goes on
  __syncwarp();
  if (tracked && !valid) {
    const float x_old = l.x_old[f], y_old = l.y_old[f];
    save_patch(p, l.stack1 + seq, l.rows, l.cols, x_old, y_old, pat, pplane,
               t);
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
    verify_lane<MODE, NCH>(p, pat, pplane, l.stack2 + seq, l.rows, l.cols,
                           offs, cx, cy, s, t);
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

// The track entry runs off the main paths (the checks and the tests); at the
// step entry's register bound its mode-2 loop spilled, so it has none.
template <int MODE, int NCH>
__global__ void __launch_bounds__(kThreads)
    affine_track_kernel(AffCfg p, AffLanes l) {
  __shared__ float2 offs[KLT_AFFINE_MAX_CELLS];
  fill_offsets(offs, p);
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= l.n) return;
  track_lane<MODE, NCH>(p, l, offs, f, threadIdx.x & 31);
}

template <int MODE, int NCH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    affine_step_kernel(AffCfg p, StepLanes l) {
  __shared__ float2 offs[KLT_AFFINE_MAX_CELLS];
  fill_offsets(offs, p);
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= l.n) return;
  step_lane<MODE, NCH>(p, l, offs, f, threadIdx.x & 31);
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

bool shape_ok(int n, int nseq, int mode, int window_width, int window_height,
              int rows, int cols) {
  return n >= 1 && nseq >= 1 && n % nseq == 0 && mode >= 0 && mode <= 2 &&
         window_width >= 1 && window_height >= 1 &&
         (long long)window_width * window_height <= KLT_AFFINE_MAX_CELLS &&
         rows >= window_height + 2 && cols >= window_width + 2 &&
         (long long)rows * cols <= 0x7fffffffLL;
}

// One launch of kernel<mode, NCH>: NCH = kChunks for a window of 8 chunks
// (225 to 256 cells: the chunk loop without a branch), else 0.
#define KLT_LAUNCH_MODE(kernel, mode, p, n, stream, ...)                   \
  do {                                                                     \
    const int grid_ = ((n) + kWarpsPerBlock - 1) / kWarpsPerBlock;         \
    cudaStream_t st_ = (cudaStream_t)(stream);                             \
    const bool full_ = ((p).aw * (p).ah + 31) / 32 == kChunks;             \
    if ((mode) == 0 && full_)                                              \
      kernel<0, kChunks><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);        \
    else if ((mode) == 0)                                                  \
      kernel<0, 0><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);              \
    else if ((mode) == 1 && full_)                                         \
      kernel<1, kChunks><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);        \
    else if ((mode) == 1)                                                  \
      kernel<1, 0><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);              \
    else if (full_)                                                        \
      kernel<2, kChunks><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);        \
    else                                                                   \
      kernel<2, 0><<<grid_, kThreads, 0, st_>>>(__VA_ARGS__);              \
  } while (0)

}  // namespace

// The most cells of a window the kernel takes.
extern "C" int klt_affine_max_cells(void) { return KLT_AFFINE_MAX_CELLS; }

// The verify pass of n features in one launch.  Device pointers: patches
// f32 [3, n, window_height + 2, window_width + 2]; stack2 f32 [nseq, 3,
// rows, cols], lane f of sequence f / (n / nseq); the lanes' inputs and
// outputs [n], active u8.  Returns cudaGetLastError() after the launch.
extern "C" int klt_affine_track(
    const float* patches, const float* stack2, int nseq, int rows, int cols,
    const float* x1, const float* y1, const float* x2, const float* y2,
    const float* axx, const float* ayx, const float* axy, const float* ayy,
    const uint8_t* active, int n, int mode,
    int window_width, int window_height, int max_iterations,
    float min_displacement, float affine_min_displacement,
    float max_displacement_differ, float max_residue, float step_factor,
    float min_determinant, float* x2_out, float* y2_out, float* axx_out,
    float* ayx_out, float* axy_out, float* ayy_out, int* status, int* iters,
    void* stream) {
  if (!shape_ok(n, nseq, mode, window_width, window_height, rows, cols))
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
  l.per = n / nseq;
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
  KLT_LAUNCH_MODE(affine_track_kernel, mode, p, n, stream, p, l);
  return (int)cudaGetLastError();
}

// The whole consistency step of n features in one launch: the patch save
// of the features tracked for the first time, the verification of those
// with a patch, and the update of the state (valid u8, patch centres and
// maps f32 [n]) in place.  stack1, stack2: f32 [nseq, 3, rows, cols], lane
// f of sequence f / (n / nseq).  x_old, y_old: the positions before the
// translation track; xn, yn, vn: its result; x_out, y_out, val_out [n]:
// the step's.  Returns cudaGetLastError() after the launch.
extern "C" int klt_affine_step(
    float* patches, const float* stack1, const float* stack2, int nseq,
    int rows, int cols, uint8_t* valid, float* cx, float* cy, float* axx,
    float* ayx, float* axy, float* ayy, const float* x_old,
    const float* y_old, const float* xn, const float* yn, const int* vn,
    int n, int mode, int window_width, int window_height, int max_iterations,
    float min_displacement, float affine_min_displacement,
    float max_displacement_differ, float max_residue, float step_factor,
    float min_determinant, float* x_out, float* y_out, int* val_out,
    int* iters, void* stream) {
  if (!shape_ok(n, nseq, mode, window_width, window_height, rows, cols))
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
  l.per = n / nseq;
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
  KLT_LAUNCH_MODE(affine_step_kernel, mode, p, n, stream, p, l);
  return (int)cudaGetLastError();
}
