// The bit-exact tier's kernels: H2 (the exact response) and G (the exact
// LK walk).  The tier's pyramid is kernel A's (pyramid.cu), which already
// sums every pass in the C convolution's order.
//
// Neither replaces a TPU kernel: klt_tpu runs its bit-exact tier as XLA
// only.  H2 replaces klt_tpu/ops/replace_exact.py::exact_response_from_grads
// (:143-166), G klt_tpu/ops/lk_exact.py::_track_level_exact (:215-336) with
// its level walk track_features_exact (:339-390).  Each keeps the reference
// C tracker's operation order to the bit, as its plain torch version does
// (ops/lk_exact.py, ops/replace_exact.py); the build's -fmad=false keeps
// every product and sum separately rounded, and '/' and sqrt(double) are
// correctly rounded.  f32 addition is not associative, so no sum below is
// split, reassociated or reduced by a butterfly: the parallelism is in the
// products and samples, which are independent.
//
// H2: the min-eigenvalue response in the C order: per cell of the window
// interior, gx*gx, gx*gy, gy*gy summed row-major over the window from
// 0.0f (src/V1/selectGoodFeatures.c:398-406), disc and trace in f32, the
// square root and the final combine in double, one round to f32
// (:289-292), min(lam, 2147483583); -3e38 outside the interior.
// What bounds it on an H100: operations, 3 x 49 adds an output at 7x7
// (1.36 us at 640x480), then shared-memory reads; the maps are 3.7 MB.
// The design (klt_exact_response): a block of 8 x 16 threads owns a tile
// of 32 x 16 outputs; it loads the gx and gy pixels the tile needs, a halo
// of window_width - 1 columns and window_height - 1 rows included, and
// forms the three products once per pixel into shared memory (each product
// is one rounding, so forming it once gives the bits of forming it per
// cell).  A thread owns 4 horizontally adjacent outputs and runs their 12
// chains together, row by row of the window in row-major order, each from
// 0.0f: every product it reads from a shared row feeds all the outputs
// whose window holds it (a sliding window of 4 values a plane in
// registers).  Of 2, 4 and 8 outputs a thread and tiles of 8 to 32 rows,
// this shape measured fastest on an H100 (PERF.md, section 6).  Not D's
// separable sums: those change the bits.  A window no tile holds (wider
// than 115x115) takes the first design, a thread per pixel reading its
// cells from device memory (klt_exact_response_global); the wrapper picks
// by klt_exact_response_tile.
//
// G: the reference's _trackFeature loop (src/V1/trackFeatures.c:381-486)
// and its coarse-to-fine walk with the write-back, for every feature, in
// one launch per frame pair.  Each of the five window sums (gxx, gxy, gyy,
// ex, ey) and the residue is a chain of win*win dependent additions,
// row-major, from -0.0f (lk_exact_lane.h), which bounds a lane: an
// iteration waits for its chains, the next iteration's samples wait for
// the position they give.  The design: a warp per lane (lost lanes leave at
// once), kTrackWarps lanes a block, so 500 lanes fill the SMs.  Per level,
// thread t samples image 1 once for its cells t, t + 32, ... into the
// warp's shared memory (the samples do not change within a level); per
// iteration it samples image 2 for the same cells and forms diff, gx, gy
// and the five products, each by the scalar program's expression
// (klt_x_cell, klt_x_blend), into a chunk of 32 K cells in shared memory.
// Five threads then add one sum each over the chunk in row-major order,
// the chains carried from chunk to chunk, and __shfl_sync gives every
// thread the five sums: the step, the stop rule and the bounds tests run
// identically in all 32 threads, so the loop stays warp-uniform.  The
// residue is one thread's chain over |g1 - g2|.  A window whose image-1
// samples do not fit the block's shared memory (wider than about 135x135)
// samples image 1 again every iteration: the same bits.

#include <cuda_runtime.h>

#include "lk_exact_lane.h"

namespace {

constexpr size_t kMaxShared = 227 * 1024;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr unsigned kAll = 0xffffffffu;

// ------------------------------------------------------------------ H2

constexpr int kRespQ = 4;    // horizontally adjacent outputs a thread
constexpr int kRespTX = 8;   // threads along a tile row
constexpr int kRespTY = 16;  // thread rows = the tile's output rows
constexpr int kRespTileW = kRespQ * kRespTX;  // 32 output columns

struct RespArgs {
  const float *gx, *gy;
  float* out;
  int rows, cols, ww, wh;
  int pitch;  // row pitch of the product planes (odd)
};

// The product planes' row pitch: odd, so that the 4 thread rows of a warp
// (8 threads a row, 4 outputs apart) read 32 different banks.
__host__ __device__ __forceinline__ int resp_pitch(int ww) {
  return (kRespTileW + ww - 1) | 1;
}

__host__ __device__ __forceinline__ int resp_height(int wh) {
  return kRespTY + wh - 1;
}

size_t resp_shared(int ww, int wh) {
  return 3 * (size_t)resp_height(wh) * resp_pitch(ww) * sizeof(float);
}

__device__ __forceinline__ float exact_eigen(float gxx, float gxy,
                                             float gyy) {
  const float t1 = gxx - gyy;
  const float disc = t1 * t1 + (4.0f * gxy) * gxy;
  const float tr = gxx + gyy;
  const float lam = (float)(((double)tr - sqrt((double)disc)) / 2.0);
  return lam > 2147483583.0f ? 2147483583.0f : lam;  // NaN stays NaN
}

// The tile whose first output is (i0, j0).  prod: [3, ih, pitch] products
// of the gradients at rows i0 - wh/2 .., columns j0 - ww/2 ..; pixels
// outside the image are zeros, which feed only outputs outside the
// interior.  WW, WH > 0 unroll the window.
template <int WW, int WH>
__device__ __forceinline__ void response_tile(const RespArgs& a, int i0,
                                              int j0, float* prod) {
  constexpr int kBlock = kRespTX * kRespTY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRespTX + tx;
  const int ww = WW > 0 ? WW : a.ww, wh = WH > 0 ? WH : a.wh;
  const int hw = ww / 2, hh = wh / 2;
  const int pitch = a.pitch, plane = resp_height(wh) * pitch;
  const int gy0 = i0 - hh, gx0 = j0 - hw;

  for (int idx = tid; idx < plane; idx += kBlock) {
    const int yy = idx / pitch;
    const int y = gy0 + yy, x = gx0 + idx - yy * pitch;
    float u = 0.0f, v = 0.0f;
    if ((unsigned)y < (unsigned)a.rows && (unsigned)x < (unsigned)a.cols) {
      u = a.gx[(size_t)y * a.cols + x];
      v = a.gy[(size_t)y * a.cols + x];
    }
    prod[idx] = u * u;
    prod[plane + idx] = u * v;
    prod[2 * plane + idx] = v * v;
  }
  __syncthreads();

  const int oy = i0 + ty, ox0 = j0 + tx * kRespQ;
  if (oy >= a.rows || ox0 >= a.cols) return;
  // acc[k][q]: sum k (gxx, gxy, gyy) of output ox0 + q, one chain each
  float acc[3][kRespQ];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int q = 0; q < kRespQ; ++q) acc[k][q] = 0.0f;
  const float* row = prod + ty * pitch + tx * kRespQ;
#pragma unroll
  for (int dy = 0; dy < wh; ++dy, row += pitch) {
    // v[k][q] = plane k at column dx + q of this window row
    float v[3][kRespQ];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int q = 0; q + 1 < kRespQ; ++q) v[k][q + 1] = row[k * plane + q];
#pragma unroll
    for (int dx = 0; dx < ww; ++dx) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int q = 0; q + 1 < kRespQ; ++q) v[k][q] = v[k][q + 1];
        v[k][kRespQ - 1] = row[k * plane + dx + kRespQ - 1];
      }
#pragma unroll
      for (int q = 0; q < kRespQ; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[k][q] = acc[k][q] + v[k][q];
    }
  }
  const bool row_in = oy >= hh && oy < a.rows - hh;
  float* out = a.out + (size_t)oy * a.cols;
#pragma unroll
  for (int q = 0; q < kRespQ; ++q) {
    const int ox = ox0 + q;
    if (ox < a.cols)
      out[ox] = row_in && ox >= hw && ox < a.cols - hw
                    ? exact_eigen(acc[0][q], acc[1][q], acc[2][q])
                    : -3e38f;
  }
}

// Grid: (tiles along a row, tile rows).  The unrolled instantiation is the
// default configuration's 7x7 window (9% faster on an H100 than the generic
// one, PERF.md section 6).
__global__ void __launch_bounds__(kRespTX * kRespTY)
exact_response_tiles(const __grid_constant__ RespArgs a) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.y * kRespTY, j0 = blockIdx.x * kRespTileW;
  if (a.ww == 7 && a.wh == 7)
    response_tile<7, 7>(a, i0, j0, smem);
  else
    response_tile<0, 0>(a, i0, j0, smem);
}

// A window no tile holds: a thread per pixel, its cells read from device
// memory (the first design of this kernel).
constexpr int kRespX = 32, kRespY = 8;

__global__ void __launch_bounds__(kRespX * kRespY)
exact_response_global(const float* __restrict__ gx,
                      const float* __restrict__ gy, int rows, int cols,
                      int ww, int wh, float* __restrict__ out) {
  const int ox = blockIdx.x * kRespX + threadIdx.x;
  const int oy = blockIdx.y * kRespY + threadIdx.y;
  if (ox >= cols || oy >= rows) return;
  const int hw = ww / 2, hh = wh / 2;
  float res = -3e38f;
  if (oy >= hh && oy < rows - hh && ox >= hw && ox < cols - hw) {
    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
    for (int dy = 0; dy < wh; ++dy) {
      const long row = (long)(oy - hh + dy) * cols + ox - hw;
      for (int dx = 0; dx < ww; ++dx) {
        const float a = gx[row + dx], b = gy[row + dx];
        gxx = gxx + a * a;
        gxy = gxy + a * b;
        gyy = gyy + b * b;
      }
    }
    res = exact_eigen(gxx, gxy, gyy);
  }
  out[(long)oy * cols + ox] = res;
}

bool resp_shape_ok(int rows, int cols, int ww, int wh) {
  return rows >= 1 && cols >= 1 && ww >= 1 && wh >= 1 &&
         (long)rows * cols <= 0x7fffffffL;
}

// The tile's output rows, or 0 when no tile holds the window.
int resp_tile_rows(int ww, int wh) {
  if (ww < 1 || wh < 1 || ww > 4096 || wh > 4096) return 0;
  return resp_shared(ww, wh) <= kMaxShared ? kRespTY : 0;
}

// ------------------------------------------------------------------- G

constexpr int kTrackWarps = 4;  // lanes a block, a warp each
constexpr int kSums = 5;        // gxx, gxy, gyy, ex, ey

// Floats of one warp's shared memory: the five product rows of a chunk of
// 32 K cells (padded by one, so the five summing threads read five
// banks), then image 1's three samples of every window cell when hoisted.
__host__ __device__ __forceinline__ int track_warp_floats(int k, int ncell,
                                                          int hoist) {
  return kSums * (32 * k + 1) + (hoist ? 3 * ncell : 0);
}

// The samples of three planes (p, p + plane, p + 2 plane) at window cell
// (i, j) of (x, y), by the scalar program's expressions.
__device__ __forceinline__ void sample3(const float* p, long plane, int cols,
                                        float x, float y, int i, int j,
                                        float* s0, float* s1, float* s2) {
  int xt, yt;
  float w00, w01, w10, w11;
  klt_x_cell(x, y, i, j, &xt, &yt, &w00, &w01, &w10, &w11);
  *s0 = klt_x_blend(p, cols, xt, yt, w00, w01, w10, w11);
  *s1 = klt_x_blend(p + plane, cols, xt, yt, w00, w01, w10, w11);
  *s2 = klt_x_blend(p + 2 * plane, cols, xt, yt, w00, w01, w10, w11);
}

__device__ __forceinline__ float sample1(const float* p, int cols, float x,
                                         float y, int i, int j) {
  int xt, yt;
  float w00, w01, w10, w11;
  klt_x_cell(x, y, i, j, &xt, &yt, &w00, &w01, &w10, &w11);
  return klt_x_blend(p, cols, xt, yt, w00, w01, w10, w11);
}

// acc + q[0] + q[1] + .. + q[n - 1], added in that order: one chain.  The
// loads of a batch of 32 are issued before its adds.
__device__ __forceinline__ float chain_add(float acc, const float* q, int n) {
  for (int m0 = 0; m0 < n; m0 += 32) {
    float t[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) t[i] = m0 + i < n ? q[m0 + i] : 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (m0 + i < n) acc = acc + t[i];
  }
  return acc;
}

// klt_x_track_level for the lane of this warp: every thread returns the
// same status and position.  prod: the warp's [5, 32 K + 1] chunk rows;
// h1: its [3, win*win] image-1 samples, or null to sample image 1 again
// each iteration.
template <int K>
__device__ int warp_track_level(const KltExactArgs& a, int r, float x1,
                                float y1, float* x2p, float* y2p,
                                float* prod, float* h1, int lane) {
  constexpr int kChunk = 32 * K, kPitch = kChunk + 1;
  const int rows = a.rows[r], cols = a.cols[r];
  const long plane = (long)rows * cols;
  const float* i1 = a.st1[r];
  const float* i2 = a.st2[r];
  const int win = a.win, hw = win / 2, ncell = win * win;
  float x2 = *x2p, y2 = *y2p;
  int status = KLT_X_TRACKED, iters = 0;
  int run = !klt_x_oob(x1, y1, hw, rows, cols) &&
            !klt_x_oob(x2, y2, hw, rows, cols);
  if (!run) status = KLT_X_OOB;
  // image 1 is read only where the bounds test passed: then the loop or
  // the residue reads it
  if (run && h1) {
    for (int c = lane; c < ncell; c += 32)
      sample3(i1, plane, cols, x1, y1, c % win - hw, c / win - hw, h1 + c,
              h1 + ncell + c, h1 + 2 * ncell + c);
  }
  if (a.max_iterations <= 0) run = 0;
  while (run) {
    float acc = -0.0f;  // thread s < 5: sum s, one chain over the window
    for (int base = 0; base < ncell; base += kChunk) {
      // the products of the thread's cells in registers first, then the
      // stores, so that the loads of all K cells are in flight together
      float p[K][kSums];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = base + lane + 32 * k;  // c % 32 == lane: h1 is ours
        if (c < ncell) {
          const int i = c % win - hw, j = c / win - hw;
          float g1, gx1, gy1, g2, gx2, gy2;
          if (h1) {
            g1 = h1[c];
            gx1 = h1[ncell + c];
            gy1 = h1[2 * ncell + c];
          } else {
            sample3(i1, plane, cols, x1, y1, i, j, &g1, &gx1, &gy1);
          }
          sample3(i2, plane, cols, x2, y2, i, j, &g2, &gx2, &gy2);
          const float diff = g1 - g2;
          const float gx = gx1 + gx2, gy = gy1 + gy2;
          p[k][0] = gx * gx;
          p[k][1] = gx * gy;
          p[k][2] = gy * gy;
          p[k][3] = diff * gx;
          p[k][4] = diff * gy;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = base + lane + 32 * k;
        if (c < ncell) {
#pragma unroll
          for (int s = 0; s < kSums; ++s) prod[s * kPitch + c - base] = p[k][s];
        }
      }
      __syncwarp();
      if (lane < kSums)
        acc = chain_add(acc, prod + lane * kPitch, min(kChunk, ncell - base));
      __syncwarp();
    }
    const float gxx = __shfl_sync(kAll, acc, 0);
    const float gxy = __shfl_sync(kAll, acc, 1);
    const float gyy = __shfl_sync(kAll, acc, 2);
    const float ex = __shfl_sync(kAll, acc, 3) * a.step_factor;
    const float ey = __shfl_sync(kAll, acc, 4) * a.step_factor;
    const float det = gxx * gyy - gxy * gxy;
    if (!(det >= a.min_determinant)) {
      status = KLT_X_SMALL_DET;
      break;
    }
    const float dx = (gyy * ex - gxy * ey) / det;
    const float dy = (gxx * ey - gxy * ex) / det;
    x2 = x2 + dx;
    y2 = y2 + dy;
    iters += 1;
    run = (fabsf(dx) >= a.min_displacement ||
           fabsf(dy) >= a.min_displacement) && iters < a.max_iterations;
    if (run && klt_x_oob(x2, y2, hw, rows, cols)) {
      status = KLT_X_OOB;
      run = 0;
    }
  }
  if (klt_x_oob(x2, y2, hw, rows, cols)) status = KLT_X_OOB;
  if (status == KLT_X_TRACKED && a.check_residue) {
    float acc = -0.0f;  // thread 0: the residue's chain
    for (int base = 0; base < ncell; base += kChunk) {
      float d[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = base + lane + 32 * k;
        if (c < ncell) {
          const int i = c % win - hw, j = c / win - hw;
          const float g1 = h1 ? h1[c] : sample1(i1, cols, x1, y1, i, j);
          d[k] = fabsf(g1 - sample1(i2, cols, x2, y2, i, j));
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = base + lane + 32 * k;
        if (c < ncell) prod[c - base] = d[k];
      }
      __syncwarp();
      if (lane == 0) acc = chain_add(acc, prod, min(kChunk, ncell - base));
      __syncwarp();
    }
    const float resid = __shfl_sync(kAll, acc, 0);
    if (resid / (float)(win * win) > a.max_residue)
      status = KLT_X_LARGE_RESIDUE;
  }
  if (status == KLT_X_TRACKED && iters >= a.max_iterations)
    status = KLT_X_MAX_ITERATIONS;
  *x2p = x2;
  *y2p = y2;
  return status;
}

// Warp w of block b tracks lane b * (blockDim.x / 32) + w; the level walk
// and write-back are klt_x_track_lane's, run identically in every thread,
// lane 0 writing.
template <int K>
__global__ void __launch_bounds__(32 * kTrackWarps)
exact_track(const __grid_constant__ KltExactArgs a, const float* x,
            const float* y, const int* val, int n, float* xo, float* yo,
            int* vo, int hoist) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= n) return;
  const float xf = x[f], yf = y[f];
  const int vf = val[f];
  if (vf < 0) {  // a lost slot is left as it is
    if (lane == 0) {
      xo[f] = xf;
      yo[f] = yf;
      vo[f] = vf;
    }
    return;
  }
  const int ncell = a.win * a.win;
  float* prod = smem + (size_t)warp * track_warp_floats(K, ncell, hoist);
  float* h1 = hoist ? prod + kSums * (32 * K + 1) : nullptr;
  const float ss = a.subsampling;
  float xloc = xf, yloc = yf;
  for (int l = 0; l < a.nlev; ++l) {
    xloc = xloc / ss;
    yloc = yloc / ss;
  }
  float xout = xloc, yout = yloc;
  int status = KLT_X_TRACKED, alive = 1;
  for (int r = a.nlev - 1; r >= 0; --r) {
    xloc = xloc * ss;
    yloc = yloc * ss;
    xout = xout * ss;
    yout = yout * ss;
    if (!alive) continue;
    status = warp_track_level<K>(a, r, xloc, yloc, &xout, &yout, prod, h1,
                                 lane);
    if (status == KLT_X_SMALL_DET || status == KLT_X_OOB) alive = 0;
  }
  if (lane == 0) klt_x_write_back(&a, status, xout, yout, xo + f, yo + f,
                                  vo + f);
}

// Launch G with chunks of 32 K cells: as many lanes a block (up to
// kTrackWarps) as the hoisted samples leave room for; no hoisting when one
// lane's do not fit.
template <int K>
int launch_track(const KltExactArgs& a, const float* x, const float* y,
                 const int* val, int n, float* xo, float* yo, int* vo,
                 cudaStream_t stream) {
  const int ncell = a.win * a.win;
  int hoist = 1, warps = kTrackWarps;
  size_t per_warp = track_warp_floats(K, ncell, 1) * sizeof(float);
  while (warps > 1 && warps * per_warp > kMaxShared) --warps;
  if (per_warp > kMaxShared) {
    hoist = 0;
    warps = kTrackWarps;
    per_warp = track_warp_floats(K, ncell, 0) * sizeof(float);
  }
  const size_t shared = warps * per_warp;
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        exact_track<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  exact_track<K><<<(n + warps - 1) / warps, 32 * warps, shared, stream>>>(
      a, x, y, val, n, xo, yo, vo, hoist);
  return (int)cudaGetLastError();
}

}  // namespace

// The output rows of H2's tile for this window (16), or 0 when no tile
// holds it and klt_exact_response_global is the entry to take.
extern "C" int klt_exact_response_tile(int window_width, int window_height) {
  return resp_tile_rows(window_width, window_height);
}

// Kernel H2, tiled.  gx, gy, out: device f32 [rows, cols].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// window that no tile holds.
extern "C" int klt_exact_response(const float* gx, const float* gy, int rows,
                                  int cols, int window_width,
                                  int window_height, float* out,
                                  void* stream) {
  if (!resp_shape_ok(rows, cols, window_width, window_height) ||
      !resp_tile_rows(window_width, window_height))
    return (int)cudaErrorInvalidValue;
  RespArgs a;
  a.gx = gx;
  a.gy = gy;
  a.out = out;
  a.rows = rows;
  a.cols = cols;
  a.ww = window_width;
  a.wh = window_height;
  a.pitch = resp_pitch(window_width);
  const size_t shared = resp_shared(window_width, window_height);
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        exact_response_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((cols + kRespTileW - 1) / kRespTileW,
                  (rows + kRespTY - 1) / kRespTY);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  exact_response_tiles<<<grid, dim3(kRespTX, kRespTY), shared,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel H2 for any window: a thread per pixel.  The arguments of
// klt_exact_response.
extern "C" int klt_exact_response_global(const float* gx, const float* gy,
                                         int rows, int cols, int window_width,
                                         int window_height, float* out,
                                         void* stream) {
  if (!resp_shape_ok(rows, cols, window_width, window_height))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kRespX - 1) / kRespX, (rows + kRespY - 1) / kRespY);
  exact_response_global<<<grid, dim3(kRespX, kRespY), 0,
                          (cudaStream_t)stream>>>(
      gx, gy, rows, cols, window_width, window_height, out);
  return (int)cudaGetLastError();
}

extern "C" int klt_exact_max_levels(void) { return KLT_EXACT_MAX_LEVELS; }

// Kernel G.  stacks1, stacks2: host arrays of nlev device pointers to the
// two frames' finest-first f32 [3, rows_l, cols_l] stacks; x, y, val:
// device [n] in; xo, yo, vo: device [n] out; the configuration as
// KltExactArgs holds it.  Returns cudaGetLastError() after the launch.
extern "C" int klt_exact_track(const float* const* stacks1,
                               const float* const* stacks2, const int* rows,
                               const int* cols, int nlev, const float* x,
                               const float* y, const int* val, int n, int win,
                               int max_iterations, int check_residue,
                               float subsampling, float min_determinant,
                               float min_displacement, float step_factor,
                               float max_residue, float border_x0,
                               float border_x1, float border_y0,
                               float border_y1, float* xo, float* yo, int* vo,
                               void* stream) {
  if (nlev < 1 || nlev > KLT_EXACT_MAX_LEVELS || n < 0 || win < 1 ||
      win % 2 == 0 || win > 4095)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  KltExactArgs a;
  for (int l = 0; l < nlev; ++l) {
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int ncell = win * win;
  if (ncell <= 64) return launch_track<2>(a, x, y, val, n, xo, yo, vo, st);
  if (ncell <= 128) return launch_track<4>(a, x, y, val, n, xo, yo, vo, st);
  return launch_track<8>(a, x, y, val, n, xo, yo, vo, st);
}
