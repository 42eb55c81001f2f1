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
// correctly rounded.
//
// H2: the min-eigenvalue response in the C order: per cell of the window
// interior, gx*gx, gx*gy, gy*gy summed row-major over the window from
// 0.0f (src/V1/selectGoodFeatures.c:398-406), disc and trace in f32, the
// square root and the final combine in double, one round to f32
// (:289-292), min(lam, 2147483583); -3e38 outside the interior.  One
// thread per pixel.
//
// G: the lane program of lk_exact_lane.h (the same lines compile into the
// scalar host oracle, native/lk_exact_ref.c): one thread per feature runs
// its whole coarse-to-fine walk, every level, in one launch per frame
// pair, sampling the level planes straight from device memory (no patch,
// no margin) in the order of _trackFeature (src/V1/trackFeatures.c:381-486).
// It shares nothing with kernel B: B sums a window in a warp's order,
// which is not C's.
//
// What bounds them on an H100.  H2: device-memory traffic and launch
// latency (two gradient maps read and one map written, 3.7 MB at 640x480,
// a few us; 6 flops a window cell an output).  G: the
// latency of one lane's serial chain: each of the five window sums is a
// chain of win*win dependent adds, an iteration waits for the last, and
// the next iteration's samples wait for the position it gives; 500 lanes
// fill a few SMs.  The design does nothing about it yet: it is the simple
// form that is right.  A later redesign can spread a lane over a warp
// while keeping each chain's order (every thread computes its cells'
// products, one thread adds them in order), as kernels B and F spread
// theirs.

#include <cuda_runtime.h>

#include "lk_exact_lane.h"

namespace {

constexpr int kRespX = 32, kRespY = 8;

__global__ void __launch_bounds__(kRespX * kRespY)
exact_response(const float* __restrict__ gx, const float* __restrict__ gy,
               int rows, int cols, int ww, int wh, float* __restrict__ out) {
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
    const float t1 = gxx - gyy;
    const float disc = t1 * t1 + (4.0f * gxy) * gxy;
    const float tr = gxx + gyy;
    const float lam = (float)(((double)tr - sqrt((double)disc)) / 2.0);
    res = lam > 2147483583.0f ? 2147483583.0f : lam;  // NaN stays NaN
  }
  out[(long)oy * cols + ox] = res;
}

constexpr int kTrackThreads = 32;  // a warp a block: lanes spread over SMs

__global__ void __launch_bounds__(kTrackThreads)
exact_track(const __grid_constant__ KltExactArgs a, const float* x,
            const float* y, const int* val, int n, float* xo, float* yo,
            int* vo) {
  const int f = blockIdx.x * kTrackThreads + threadIdx.x;
  if (f >= n) return;
  klt_x_track_lane(&a, x[f], y[f], val[f], xo + f, yo + f, vo + f);
}

}  // namespace

// Kernel H2.  gx, gy, out: device f32 [rows, cols].  Returns
// cudaGetLastError() after the launch.
extern "C" int klt_exact_response(const float* gx, const float* gy, int rows,
                                  int cols, int window_width,
                                  int window_height, float* out,
                                  void* stream) {
  if (rows < 1 || cols < 1 || window_width < 1 || window_height < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kRespX - 1) / kRespX, (rows + kRespY - 1) / kRespY);
  exact_response<<<grid, dim3(kRespX, kRespY), 0, (cudaStream_t)stream>>>(
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
      win % 2 == 0)
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
  exact_track<<<(n + kTrackThreads - 1) / kTrackThreads, kTrackThreads, 0,
                (cudaStream_t)stream>>>(a, x, y, val, n, xo, yo, vo);
  return (int)cudaGetLastError();
}
