// Kernel B: the whole Newton loop of one pyramid level, for every feature.
//
// Replaces klt_tpu/pallas/lk2.py::_make_kernel (entry lk_level_inner_flat),
// which runs the masked Newton loop on per-feature patches that an
// extraction pass copies into VMEM and re-anchors whenever a feature walks
// off its patch.  Semantics (klt_tpu/ops/lk.py::_track_level_gather, the C
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
// (the misnamed accumulators of src/V1/trackFeatures.c:180-220).
// MAX_ITERATIONS, LARGE_RESIDUE and the final OOB are classified by the
// caller (ops/lk.py::_final_status), as for the plain version.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A level holds
// 150 to 2000 features; each runs up to 10 dependent iterations of 6 x 49
// bilinear samples (4 loads each) and 5 sequential sums, a few thousand
// dependent instructions that cannot start before the previous step's
// position is known.  The card has far more lanes than features.
//
// What the design does about it: one thread per feature walks its Newton
// loop and reads the level stacks straight from device memory (the L1/L2
// keep a 7x7 window and its neighbours resident), so there is no patch
// canvas, no extraction pass, nothing to re-anchor and no host round trip
// between iterations; the whole level is one launch.  Sums run cell by cell
// in row-major window order with -fmad=false, so the result equals the
// plain torch version (ops/lk.py::lk_level_plain) bit for bit.  Spreading a
// feature over a warp, which changes the summation order, is left to a
// later change.
//
// Window starts are clamped to [0, cols-(w+1)] x [0, rows-(h+1)] like the
// plain version's gather (klt_tpu's dynamic_slice), so the residue sampled
// at a final position off the image stays in bounds; the caller never
// launches on a level smaller than the window plus one.

#include <cuda_runtime.h>
#include <stdint.h>

#define KLT_TRACKED 0
#define KLT_SMALL_DET (-2)
#define KLT_OOB (-4)
#define KLT_EPS 1.001f  // src/V1/trackFeatures.c:409

namespace {

struct LkParams {
  int rows, cols, n;
  int w, h;
  float min_disp, min_det, step;
  int max_iter, lighting, want_residue;
};

// Integer-aligned window corner (C (int) truncation, clamped start) and
// the four bilinear weights, which are constant over a window.
struct Win {
  int off;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Win make_win(float x, float y, const LkParams& p) {
  const int xt = (int)x, yt = (int)y;
  const float ax = x - (float)xt, ay = y - (float)yt;
  const int x0 = min(max(xt - p.w / 2, 0), p.cols - (p.w + 1));
  const int y0 = min(max(yt - p.h / 2, 0), p.rows - (p.h + 1));
  Win win;
  win.off = y0 * p.cols + x0;
  win.w00 = (1.0f - ax) * (1.0f - ay);
  win.w01 = ax * (1.0f - ay);
  win.w10 = (1.0f - ax) * ay;
  win.w11 = ax * ay;
  return win;
}

__device__ __forceinline__ float sample(const float* plane, int cols,
                                        const Win& win, int j, int i) {
  const float* q = plane + win.off + j * cols + i;
  float v = win.w00 * q[0];
  v = v + win.w01 * q[1];
  v = v + win.w10 * q[cols];
  v = v + win.w11 * q[cols + 1];
  return v;
}

__device__ __forceinline__ bool window_oob(float x, float y,
                                           const LkParams& p) {
  const float hw = (float)(p.w / 2), hh = (float)(p.h / 2);
  return (x - hw < 0.0f) || ((float)p.cols - (x + hw) < KLT_EPS) ||
         (y - hh < 0.0f) || ((float)p.rows - (y + hh) < KLT_EPS);
}

// Sum and sum of squares of the intensity window, row-major.
__device__ __forceinline__ void intensity_sums(const float* img,
                                               const Win& win,
                                               const LkParams& p, float* s,
                                               float* sq) {
  float a = 0.0f, b = 0.0f;
  for (int j = 0; j < p.h; ++j)
    for (int i = 0; i < p.w; ++i) {
      const float g = sample(img, p.cols, win, j, i);
      a = a + g;
      b = b + g * g;
    }
  *s = a;
  *sq = b;
}

__global__ void lk_level_kernel(const float* __restrict__ s1,
                                const float* __restrict__ s2,
                                const float* __restrict__ x1,
                                const float* __restrict__ y1,
                                const float* __restrict__ x2,
                                const float* __restrict__ y2,
                                const uint8_t* __restrict__ active,
                                LkParams p, float* __restrict__ x2o,
                                float* __restrict__ y2o,
                                int* __restrict__ status_o,
                                int* __restrict__ iters_o,
                                float* __restrict__ res_o) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= p.n) return;
  float xc = x2[f], yc = y2[f];
  if (!active[f]) {
    x2o[f] = xc;
    y2o[f] = yc;
    status_o[f] = KLT_TRACKED;
    iters_o[f] = 0;
    res_o[f] = 0.0f;
    return;
  }
  const size_t plane = (size_t)p.rows * p.cols;
  const float *i1 = s1, *gx1p = s1 + plane, *gy1p = s1 + 2 * plane;
  const float *i2 = s2, *gx2p = s2 + plane, *gy2p = s2 + 2 * plane;
  const float area = (float)(p.w * p.h);

  const float xf1 = x1[f], yf1 = y1[f];
  const Win w1 = make_win(xf1, yf1, p);
  const bool oob1 = window_oob(xf1, yf1, p);
  float sum1 = 0.0f, sq1 = 0.0f;
  if (p.lighting) intensity_sums(i1, w1, p, &sum1, &sq1);

  int status = KLT_TRACKED, iters = 0;
  for (int k = 0; k < p.max_iter; ++k) {
    if (oob1 || window_oob(xc, yc, p)) {
      status = KLT_OOB;
      break;
    }
    const Win w2 = make_win(xc, yc, p);
    float alpha = 1.0f, beta = 0.0f, alpha_g = 1.0f;
    if (p.lighting) {
      float sum2, sq2;
      intensity_sums(i2, w2, p, &sum2, &sq2);
      alpha = sqrtf((sq1 / area) / (sq2 / area));
      beta = sum1 / area - alpha * (sum2 / area);
      alpha_g = sqrtf((sum1 / area) / (sum2 / area));
    }
    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, ex = 0.0f, ey = 0.0f;
    for (int j = 0; j < p.h; ++j)
      for (int i = 0; i < p.w; ++i) {
        const float g1 = sample(i1, p.cols, w1, j, i);
        const float g2 = sample(i2, p.cols, w2, j, i);
        const float gx1 = sample(gx1p, p.cols, w1, j, i);
        const float gy1 = sample(gy1p, p.cols, w1, j, i);
        const float gx2 = sample(gx2p, p.cols, w2, j, i);
        const float gy2 = sample(gy2p, p.cols, w2, j, i);
        float diff, gx, gy;
        if (p.lighting) {
          diff = (g1 - g2 * alpha) - beta;
          gx = gx1 + gx2 * alpha_g;
          gy = gy1 + gy2 * alpha_g;
        } else {
          diff = g1 - g2;
          gx = gx1 + gx2;
          gy = gy1 + gy2;
        }
        gxx = gxx + gx * gx;
        gxy = gxy + gx * gy;
        gyy = gyy + gy * gy;
        ex = ex + diff * gx;
        ey = ey + diff * gy;
      }
    ex = ex * p.step;
    ey = ey * p.step;
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

  float res = 0.0f;
  if (p.want_residue) {
    const Win w2 = make_win(xc, yc, p);
    float alpha = 1.0f, beta = 0.0f;
    if (p.lighting) {
      float sum2, sq2;
      intensity_sums(i2, w2, p, &sum2, &sq2);
      alpha = sqrtf((sq1 / area) / (sq2 / area));
      beta = sum1 / area - alpha * (sum2 / area);
    }
    for (int j = 0; j < p.h; ++j)
      for (int i = 0; i < p.w; ++i) {
        const float g1 = sample(i1, p.cols, w1, j, i);
        const float g2 = sample(i2, p.cols, w2, j, i);
        const float diff = p.lighting ? (g1 - g2 * alpha) - beta : g1 - g2;
        res = res + fabsf(diff);
      }
    res = res / area;
  }
  x2o[f] = xc;
  y2o[f] = yc;
  status_o[f] = status;
  iters_o[f] = iters;
  res_o[f] = res;
}

}  // namespace

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
  if (n < 1 || rows < window_height + 1 || cols < window_width + 1)
    return (int)cudaErrorInvalidValue;
  LkParams p;
  p.rows = rows;
  p.cols = cols;
  p.n = n;
  p.w = window_width;
  p.h = window_height;
  p.min_disp = min_displacement;
  p.min_det = min_determinant;
  p.step = step_factor;
  p.max_iter = max_iterations;
  p.lighting = lighting;
  p.want_residue = want_residue;
  const int threads = 128;
  lk_level_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(stack1, stack2, x1, y1, x2, y2,
                                            active, p, x2_out, y2_out, status,
                                            iters, residue);
  return (int)cudaGetLastError();
}
