// Kernel A: the whole Gaussian pyramid of one frame.
//
// Replaces klt_tpu/pallas/pyramid.py::_fused_call (entry
// fused_build_pyramid_stacks), which builds everything in one VMEM-resident
// Pallas call.  Same semantics (reference src/V1/convolve.c:137-242 and
// src/V1/pyramid.c:87-131): u8 -> f32, pre-smoothing with smooth_sigma,
// then per level gradx = V(gauss) o H(deriv), grady = V(deriv) o H(gauss)
// and, below the coarsest level, the pyramid_sigma smoothing decimated at
// [ss/2 + ss*i]; taps applied reversed, output borders inside each kernel
// radius zeroed, the vertical pass reading the horizontally zeroed
// intermediate.  Every output pixel accumulates its taps in the sequential
// order acc = x[i-r]*t[w-1]; acc = acc + x[i-r+m]*t[w-1-m], built with
// -fmad=false, so it rounds exactly like the plain torch version
// (ops/pyramid.py) and the host exact chain.
//
// What bounds it on an H100: device-memory traffic and launch latency, not
// arithmetic.  A 640x480 frame is 1.2 MB of f32 per map; one level reads
// the level image and writes 3 intermediates, then reads those and writes
// 3 maps, all of which the 50 MB L2 holds.  The frames of the main path
// are small (76.8K and 307K pixels), so the 2 + 2 * n_levels launches of
// a few microseconds each weigh as much as the bytes.
//
// What the design does about it: one C entry enqueues the whole pyramid on
// the caller's stream with no host synchronisation; the u8 conversion is
// fused into the first horizontal pass; each horizontal launch writes all
// 2-3 intermediates a level needs (one grid plane per map) and each
// vertical launch writes gradx, grady and the next level's decimated image
// together, the decimation being a strided read that computes only the
// kept pixels.  One thread per output pixel reads straight from global
// memory (coalesced along x); taps travel as kernel arguments.  Tiling the
// passes in shared memory is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#define KLT_MAX_TAPS 71  // MAX_KERNEL_WIDTH, src/V1/convolve.c:16
#define KLT_MAX_MAPS 3

namespace {

struct TapSet {
  int n;
  float t[KLT_MAX_TAPS];
};

struct HArgs {
  const void* in;
  int in_u8;
  int rows, cols;
  int nmaps;
  float* out[KLT_MAX_MAPS];
  TapSet taps[KLT_MAX_MAPS];
};

struct VMap {
  const float* in;  // [rows, cols] horizontal-pass output
  float* out;       // [out_rows, out_cols]
  int out_rows, out_cols;
  int stride, offset;  // out[i][j] = V(in)[offset + stride*i][offset + stride*j]
  TapSet taps;
};

struct VArgs {
  int rows, cols;
  int nmaps;
  VMap m[KLT_MAX_MAPS];
};

__device__ __forceinline__ float load_px(const void* p, int u8, size_t i) {
  return u8 ? (float)((const uint8_t*)p)[i] : ((const float*)p)[i];
}

// out[y][x] = sum_m in[y][x-r+m] * t[w-1-m] for r <= x < cols-r, else 0.
__global__ void hpass(HArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (x >= a.cols || y >= a.rows || k >= a.nmaps) return;
  const TapSet& ts = a.taps[k];
  const int width = ts.n, r = width / 2;
  float acc = 0.0f;
  if (x >= r && x < a.cols - r) {
    const size_t base = (size_t)y * a.cols + (x - r);
    acc = load_px(a.in, a.in_u8, base) * ts.t[width - 1];
    for (int m = 1; m < width; ++m)
      acc = acc + load_px(a.in, a.in_u8, base + m) * ts.t[width - 1 - m];
  }
  a.out[k][(size_t)y * a.cols + x] = acc;
}

// out[i][j] = V(in)[y][x] at y = offset + stride*i, x = offset + stride*j,
// where V(in)[y][x] = sum_m in[y-r+m][x] * t[w-1-m] for r <= y < rows-r,
// else 0.
__global__ void vpass(VArgs a) {
  const int k = blockIdx.z;
  if (k >= a.nmaps) return;
  const VMap& mp = a.m[k];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= mp.out_cols || i >= mp.out_rows) return;
  const int y = mp.offset + mp.stride * i;
  const int x = mp.offset + mp.stride * j;
  const int width = mp.taps.n, r = width / 2;
  float acc = 0.0f;
  if (y >= r && y < a.rows - r) {
    const float* p = mp.in + (size_t)(y - r) * a.cols + x;
    acc = p[0] * mp.taps.t[width - 1];
    for (int m = 1; m < width; ++m)
      acc = acc + p[(size_t)m * a.cols] * mp.taps.t[width - 1 - m];
  }
  mp.out[(size_t)i * mp.out_cols + j] = acc;
}

void set_taps(TapSet* ts, const float* taps, int n) {
  ts->n = n;
  for (int i = 0; i < n; ++i) ts->t[i] = taps[i];
}

const dim3 kBlock(32, 8);

dim3 grid_for(int rows, int cols, int nmaps) {
  return dim3((cols + kBlock.x - 1) / kBlock.x, (rows + kBlock.y - 1) / kBlock.y,
              nmaps);
}

}  // namespace

extern "C" const char* klt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Builds n_levels stacks [3, H_l, W_l] (intensity, gradx, grady).
// img: device u8 or f32 [rows, cols]; taps: host arrays; levels: host array
// of n_levels device pointers; scratch: device f32 [3, rows, cols].
// Returns cudaGetLastError() after the last launch (or the first failure).
extern "C" int klt_build_pyramid(const void* img, int img_is_u8, int rows,
                                 int cols, int n_levels, int ss,
                                 const float* g_smooth, int n_smooth,
                                 const float* g_grad, int n_grad,
                                 const float* d_grad, int n_dgrad,
                                 const float* g_pyr, int n_pyr,
                                 float* const* levels, float* scratch,
                                 void* stream) {
  if (n_smooth > KLT_MAX_TAPS || n_grad > KLT_MAX_TAPS ||
      n_dgrad > KLT_MAX_TAPS || n_pyr > KLT_MAX_TAPS || n_levels < 1 ||
      ss < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;

  // pre-smoothing: H(g_smooth) of the raw frame, then V(g_smooth) into
  // level 0's intensity plane
  HArgs h = {};
  h.in = img;
  h.in_u8 = img_is_u8;
  h.rows = rows;
  h.cols = cols;
  h.nmaps = 1;
  h.out[0] = scratch;
  set_taps(&h.taps[0], g_smooth, n_smooth);
  hpass<<<grid_for(rows, cols, 1), kBlock, 0, st>>>(h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  VArgs v = {};
  v.rows = rows;
  v.cols = cols;
  v.nmaps = 1;
  v.m[0].in = scratch;
  v.m[0].out = levels[0];
  v.m[0].out_rows = rows;
  v.m[0].out_cols = cols;
  v.m[0].stride = 1;
  v.m[0].offset = 0;
  set_taps(&v.m[0].taps, g_smooth, n_smooth);
  vpass<<<grid_for(rows, cols, 1), kBlock, 0, st>>>(v);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int lr = rows, lc = cols;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const bool last = lvl == n_levels - 1;
    const size_t plane = (size_t)lr * lc;
    float* lev = levels[lvl];

    h = HArgs{};
    h.in = lev;
    h.in_u8 = 0;
    h.rows = lr;
    h.cols = lc;
    h.nmaps = last ? 2 : 3;
    h.out[0] = scratch;              // H(deriv)
    h.out[1] = scratch + plane;      // H(gauss)
    h.out[2] = scratch + 2 * plane;  // H(pyramid gauss)
    set_taps(&h.taps[0], d_grad, n_dgrad);
    set_taps(&h.taps[1], g_grad, n_grad);
    if (!last) set_taps(&h.taps[2], g_pyr, n_pyr);
    hpass<<<grid_for(lr, lc, h.nmaps), kBlock, 0, st>>>(h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    v = VArgs{};
    v.rows = lr;
    v.cols = lc;
    v.nmaps = last ? 2 : 3;
    // gradx = V(gauss) o H(deriv)
    v.m[0].in = scratch;
    v.m[0].out = lev + plane;
    v.m[0].out_rows = lr;
    v.m[0].out_cols = lc;
    v.m[0].stride = 1;
    v.m[0].offset = 0;
    set_taps(&v.m[0].taps, g_grad, n_grad);
    // grady = V(deriv) o H(gauss)
    v.m[1].in = scratch + plane;
    v.m[1].out = lev + 2 * plane;
    v.m[1].out_rows = lr;
    v.m[1].out_cols = lc;
    v.m[1].stride = 1;
    v.m[1].offset = 0;
    set_taps(&v.m[1].taps, d_grad, n_dgrad);
    if (!last) {
      // next level = V(pyramid gauss) o H(pyramid gauss), read at
      // [ss/2 + ss*i], cut to the integer-divided level shape
      v.m[2].in = scratch + 2 * plane;
      v.m[2].out = levels[lvl + 1];
      v.m[2].out_rows = lr / ss;
      v.m[2].out_cols = lc / ss;
      v.m[2].stride = ss;
      v.m[2].offset = ss / 2;
      set_taps(&v.m[2].taps, g_pyr, n_pyr);
    }
    vpass<<<grid_for(lr, lc, v.nmaps), kBlock, 0, st>>>(v);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    lr /= ss;
    lc /= ss;
  }
  return (int)cudaGetLastError();
}
