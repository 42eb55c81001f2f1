// Kernel D: the Shi-Tomasi (min-eigenvalue) corner response of a frame.
//
// Replaces klt_tpu/pallas/selection.py::_response_call (entry
// fused_corner_response), which box-filters the three gradient products in
// VMEM and evaluates the closed-form minimum eigenvalue.  Same semantics
// (the reference's dense scan, src/V1/selectGoodFeatures.c:394-424 and
// _minEigenvalue :289-292): products gx*gx, gx*gy, gy*gy; each box-filtered
// over the window_width x window_height window, horizontal pass first,
// columns within r = window_width/2 of an edge zeroed, then the vertical
// pass over that intermediate with rows within r = window_height/2 zeroed
// (the Pallas kernel's _hconv/_vconv borders); then
//   lam = (gxx + gyy - sqrt((gxx - gyy)*(gxx - gyy) + 4*gxy*gxy)) / 2
// clamped at 2147483583 (the int-capacity clamp, :415-420).  Every sum runs
// sequentially from offset -r to +r, the plain torch version's order
// (ops/selection.py::corner_response_plain through ops/convolve.py), and
// the build uses -fmad=false with IEEE sqrtf and division, so the two agree
// bit for bit.  That matters: the caller truncates the response to int and
// sorts by it, so one ulp across an integer changes a candidate's value
// and can change a pick.
//
// What bounds it on an H100: launch latency and device-memory traffic.  A
// 640x480 frame reads two 1.2 MB maps, writes and rereads a 3.7 MB scratch
// and writes the 1.2 MB response, all of it L2-resident; the arithmetic
// is 3 products and 2 x 3 x 7 adds per pixel.
//
// What the design does about it: two launches, one thread per pixel, loads
// coalesced along x.  Pass 1 forms the three products on the fly and
// writes their horizontal sums to a [3, H, W] scratch; pass 2 sums those
// vertically and evaluates the eigenvalue in registers, so the product
// maps and the box-filtered maps never reach device memory.  Tiling in
// shared memory is left to a later change.

#include <cuda_runtime.h>

#define KLT_INT_LIMIT 2147483583.0f  // rounds to the largest f32 below 2^31

namespace {

// scratch[k][y][x] = sum_m p_k[y][x-r+m] for r <= x < cols-r, else 0, with
// p_0 = gx*gx, p_1 = gx*gy, p_2 = gy*gy.
__global__ void hsum_products(const float* gx, const float* gy, int rows,
                              int cols, int ww, float* scratch) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || y >= rows) return;
  const int r = ww / 2;
  float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
  if (x >= r && x < cols - r) {
    const size_t base = (size_t)y * cols + (x - r);
    float a = gx[base], b = gy[base];
    sxx = a * a;
    sxy = a * b;
    syy = b * b;
    for (int m = 1; m < ww; ++m) {
      a = gx[base + m];
      b = gy[base + m];
      sxx = sxx + a * a;
      sxy = sxy + a * b;
      syy = syy + b * b;
    }
  }
  const size_t plane = (size_t)rows * cols, i = (size_t)y * cols + x;
  scratch[i] = sxx;
  scratch[plane + i] = sxy;
  scratch[2 * plane + i] = syy;
}

// out[y][x] = min-eigenvalue of the vertical sums of scratch, rows within
// r = wh/2 of an edge summing to zero.
__global__ void vsum_eigen(const float* scratch, int rows, int cols, int wh,
                           float* out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || y >= rows) return;
  const int r = wh / 2;
  const size_t plane = (size_t)rows * cols;
  float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
  if (y >= r && y < rows - r) {
    const float* p = scratch + (size_t)(y - r) * cols + x;
    gxx = p[0];
    gxy = p[plane];
    gyy = p[2 * plane];
    for (int m = 1; m < wh; ++m) {
      const size_t o = (size_t)m * cols;
      gxx = gxx + p[o];
      gxy = gxy + p[plane + o];
      gyy = gyy + p[2 * plane + o];
    }
  }
  const float t = gxx - gyy;
  const float disc = t * t + 4.0f * gxy * gxy;
  const float lam = (gxx + gyy - sqrtf(disc)) / 2.0f;
  out[(size_t)y * cols + x] = fminf(lam, KLT_INT_LIMIT);
}

const dim3 kBlock(32, 8);

}  // namespace

// gx, gy: device f32 [rows, cols]; out: device f32 [rows, cols]; scratch:
// device f32 [3, rows, cols].  Returns cudaGetLastError() after the last
// launch (or the first failure).
extern "C" int klt_corner_response(const float* gx, const float* gy,
                                   int rows, int cols, int window_width,
                                   int window_height, float* out,
                                   float* scratch, void* stream) {
  if (rows < 1 || cols < 1 || window_width < 1 || window_height < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((cols + kBlock.x - 1) / kBlock.x,
                  (rows + kBlock.y - 1) / kBlock.y);
  cudaError_t err;
  hsum_products<<<grid, kBlock, 0, st>>>(gx, gy, rows, cols, window_width,
                                         scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  vsum_eigen<<<grid, kBlock, 0, st>>>(scratch, rows, cols, window_height, out);
  return (int)cudaGetLastError();
}
