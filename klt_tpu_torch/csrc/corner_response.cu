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
// 640x480 frame reads two 1.2 MB maps and writes the 1.2 MB response (about
// 1.1 us at the card's memory rate); the arithmetic is 3 products and
// 2 x 3 x 7 adds per pixel.  Every intermediate that goes through device
// memory adds as much again, every launch a few microseconds.
//
// What the design does about it: one launch, tiled in shared memory
// (klt_corner_response).  A block of 32x8 threads owns a tile of 32 x th
// outputs.  It loads the gx and gy pixels the tile needs, a halo of
// window_width - 1 columns and window_height - 1 rows included, forms the
// three products once per pixel into shared memory (pixels outside the
// image are zeros: they feed only outputs that are zeroed), writes the
// horizontal sums of the tile's rows and halo rows to shared memory, sums
// those vertically and evaluates the eigenvalue in registers.  No
// intermediate reaches device memory and there is no scratch.  In a tall
// tile (32 rows) a thread owns four consecutive output rows of a column and
// reads each horizontal sum once for the up to four outputs it feeds; tiles
// are tall when that still gives every SM two blocks and flat (8 rows,
// one output a thread) when not.  Each output keeps its own sequential
// chain of additions, and zeroing goes by global coordinates, so the tiling
// changes no bit.
//
// A window that no tile holds (wider than about 100x100) runs as two
// global-memory passes through a [3, H, W] scratch, one thread per pixel
// (klt_corner_response_global): the first design of this kernel, kept as
// pyramid.cu keeps its global-memory decimation.  The wrapper picks by
// klt_corner_response_tile.

#include <cuda_runtime.h>

#define KLT_INT_LIMIT 2147483583.0f  // rounds to the largest f32 below 2^31

namespace {

constexpr int kTileW = 32;       // outputs per tile row: a warp
constexpr int kThreadRows = 8;   // a block is kTileW x kThreadRows threads
constexpr int kTall = 32;        // output rows of a tall tile: 4 a thread
constexpr int kFlat = 8;         // and of a flat one: 1 a thread
constexpr int kMidW = kTileW + 1;  // row pitch of the horizontal sums
constexpr size_t kMaxShared = 227 * 1024;
constexpr size_t kDefaultShared = 48 * 1024;
// under this many blocks a launch leaves SMs of an H100 (132) idle while
// each block works through a tall tile: flat tiles then
constexpr int kMinBlocks = 264;
constexpr int kLoads = 4;  // loads of each map a thread has in flight

struct TileArgs {
  const float *gx, *gy;
  float* out;
  int rows, cols, ww, wh;
  int th;                // output rows per tile: kTall or kFlat
  int tiles_x;
  unsigned pitch_magic;  // idx / pitch == __umulhi(idx, pitch_magic)
};

__host__ __device__ __forceinline__ int in_height(int th, int wh) {
  return th + wh - 1;
}

// Row pitch of the product planes: odd, so that threads on consecutive rows
// hit different banks.
__host__ __device__ __forceinline__ int in_pitch(int ww) {
  return (kTileW + ww - 1) | 1;
}

__device__ __forceinline__ float min_eigenvalue(float gxx, float gxy,
                                                float gyy) {
  const float t = gxx - gyy;
  const float disc = t * t + 4.0f * gxy * gxy;
  const float lam = (gxx + gyy - sqrtf(disc)) / 2.0f;
  return fminf(lam, KLT_INT_LIMIT);
}

// sum_{m < n} q[m * step], added in that order from q[0].  W > 0 unrolls.
template <int W>
__device__ __forceinline__ float chain(const float* q, int n, int step) {
  float acc = q[0];
#pragma unroll
  for (int m = 1; m < (W > 0 ? W : n); ++m) acc = acc + q[m * step];
  return acc;
}

// The tile whose first output is (i0, j0).  prod: [3, ih, pitch] products
// of the gradients at rows i0 - ry .., columns j0 - rx ..; mid: [3, ih,
// kMidW] horizontal sums.  WW, WH > 0 unroll the sums of that width.
template <int WW, int WH>
__device__ __forceinline__ void response_tile(const TileArgs& a, int i0,
                                              int j0, float* prod,
                                              float* mid) {
  constexpr int kBlock = kTileW * kThreadRows;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int ww = WW > 0 ? WW : a.ww, wh = WH > 0 ? WH : a.wh;
  const int rx = ww / 2, ry = wh / 2;
  const int ih = in_height(a.th, wh), pitch = in_pitch(ww);
  const int plane = ih * pitch, n = plane;
  const int gy0 = i0 - ry, gx0 = j0 - rx;

  // the products, once per pixel; kLoads loads of each map in flight
  for (int base = tid; base < n; base += kBlock * kLoads) {
    float u[kLoads], v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int idx = base + k * kBlock;
      const int yy = (int)__umulhi((unsigned)idx, a.pitch_magic);
      const int y = gy0 + yy, x = gx0 + idx - yy * pitch;
      u[k] = 0.0f;
      v[k] = 0.0f;
      if (idx < n && (unsigned)y < (unsigned)a.rows &&
          (unsigned)x < (unsigned)a.cols) {
        u[k] = a.gx[y * a.cols + x];
        v[k] = a.gy[y * a.cols + x];
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int idx = base + k * kBlock;
      if (idx < n) {
        prod[idx] = u[k] * u[k];
        prod[plane + idx] = u[k] * v[k];
        prod[2 * plane + idx] = v[k] * v[k];
      }
    }
  }
  __syncthreads();

  // horizontal sums of every row of the tile and its halo, a thread per
  // column; zero where the column lies within rx of the image's edge
  const int x = j0 + tx;
  const bool inside = x >= rx && x < a.cols - rx;
  for (int yy = ty; yy < ih; yy += kThreadRows) {
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
    if (inside) {
      const float* q = prod + yy * pitch + tx;
      sxx = chain<WW>(q, ww, 1);
      sxy = chain<WW>(q + plane, ww, 1);
      syy = chain<WW>(q + 2 * plane, ww, 1);
    }
    mid[yy * kMidW + tx] = sxx;
    mid[(ih + yy) * kMidW + tx] = sxy;
    mid[(2 * ih + yy) * kMidW + tx] = syy;
  }
  __syncthreads();

  if (x >= a.cols) return;
  const float* col = mid + tx;
  const int mplane = ih * kMidW;
  if constexpr (WH > 0) {
    if (a.th == kTall) {
      // four consecutive rows a thread: each horizontal sum read once
      const int i = 4 * ty;
      if (i0 + i >= a.rows) return;
      float acc[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v[WH + 3];
#pragma unroll
        for (int u = 0; u < WH + 3; ++u)
          v[u] = col[k * mplane + (i + u) * kMidW];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[k][u] = v[u];
#pragma unroll
          for (int m = 1; m < WH; ++m) acc[k][u] = acc[k][u] + v[u + m];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int y = i0 + i + u;
        if (y >= a.rows) break;
        const bool in = y >= ry && y < a.rows - ry;
        a.out[(size_t)y * a.cols + x] =
            in ? min_eigenvalue(acc[0][u], acc[1][u], acc[2][u])
               : min_eigenvalue(0.0f, 0.0f, 0.0f);
      }
      return;
    }
  }
  for (int i = ty; i < a.th; i += kThreadRows) {
    const int y = i0 + i;
    if (y >= a.rows) break;
    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
    if (y >= ry && y < a.rows - ry) {
      const float* q = col + i * kMidW;
      gxx = chain<WH>(q, wh, kMidW);
      gxy = chain<WH>(q + mplane, wh, kMidW);
      gyy = chain<WH>(q + 2 * mplane, wh, kMidW);
    }
    a.out[(size_t)y * a.cols + x] = min_eigenvalue(gxx, gxy, gyy);
  }
}

// Grid x = tile index, row-major.  The unrolled instantiation is the default
// configuration's 7x7 window.
__global__ void __launch_bounds__(kTileW * kThreadRows)
response_tiles(const __grid_constant__ TileArgs a) {
  extern __shared__ float smem[];
  const int i0 = (blockIdx.x / a.tiles_x) * a.th;
  const int j0 = (blockIdx.x % a.tiles_x) * kTileW;
  const int ih = in_height(a.th, a.wh);
  float* prod = smem;                             // [3, ih, pitch]
  float* mid = smem + 3 * ih * in_pitch(a.ww);    // [3, ih, kMidW]
  if (a.ww == 7 && a.wh == 7)
    response_tile<7, 7>(a, i0, j0, prod, mid);
  else
    response_tile<0, 0>(a, i0, j0, prod, mid);
}

size_t shared_bytes(int ww, int wh, int th) {
  return 3 * (size_t)in_height(th, wh) * (in_pitch(ww) + kMidW) *
         sizeof(float);
}

// The tile height of a window: tall if its tile leaves room for several
// blocks on an SM, else flat if one block can hold it, else 0: no tile.
int tile_height(int ww, int wh) {
  if (ww < 1 || wh < 1 || ww > 4096 || wh > 4096) return 0;
  if (shared_bytes(ww, wh, kTall) <= kDefaultShared) return kTall;
  return shared_bytes(ww, wh, kFlat) <= kMaxShared ? kFlat : 0;
}

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
  out[(size_t)y * cols + x] = min_eigenvalue(gxx, gxy, gyy);
}

const dim3 kBlock(32, 8);

bool shape_ok(int rows, int cols, int ww, int wh) {
  return rows >= 1 && cols >= 1 && ww >= 1 && wh >= 1 &&
         (long)rows * cols <= 0x7fffffffL;
}

}  // namespace

// The output rows of a tile for this window (32 or 8), or 0 when no tile
// holds it and klt_corner_response_global is the entry to take.
extern "C" int klt_corner_response_tile(int window_width, int window_height) {
  return tile_height(window_width, window_height);
}

// The tiled entry: one launch, no scratch.  gx, gy: device f32 [rows,
// cols]; out: device f32 [rows, cols].  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a window that no tile holds.
extern "C" int klt_corner_response(const float* gx, const float* gy,
                                   int rows, int cols, int window_width,
                                   int window_height, float* out,
                                   void* stream) {
  if (!shape_ok(rows, cols, window_width, window_height))
    return (int)cudaErrorInvalidValue;
  TileArgs a;
  a.gx = gx;
  a.gy = gy;
  a.out = out;
  a.rows = rows;
  a.cols = cols;
  a.ww = window_width;
  a.wh = window_height;
  a.th = tile_height(window_width, window_height);
  if (a.th == 0) return (int)cudaErrorInvalidValue;
  a.tiles_x = (cols + kTileW - 1) / kTileW;
  const auto tiles = [&a] {
    return (long)a.tiles_x * ((a.rows + a.th - 1) / a.th);
  };
  if (a.th == kTall && tiles() < kMinBlocks) a.th = kFlat;
  if (tiles() > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // exact for idx < 2^16 (a plane of a tile has under 227 KB / 12 floats)
  a.pitch_magic = 0xffffffffu / (unsigned)in_pitch(a.ww) + 1;
  const size_t shared = shared_bytes(a.ww, a.wh, a.th);
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        response_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  response_tiles<<<(unsigned)tiles(), dim3(kTileW, kThreadRows), shared,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The global-memory entry, for any window: two launches through scratch,
// device f32 [3, rows, cols].  Returns cudaGetLastError() after the last
// launch (or the first failure).
extern "C" int klt_corner_response_global(const float* gx, const float* gy,
                                          int rows, int cols,
                                          int window_width, int window_height,
                                          float* out, float* scratch,
                                          void* stream) {
  if (!shape_ok(rows, cols, window_width, window_height) || !scratch)
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
