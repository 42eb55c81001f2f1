// Kernel A: the whole Gaussian pyramid of one frame, and kernel E: the same
// for a batch of frames in one launch sequence.
//
// Kernel A replaces klt_tpu/pallas/pyramid.py::_fused_call (entry
// fused_build_pyramid_stacks), which builds everything in one VMEM-resident
// Pallas call; kernel E replaces klt_tpu/pallas/pyramid.py::
// _fused_call_batched (entry fused_build_pyramid_stacks_batched), the same
// program on [Bt, H, W] tiles.  Same semantics (reference
// src/V1/convolve.c:137-242 and src/V1/pyramid.c:87-131): u8 -> f32,
// pre-smoothing with smooth_sigma, then per level gradx = V(gauss) o
// H(deriv), grady = V(deriv) o H(gauss) and, below the coarsest level, the
// pyramid_sigma smoothing decimated at [ss/2 + ss*i]; taps applied
// reversed, output borders inside each kernel radius zeroed, the vertical
// pass reading the horizontally zeroed intermediate.  Every output pixel
// accumulates its taps in the sequential order acc = x[i-r]*t[w-1];
// acc = acc + x[i-r+m]*t[w-1-m], built with -fmad=false, so it rounds
// exactly like the plain torch version (ops/pyramid.py) and the host exact
// chain.
//
// What bounds it on an H100: device-memory traffic and launch latency, not
// arithmetic.  The outputs alone are 3 f32 maps a level (3.7 MB for a
// 640x480 frame); every horizontal intermediate that goes through device
// memory adds as much again, every launch a few microseconds, and the
// widest filter (the pyramid smoothing) is needed at one column and one
// row in `subsampling` only.
//
// What the design does about it: separable passes on tiles in shared
// memory, 1 + n_levels launches.
//   * One tile program serves every pass pair.  A block of 32x8 threads
//     owns 32 x th outputs; it loads the input pixels they need, halo
//     included, into shared memory once (u8 converted on the way; pixels
//     outside the image are never loaded, they feed only outputs that are
//     zeroed), runs the horizontal pass from shared memory into shared
//     memory at the columns its outputs use and the vertical pass from
//     there to the output.  No intermediate reaches device memory.
//   * Launch 1 is the pre-smoothing into level 0's intensity plane.  Then
//     one launch per level: the gradient program (two maps) on 32x32
//     tiles of the level, and in the same grid the decimating program,
//     which computes H(pyramid gauss) at the kept columns and V at the
//     kept rows only and writes contiguous rows of the next level.  Each
//     image's blocks lie together in the grid, so the two programs find
//     the level in L2.
//   * Bit equality comes from each output's own accumulation: the order
//     above, zeroing by global coordinates (x < r, x >= cols - r, y < r,
//     y >= rows - r, written as +0.0), not from the tiling.
//   * Tile heights are chosen from the taps (dynamic shared memory, up to
//     227 KB a block).  A decimating program that no tile holds (a large
//     `subsampling` with wide taps) runs as two global-memory passes, one
//     thread per output, through a one-plane scratch.
//
// Kernel E is the same launch sequence with the image index in the grid:
// B frames cost the launches of one, and every image runs the very code
// of kernel A, so its stacks are bit-equal to kernel A's.  The caller
// bounds memory by the frames it hands over per launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define KLT_MAX_TAPS 71  // MAX_KERNEL_WIDTH, src/V1/convolve.c:16

namespace {

constexpr int kTileW = 32;       // outputs per tile row: a warp
constexpr int kThreadRows = 8;   // a block is kTileW x kThreadRows threads
constexpr int kTall = 32;        // output rows of a tall tile: 4 a thread
constexpr int kFlat = 8;         // and of a flat one: 1 a thread
constexpr int kMidW = kTileW + 1;  // row pitch of the horizontal pass's output
constexpr size_t kMaxShared = 227 * 1024;
constexpr size_t kDefaultShared = 48 * 1024;
// under this many blocks a launch leaves SMs of an H100 (132) idle while
// each block works through a tall tile: flat tiles then
constexpr int kMinBlocks = 264;

struct TapSet {
  int n;
  float t[KLT_MAX_TAPS];
};

// One separable program on tiles of kTileW x th outputs:
// out[k][i][j] = V_k(H_k(in))[offset + stride*i][offset + stride*j].
struct TileProg {
  float* out[2];         // [batch] x [out_rows, out_cols], out_bstride apart
  size_t out_bstride;
  int out_rows, out_cols;
  int stride, offset;
  int th;                // output rows per tile: kTall or kFlat
  int rh, rv;            // the halo: the maps' largest horizontal / vertical radius
  int tiles_x, tiles;    // tiles per row, tiles per image
  unsigned pitch_magic;  // idx / in_pitch == __umulhi(idx, pitch_magic)
};

// The programs of one launch.  prog[0] is the gradient program if `grad`
// (gradx = V(taps[0]) o H(taps[1]), grady = V(taps[1]) o H(taps[0]):
// taps[0] the Gaussian, taps[1] its derivative), else a smoothing program
// as prog[1] always is: one map, V(taps[2]) o H(taps[2]).  The tap sets
// sit at fixed places so that a tap is an operand read from the kernel's
// arguments, not a load.  Strides between consecutive images of a batch
// are in elements.
struct LevelArgs {
  const void* in;  // [batch] x [rows, cols], u8 or f32
  int in_u8;
  size_t in_bstride;
  int rows, cols;
  int grad;
  int blocks_per_image;
  TapSet taps[3];
  TileProg prog[2];
};

__host__ __device__ __forceinline__ int in_height(int stride, int th, int rv) {
  return stride * (th - 1) + 1 + 2 * rv;
}

// Row pitch of the input tile: odd, so that threads on consecutive rows hit
// different banks.
__host__ __device__ __forceinline__ int in_pitch(int stride, int rh) {
  return (stride * (kTileW - 1) + 1 + 2 * rh) | 1;
}

// The input tile [ih, pitch] of image `src` with its first pixel at (gy0,
// gx0); pixels outside the image are zeros.  A thread has kLoads loads in
// flight before it stores the first: the latency of one, not of each (six
// cover a tall tile of the default configuration in one round).
constexpr int kLoads = 6;

template <typename T>
__device__ __forceinline__ void load_tile(const T* src, int rows, int cols,
                                          int gy0, int gx0, int ih, int pitch,
                                          unsigned pitch_magic, float* in) {
  constexpr int kBlock = kTileW * kThreadRows;
  const int tid = threadIdx.y * kTileW + threadIdx.x, n = ih * pitch;
  for (int base = tid; base < n; base += kBlock * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kBlock;
      const int yy = (int)__umulhi((unsigned)idx, pitch_magic);
      const int gy = gy0 + yy, gx = gx0 + idx - yy * pitch;
      v[u] = 0.0f;
      if (idx < n && (unsigned)gy < (unsigned)rows &&
          (unsigned)gx < (unsigned)cols)
        v[u] = (float)src[gy * cols + gx];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (base + u * kBlock < n) in[base + u * kBlock] = v[u];
  }
}

// The width of tap set TI: W at compile time, or taps[TI].n if W == 0.
template <int TI, int W>
__device__ __forceinline__ int width_of(const LevelArgs& a) {
  return W > 0 ? W : a.taps[TI].n;
}

// One output: acc = q[0]*t[w-1]; acc = acc + q[m*step]*t[w-1-m], m rising,
// t = taps[TI].  W > 0 unrolls the loop.
template <int TI, int W>
__device__ __forceinline__ float chain(const LevelArgs& a, const float* q,
                                       int step) {
  const int width = width_of<TI, W>(a);
  const float* t = a.taps[TI].t;
  float acc = q[0] * t[width - 1];
#pragma unroll
  for (int m = 1; m < width; ++m) acc = acc + q[m * step] * t[width - 1 - m];
  return acc;
}

// The vertical pass of map k with tap set TI of a tile, to the output:
// out[y][x] = V(mid_k)[row of output y][x], zero where the row lies within
// the radius of the image's edge.  In a tall tile of a program without
// decimation a thread owns four consecutive rows and reads each row of
// `mid` once for the up to four outputs it feeds.
template <int TI, int W>
__device__ __forceinline__ void vpass_tile(const LevelArgs& a,
                                           const TileProg& p, int k, size_t b,
                                           int i0, int j0, int ih,
                                           const float* mid) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int width = width_of<TI, W>(a), r = width / 2;
  const int oj = j0 + tx;
  if (oj >= p.out_cols) return;
  float* out = p.out[k] + b * p.out_bstride + oj;
  const float* col = mid + (k * ih + p.rv - r) * kMidW + tx;
  if constexpr (W > 0) {
    if (p.stride == 1 && p.th == kTall) {
      const int i = 4 * ty;
      if (i0 + i >= p.out_rows) return;
      const float* t = a.taps[TI].t;
      float v[W + 3], acc[4];
#pragma unroll
      for (int u = 0; u < W + 3; ++u) v[u] = col[(i + u) * kMidW];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[u] = v[u] * t[W - 1];
#pragma unroll
        for (int m = 1; m < W; ++m) acc[u] = acc[u] + v[u + m] * t[W - 1 - m];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gy = i0 + i + u;  // stride 1: an output's row is its input's
        if (gy < p.out_rows)
          out[(size_t)gy * p.out_cols] =
              gy >= r && gy < a.rows - r ? acc[u] : 0.0f;
      }
      return;
    }
  }
  for (int i = ty; i < p.th; i += kThreadRows) {
    const int oi = i0 + i;
    if (oi >= p.out_rows) break;
    const int gy = p.offset + p.stride * oi;
    out[(size_t)oi * p.out_cols] =
        gy >= r && gy < a.rows - r
            ? chain<TI, W>(a, col + p.stride * i * kMidW, kMidW) : 0.0f;
  }
}

// A smoothing program's tile: mid[y][j] = H(in)[y][column of output j],
// zero where the column lies within the radius of the image's edge, then
// the vertical pass.
template <int W>
__device__ __forceinline__ void smooth_tile(const LevelArgs& a,
                                            const TileProg& p, size_t b,
                                            int i0, int j0, int ih, int pitch,
                                            const float* in, float* mid) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = width_of<2, W>(a) / 2;
  if (p.stride == 1) {  // a thread per column
    const int gx = j0 + tx;
    const bool inside = gx >= r && gx < a.cols - r;
    for (int yy = ty; yy < ih; yy += kThreadRows)
      mid[yy * kMidW + tx] =
          inside ? chain<2, W>(a, in + yy * pitch + tx + p.rh - r, 1) : 0.0f;
  } else {
    // a thread per input row, a warp per kept column: threads of a warp
    // read rows an odd pitch apart instead of columns `stride` apart
    const int chunks = (ih + 31) / 32;
    for (int item = ty; item < chunks * kTileW; item += kThreadRows) {
      const int yy = (item / kTileW) * 32 + tx, j = item % kTileW;
      if (yy >= ih) continue;
      const int gx = p.offset + p.stride * (j0 + j);
      mid[yy * kMidW + j] =
          gx >= r && gx < a.cols - r
              ? chain<2, W>(a, in + yy * pitch + p.stride * j + p.rh - r, 1)
              : 0.0f;
    }
  }
  __syncthreads();
  vpass_tile<2, W>(a, p, 0, b, i0, j0, ih, mid);
}

// The gradient program's tile when both tap sets have one width (W, or
// taps[0].n if W == 0): H(deriv) and H(gauss) from the same reads.
template <int W>
__device__ __forceinline__ void grad_tile(const LevelArgs& a,
                                          const TileProg& p, size_t b, int i0,
                                          int j0, int ih, int pitch,
                                          const float* in, float* mid) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int width = width_of<0, W>(a), r = width / 2;
  const int gx = j0 + tx;
  const bool inside = gx >= r && gx < a.cols - r;
  const float* tg = a.taps[0].t;
  const float* td = a.taps[1].t;
  for (int yy = ty; yy < ih; yy += kThreadRows) {
    float hd = 0.0f, hg = 0.0f;
    if (inside) {
      const float* q = in + yy * pitch + tx + p.rh - r;
      float x = q[0];
      hd = x * td[width - 1];
      hg = x * tg[width - 1];
#pragma unroll
      for (int m = 1; m < width; ++m) {
        x = q[m];
        hd = hd + x * td[width - 1 - m];
        hg = hg + x * tg[width - 1 - m];
      }
    }
    mid[yy * kMidW + tx] = hd;
    mid[(ih + yy) * kMidW + tx] = hg;
  }
  __syncthreads();
  vpass_tile<0, W>(a, p, 0, b, i0, j0, ih, mid);  // gradx = V(gauss) H(deriv)
  vpass_tile<1, W>(a, p, 1, b, i0, j0, ih, mid);  // grady = V(deriv) H(gauss)
}

// The same when the Gaussian and its derivative have two widths.
__device__ __forceinline__ void grad_tile_two_widths(
    const LevelArgs& a, const TileProg& p, size_t b, int i0, int j0, int ih,
    int pitch, const float* in, float* mid) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int rg = a.taps[0].n / 2, rd = a.taps[1].n / 2;
  const int gx = j0 + tx;
  const bool in_d = gx >= rd && gx < a.cols - rd;
  const bool in_g = gx >= rg && gx < a.cols - rg;
  for (int yy = ty; yy < ih; yy += kThreadRows) {
    const float* q = in + yy * pitch + tx + p.rh;
    mid[yy * kMidW + tx] = in_d ? chain<1, 0>(a, q - rd, 1) : 0.0f;
    mid[(ih + yy) * kMidW + tx] = in_g ? chain<0, 0>(a, q - rg, 1) : 0.0f;
  }
  __syncthreads();
  vpass_tile<0, 0>(a, p, 0, b, i0, j0, ih, mid);
  vpass_tile<1, 0>(a, p, 1, b, i0, j0, ih, mid);
}

// Grid x = image * blocks_per_image + (the tiles of prog[0], then those of
// prog[1]).  The widths with an unrolled instantiation are those of the
// default configuration: smoothing 5, gradients 7 and 7, pyramid 21.
__global__ void __launch_bounds__(kTileW * kThreadRows)
pyramid_tiles(const __grid_constant__ LevelArgs a) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x / a.blocks_per_image;
  int t = blockIdx.x % a.blocks_per_image;
  int which = 0;
  if (t >= a.prog[0].tiles) {
    t -= a.prog[0].tiles;
    which = 1;
  }
  const TileProg& p = a.prog[which];
  const int i0 = (t / p.tiles_x) * p.th, j0 = (t % p.tiles_x) * kTileW;
  const int ih = in_height(p.stride, p.th, p.rv);
  const int pitch = in_pitch(p.stride, p.rh);
  // global coordinates of the input tile's first pixel
  const int gy0 = p.offset + p.stride * i0 - p.rv;
  const int gx0 = p.offset + p.stride * j0 - p.rh;
  float* in = smem;                // [ih, pitch]
  float* mid = smem + ih * pitch;  // [maps, ih, kMidW]

  if (a.in_u8)
    load_tile((const uint8_t*)a.in + b * a.in_bstride, a.rows, a.cols, gy0,
              gx0, ih, pitch, p.pitch_magic, in);
  else
    load_tile((const float*)a.in + b * a.in_bstride, a.rows, a.cols, gy0,
              gx0, ih, pitch, p.pitch_magic, in);
  __syncthreads();

  if (a.grad && which == 0) {
    if (a.taps[0].n != a.taps[1].n)
      grad_tile_two_widths(a, p, b, i0, j0, ih, pitch, in, mid);
    else if (a.taps[0].n == 7)
      grad_tile<7>(a, p, b, i0, j0, ih, pitch, in, mid);
    else
      grad_tile<0>(a, p, b, i0, j0, ih, pitch, in, mid);
  } else if (a.taps[2].n == 5) {
    smooth_tile<5>(a, p, b, i0, j0, ih, pitch, in, mid);
  } else if (a.taps[2].n == 21) {
    smooth_tile<21>(a, p, b, i0, j0, ih, pitch, in, mid);
  } else {
    smooth_tile<0>(a, p, b, i0, j0, ih, pitch, in, mid);
  }
}

// The global-memory passes, one thread per output pixel, for a decimating
// program that fits no tile.
struct GlobalArgs {
  const float* in;
  float* out;
  size_t in_bstride, out_bstride;
  int batch, rows, cols;      // of the input
  int out_rows, out_cols;
  int stride, offset;
  TapSet taps;
};

// out[y][x] = H(in)[y][x], every pixel of the input.
__global__ void hpass_global(const __grid_constant__ GlobalArgs a) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)a.rows * a.cols;
  if (idx >= plane * a.batch) return;
  const size_t b = idx / plane, rest = idx % plane;
  const int x = (int)(rest % a.cols);
  const int width = a.taps.n, r = width / 2;
  float acc = 0.0f;
  if (x >= r && x < a.cols - r) {
    const float* q = a.in + b * a.in_bstride + rest - r;
    acc = q[0] * a.taps.t[width - 1];
    for (int m = 1; m < width; ++m)
      acc = acc + q[m] * a.taps.t[width - 1 - m];
  }
  a.out[b * a.out_bstride + rest] = acc;
}

// out[i][j] = V(in)[offset + stride*i][offset + stride*j].
__global__ void vpass_global(const __grid_constant__ GlobalArgs a) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)a.out_rows * a.out_cols;
  if (idx >= plane * a.batch) return;
  const size_t b = idx / plane, rest = idx % plane;
  const int y = a.offset + a.stride * (int)(rest / a.out_cols);
  const int x = a.offset + a.stride * (int)(rest % a.out_cols);
  const int width = a.taps.n, r = width / 2;
  float acc = 0.0f;
  if (y >= r && y < a.rows - r) {
    const float* q = a.in + b * a.in_bstride + (size_t)(y - r) * a.cols + x;
    acc = q[0] * a.taps.t[width - 1];
    for (int m = 1; m < width; ++m)
      acc = acc + q[(size_t)m * a.cols] * a.taps.t[width - 1 - m];
  }
  a.out[b * a.out_bstride + rest] = acc;
}

void set_taps(TapSet* ts, const float* taps, int n) {
  ts->n = n;
  for (int i = 0; i < n; ++i) ts->t[i] = taps[i];
}

size_t shared_bytes(int nmaps, int stride, int rh, int rv, int th) {
  const size_t ih = in_height(stride, th, rv);
  return ih * (in_pitch(stride, rh) + nmaps * kMidW) * sizeof(float);
}

// The tile height of a program: tall if its tile leaves room for several
// blocks on an SM, else flat if one block can hold it, else 0: no tile.
int tile_height(int nmaps, int stride, int rh, int rv) {
  if (shared_bytes(nmaps, stride, rh, rv, kTall) <= kDefaultShared)
    return kTall;
  return shared_bytes(nmaps, stride, rh, rv, kFlat) <= kMaxShared ? kFlat : 0;
}

// Fills in the tiling of a program of `nmaps` maps with halo (rh, rv);
// false if no tile holds it.
bool plan(TileProg* p, int nmaps, int rh, int rv, int batch) {
  p->rh = rh;
  p->rv = rv;
  p->th = tile_height(nmaps, p->stride, rh, rv);
  if (p->th == 0) return false;
  p->tiles_x = (p->out_cols + kTileW - 1) / kTileW;
  const auto tiles = [p] {
    return p->tiles_x * ((p->out_rows + p->th - 1) / p->th);
  };
  if (p->th == kTall && (long)tiles() * batch < kMinBlocks) p->th = kFlat;
  p->tiles = tiles();
  // exact for idx < 2^16 (a tile has under 227 KB / 4 floats)
  p->pitch_magic = 0xffffffffu / (unsigned)in_pitch(p->stride, rh) + 1;
  return true;
}

// Launches the programs of `a`: prog[0] and, if n_progs is 2, prog[1].
int launch_tiles(LevelArgs* a, int n_progs, int batch, cudaStream_t st) {
  size_t shared = 0;
  a->blocks_per_image = 0;
  for (int k = 0; k < n_progs; ++k) {
    const TileProg& p = a->prog[k];
    const size_t need =
        shared_bytes(a->grad && k == 0 ? 2 : 1, p.stride, p.rh, p.rv, p.th);
    if (need > shared) shared = need;
    a->blocks_per_image += p.tiles;
  }
  if ((size_t)a->blocks_per_image * batch > 0x7fffffffUL)
    return (int)cudaErrorInvalidValue;
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  pyramid_tiles<<<a->blocks_per_image * batch, dim3(kTileW, kThreadRows),
                  shared, st>>>(*a);
  return (int)cudaGetLastError();
}

// The launch sequence of kernels A and E: `batch` images [rows, cols]
// (u8 or f32, contiguous), level outputs [batch, 3, H_l, W_l], scratch
// [batch, rows, cols] or null (see klt_pyramid_needs_scratch).
int build_pyramid(const void* img, int img_is_u8, int batch, int rows,
                  int cols, int n_levels, int ss, const float* g_smooth,
                  int n_smooth, const float* g_grad, int n_grad,
                  const float* d_grad, int n_dgrad, const float* g_pyr,
                  int n_pyr, float* const* levels, float* scratch,
                  cudaStream_t st) {
  if (n_smooth > KLT_MAX_TAPS || n_grad > KLT_MAX_TAPS ||
      n_dgrad > KLT_MAX_TAPS || n_pyr > KLT_MAX_TAPS || n_smooth < 1 ||
      n_grad < 1 || n_dgrad < 1 || n_pyr < 1 || n_levels < 1 || ss < 1 ||
      batch < 1 || rows < 1 || cols < 1 || (long)rows * cols > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  int err;

  // pre-smoothing: V(g_smooth) o H(g_smooth) of the raw frame into level
  // 0's intensity plane
  LevelArgs a = {};
  a.in = img;
  a.in_u8 = img_is_u8;
  a.in_bstride = (size_t)rows * cols;
  a.rows = rows;
  a.cols = cols;
  set_taps(&a.taps[2], g_smooth, n_smooth);
  TileProg* p = &a.prog[0];
  p->out[0] = levels[0];
  p->out_bstride = 3 * (size_t)rows * cols;
  p->out_rows = rows;
  p->out_cols = cols;
  p->stride = 1;
  if (!plan(p, 1, n_smooth / 2, n_smooth / 2, batch))
    return (int)cudaErrorInvalidValue;
  if ((err = launch_tiles(&a, 1, batch, st)) != 0) return err;

  const int r_grad = (n_grad > n_dgrad ? n_grad : n_dgrad) / 2;
  int lr = rows, lc = cols;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const bool last = lvl == n_levels - 1;
    const size_t plane = (size_t)lr * lc;
    float* lev = levels[lvl];

    a = LevelArgs{};
    a.in = lev;
    a.in_bstride = 3 * plane;
    a.rows = lr;
    a.cols = lc;
    a.grad = 1;
    set_taps(&a.taps[0], g_grad, n_grad);
    set_taps(&a.taps[1], d_grad, n_dgrad);
    set_taps(&a.taps[2], g_pyr, n_pyr);
    p = &a.prog[0];
    p->out[0] = lev + plane;
    p->out[1] = lev + 2 * plane;
    p->out_bstride = 3 * plane;
    p->out_rows = lr;
    p->out_cols = lc;
    p->stride = 1;
    if (!plan(p, 2, r_grad, r_grad, batch)) return (int)cudaErrorInvalidValue;
    int n_progs = 1;
    bool decimate_global = false;
    if (!last) {
      // next level = V(pyramid gauss) o H(pyramid gauss), read at
      // [ss/2 + ss*i], cut to the integer-divided level shape
      p = &a.prog[1];
      p->out[0] = levels[lvl + 1];
      p->out_rows = lr / ss;
      p->out_cols = lc / ss;
      p->out_bstride = 3 * (size_t)p->out_rows * p->out_cols;
      p->stride = ss;
      p->offset = ss / 2;
      if (plan(p, 1, n_pyr / 2, n_pyr / 2, batch))
        n_progs = 2;
      else
        decimate_global = true;
    }
    if ((err = launch_tiles(&a, n_progs, batch, st)) != 0) return err;

    if (decimate_global) {
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      GlobalArgs g = {};
      g.in = lev;
      g.out = scratch;
      g.in_bstride = 3 * plane;
      g.out_bstride = plane;
      g.batch = batch;
      g.rows = lr;
      g.cols = lc;
      set_taps(&g.taps, g_pyr, n_pyr);
      size_t blocks = (plane * batch + 255) / 256;
      if (blocks > 0x7fffffffUL) return (int)cudaErrorInvalidValue;
      hpass_global<<<(unsigned)blocks, 256, 0, st>>>(g);
      if ((err = (int)cudaGetLastError()) != 0) return err;
      g.in = scratch;
      g.in_bstride = plane;
      g.out = levels[lvl + 1];
      g.out_rows = lr / ss;
      g.out_cols = lc / ss;
      g.out_bstride = 3 * (size_t)g.out_rows * g.out_cols;
      g.stride = ss;
      g.offset = ss / 2;
      blocks = ((size_t)g.out_rows * g.out_cols * batch + 255) / 256;
      vpass_global<<<(unsigned)blocks, 256, 0, st>>>(g);
      if ((err = (int)cudaGetLastError()) != 0) return err;
    }
    lr /= ss;
    lc /= ss;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* klt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// 1 if a pyramid with these taps needs the scratch plane: more than one
// level, and a decimating program that no tile holds.
extern "C" int klt_pyramid_needs_scratch(int n_levels, int ss, int n_pyr) {
  return n_levels > 1 && tile_height(1, ss, n_pyr / 2, n_pyr / 2) == 0;
}

// Kernel A: builds n_levels stacks [3, H_l, W_l] (intensity, gradx, grady).
// img: device u8 or f32 [rows, cols]; taps: host arrays; levels: host array
// of n_levels device pointers; scratch: device f32 [rows, cols], or null
// when klt_pyramid_needs_scratch is 0.  Returns cudaGetLastError() after
// the last launch (or the first failure).
extern "C" int klt_build_pyramid(const void* img, int img_is_u8, int rows,
                                 int cols, int n_levels, int ss,
                                 const float* g_smooth, int n_smooth,
                                 const float* g_grad, int n_grad,
                                 const float* d_grad, int n_dgrad,
                                 const float* g_pyr, int n_pyr,
                                 float* const* levels, float* scratch,
                                 void* stream) {
  return build_pyramid(img, img_is_u8, 1, rows, cols, n_levels, ss, g_smooth,
                       n_smooth, g_grad, n_grad, d_grad, n_dgrad, g_pyr,
                       n_pyr, levels, scratch, (cudaStream_t)stream);
}

// Kernel E: the same for `batch` frames.  imgs: device u8 or f32
// [batch, rows, cols]; levels: n_levels device pointers to
// [batch, 3, H_l, W_l]; scratch: device f32 [batch, rows, cols] or null.
extern "C" int klt_build_pyramid_batched(const void* imgs, int img_is_u8,
                                         int batch, int rows, int cols,
                                         int n_levels, int ss,
                                         const float* g_smooth, int n_smooth,
                                         const float* g_grad, int n_grad,
                                         const float* d_grad, int n_dgrad,
                                         const float* g_pyr, int n_pyr,
                                         float* const* levels,
                                         float* scratch, void* stream) {
  return build_pyramid(imgs, img_is_u8, batch, rows, cols, n_levels, ss,
                       g_smooth, n_smooth, g_grad, n_grad, d_grad, n_dgrad,
                       g_pyr, n_pyr, levels, scratch, (cudaStream_t)stream);
}
