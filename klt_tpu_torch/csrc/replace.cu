// Kernel R: greedy lost-feature replacement from a corner-response map.
//
// Not a TPU kernel: it replaces the XLA while_loop of
// klt_tpu/ops/replace.py::replace_lost_features_device (:95-114), which
// klt_tpu keeps on the device inside its tracking scan.  Semantics of the
// reference's KLTReplaceLostFeatures (src/V1/selectGoodFeatures.c:514-541)
// as klt_tpu/ops/replace.py states them:
//   1. the masked int map: (int) of the response, truncated toward zero;
//      -1 outside [borderx, cols-borderx) x [bordery, rows-bordery), off
//      the n_skipped_pixels step grid, or under floor = max(1,
//      min_eigenvalue);
//   2. every live feature (val >= 0) kills the Chebyshev square of radius
//      stamp = max(mindist-1, 0) around ((int)x, (int)y), truncation
//      toward zero; a centre outside the map stamps nothing;
//   3. while a slot is lost (val < 0) and the map's maximum is >= floor:
//      the maximum, ties to the lowest flat index (jnp.argmax), fills the
//      first lost slot with (x, y, value) and kills its square;
//   4. every slot still lost becomes NOT_FOUND at (-1, -1), whatever its
//      tracking code was.
// x, y and val are updated in place; the host never learns how many slots
// were lost, so a frame loop that runs this after each track step never
// waits for the device.
//
// What bounds it on an H100: latency of a serial loop.  Each pick depends
// on the previous one's stamp, so the picks run one after another, and
// each scans the whole map (307,200 ints at 640x480, 300 loads a thread).
//
// What the design does about it: a frame with no lost slot returns at
// once; otherwise one block of 1024 threads does all of it, so steps are
// separated by __syncthreads and never by a launch or a host round trip;
// the argmax is a strided scan per thread (lowest index kept on ties), a
// warp shuffle reduction and one across the 32 warps.
// Compacting the candidates once, so that a pick scans only what is left,
// is left to a later change.

#include <cuda_runtime.h>

#define KLT_NOT_FOUND (-1)

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (v, i) becomes the better of itself and (ov, oi): the larger value, the
// lower index on ties.
__device__ __forceinline__ void keep_best(int& v, int& i, int ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_best(int& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    keep_best(v, i, ov, oi);
  }
}

// Kill the (2*stamp+1)^2 square around (cx, cy), clipped to the map;
// the block's threads share the cells.
__device__ __forceinline__ void stamp_square(int* map, int rows, int cols,
                                             int cx, int cy, int stamp) {
  const int side = 2 * stamp + 1;
  for (int c = threadIdx.x; c < side * side; c += blockDim.x) {
    const int px = cx - stamp + c % side, py = cy - stamp + c / side;
    if (px >= 0 && px < cols && py >= 0 && py < rows)
      map[(size_t)py * cols + px] = -1;
  }
}

__global__ void __launch_bounds__(kThreads)
replace_lost(const float* resp, int rows, int cols, float* x, float* y,
             int* val, int n, int borderx, int bordery, int step,
             int floor_v, int stamp, int* map) {
  __shared__ int s_v[kWarps], s_i[kWarps];
  __shared__ int s_slot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = rows * cols;

  // 0. nothing lost, nothing to do (steps 3 and 4 touch lost slots only)
  int any_lost = 0;
  for (int f = tid; f < n; f += blockDim.x) any_lost |= val[f] < 0;
  if (!__syncthreads_or(any_lost)) return;

  // 1. masked int map
  for (int i = tid; i < hw; i += blockDim.x) {
    const int yy = i / cols, xx = i - yy * cols;
    bool ok = yy >= bordery && yy < rows - bordery && xx >= borderx &&
              xx < cols - borderx;
    if (step > 1)
      ok = ok && (yy - bordery) % step == 0 && (xx - borderx) % step == 0;
    const int v = (int)resp[i];  // C cast: truncation toward zero
    map[i] = ok && v >= floor_v ? v : -1;
  }
  __syncthreads();

  // 2. live features' squares, one (feature, cell) pair per thread step
  const int side = 2 * stamp + 1, area = side * side;
  for (long j = tid; j < (long)n * area; j += blockDim.x) {
    const int f = (int)(j / area), c = (int)(j - (long)f * area);
    if (val[f] < 0) continue;
    const int cx = (int)x[f], cy = (int)y[f];
    if (cx < 0 || cx >= cols || cy < 0 || cy >= rows) continue;
    const int px = cx - stamp + c % side, py = cy - stamp + c / side;
    if (px >= 0 && px < cols && py >= 0 && py < rows)
      map[(size_t)py * cols + px] = -1;
  }
  __syncthreads();

  // 3. greedy picks
  int slot = 0;  // thread 0's walk over the slots, never backwards
  for (;;) {
    if (tid == 0) {
      while (slot < n && val[slot] >= 0) ++slot;
      s_slot = slot;
    }
    int bv = -1, bi = hw;
    for (int i = tid; i < hw; i += blockDim.x) {
      const int v = map[i];
      if (v > bv) {  // increasing i: the first maximum stays
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      s_v[warp] = bv;
      s_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_v[lane] : -1;
      bi = lane < kWarps ? s_i[lane] : hw;
      warp_best(bv, bi);
      if (lane == 0) {
        s_v[0] = bv;
        s_i[0] = bi;
      }
    }
    __syncthreads();
    const int best_v = s_v[0], best_i = s_i[0], sl = s_slot;
    __syncthreads();  // all have read before the next pick overwrites
    if (sl >= n || best_v < floor_v) break;
    const int py = best_i / cols, px = best_i - py * cols;
    if (tid == 0) {
      x[sl] = (float)px;
      y[sl] = (float)py;
      val[sl] = best_v;
    }
    stamp_square(map, rows, cols, px, py, stamp);
    __syncthreads();
  }

  // 4. what is still lost is NOT_FOUND at (-1, -1)
  for (int f = tid; f < n; f += blockDim.x) {
    if (val[f] < 0) {
      x[f] = -1.0f;
      y[f] = -1.0f;
      val[f] = KLT_NOT_FOUND;
    }
  }
}

}  // namespace

// resp: device f32 [rows, cols]; x, y: device f32 [n]; val: device i32 [n],
// updated in place; map: device i32 [rows, cols] scratch.  Returns
// cudaGetLastError() after the launch.
extern "C" int klt_replace_lost(const float* resp, int rows, int cols,
                                float* x, float* y, int* val, int n,
                                int borderx, int bordery, int step,
                                int floor_v, int stamp, int* map,
                                void* stream) {
  if (rows < 1 || cols < 1 || n < 0 || step < 1 || stamp < 0 ||
      (long)rows * cols > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  replace_lost<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      resp, rows, cols, x, y, val, n, borderx, bordery, step, floor_v, stamp,
      map);
  return (int)cudaGetLastError();
}
