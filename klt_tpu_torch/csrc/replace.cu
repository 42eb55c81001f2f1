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
// What bounds it on an H100: latency of a serial chain.  Each pick depends
// on the previous one's stamp, so the picks run one after another; what
// can be cut is the length of a link and everything around the chain.
//
// What the design does about it: a hierarchy of 32x32 tiles.
//   * First pass, one block of 256 threads per tile over the whole card:
//     the block filters the features whose square meets its tile into
//     shared memory, forms its 1024 masked cells (four a thread, no
//     division), kills those inside a listed square, writes them to the
//     map and reduces them to the tile's best (value, lowest flat index).
//     No block waits for another.
//   * The block that finishes last (a ticket: __threadfence, then one
//     atomicAdd per block) runs the greedy loop alone, with the tiles'
//     bests in its shared memory.  A pick is the argmax over those, the
//     stamp of its square, and a rescan by the whole block of only those
//     tiles the square meets whose best was killed, up to 2x2 tiles at a
//     time: their loads (one a thread per four rows of a tile, all leaving
//     before one is used; a cell inside the new square needs none), the
//     stamp's stores and the search for the next lost slot are under way
//     together, so a link of the chain is one trip to L2 and four
//     barriers, and the loop runs once per lost slot, never once more.
//     (One warp alone, with no barrier at all, was slower: a single warp
//     cannot issue fast enough.)
//   * A cell's position travels as (row << 16 | column): the order of the
//     flat index, without its division.  (value, position) with the lower
//     position winning at equal value is a total order, inside a tile and
//     across tiles, so the picks are those of an argmax over the flat map
//     whatever the tile size.
//   * A frame with no lost slot leaves every block at once, before any
//     ticket is taken: half of the frames of a tracking run.
// One launch, not a cooperative launch (its grid sync needs all blocks
// resident at once and would keep them spinning through the chain) and not
// two launches (the second would be paid on every frame, lost slot or
// not).
//
// The tie entry (klt_replace_lost_tie) is the same program with a count
// beside every best: it replaces the pick loop of klt_tpu/ops/
// replace_exact.py::replace_lost_features_exact (:186-244), which also
// reports whether at some pick more than one cell held the map's maximum
// (the one case in which the masked argmax and the reference's quicksort
// walk can choose differently).  A best carries how many cells hold its
// value (saturated at 2), and the argmax over the tiles' bests adds the
// counts of equal values, so a pick sees the map's count of its maximum.
// A stamp can kill a cell of a tile's best value while the best itself
// survives, so this entry scans again every live tile the square meets,
// not only those whose best it killed.  The counts cost a third shared
// array of bytes and a third value in each reduction; klt_replace_lost
// compiles without them.

#include <cuda_runtime.h>
#include <limits.h>

#define KLT_NOT_FOUND (-1)

namespace {

constexpr int kTile = 32;     // a tile is kTile x kTile cells; a warp is a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = kTile / kWarps;  // cells a thread: rows warp + 8*q
constexpr int kGroup = 4;               // tiles scanned again at a time: 2x2
// the greedy block keeps every tile's best in shared memory
constexpr int kMaxTiles = 25000;

// A cell's position as one int that orders like its flat index.
__device__ __forceinline__ int pack(int y, int x) { return (y << 16) | x; }

// (v, i) becomes the better of itself and (ov, oi): the larger value, the
// lower position on ties.
__device__ __forceinline__ void keep_best(int& v, int& i, int ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The same with c, how many cells hold v (saturated at 2): equal values
// add their counts.
__device__ __forceinline__ void keep_best(int& v, int& i, int& c, int ov,
                                          int oi, int oc) {
  if (ov == v) {
    c = min(c + oc, 2);
    if (oi < i) i = oi;
  } else if (ov > v) {
    v = ov;
    i = oi;
    c = oc;
  }
}

// Every thread of the warp ends with the warp's best (and its count, in
// the tie entry).
template <bool kTie>
__device__ __forceinline__ void warp_best(int& v, int& i, int& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if constexpr (kTie) {
      const int oc = __shfl_xor_sync(0xffffffffu, c, off);
      keep_best(v, i, c, ov, oi, oc);
    } else {
      keep_best(v, i, ov, oi);
    }
  }
}

// The block's best of one (v, i) per thread, in every thread.  s_v, s_i,
// s_c: kWarps ints each; ends with a barrier after the last read.
template <bool kTie>
__device__ __forceinline__ void block_best(int& v, int& i, int& c, int* s_v,
                                           int* s_i, int* s_c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best<kTie>(v, i, c);
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
    if constexpr (kTie) s_c[warp] = c;
  }
  __syncthreads();
  v = lane < kWarps ? s_v[lane] : -1;
  i = lane < kWarps ? s_i[lane] : INT_MAX;
  if constexpr (kTie) c = lane < kWarps ? s_c[lane] : 0;
  warp_best<kTie>(v, i, c);
  __syncthreads();
}

struct Args {
  const float* resp;
  int rows, cols;
  float* x;
  float* y;
  int* val;
  int n;
  int borderx, bordery, step, floor_v, stamp;
  int* map;      // [rows, cols]
  int* tile_v;   // [tiles_y * tiles_x] each tile's best value
  int* tile_i;   // and its packed position
  int* ticket;   // one int, 0 on entry and on exit
  int* tile_c;   // tie entry: how many cells hold the best (at most 2)
  int* tie;      // tie entry: one int, 1 if a pick's maximum was not unique
};

// Steps 1 and 2 on this block's tile, and the tile's best.
template <bool kTie>
__device__ __forceinline__ void build_tile(const Args& a, int* s_v, int* s_i,
                                           int* s_c, int* s_cx, int* s_cy,
                                           int* s_cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int px = tx0 + lane;

  // live features whose square meets the tile, a block's worth at a time
  bool killed[kCells] = {};
  for (int base = 0; base < a.n; base += kThreads) {
    const int f = base + tid;
    if (f < a.n && a.val[f] >= 0) {
      const int cx = (int)a.x[f], cy = (int)a.y[f];
      if (cx >= 0 && cx < a.cols && cy >= 0 && cy < a.rows &&
          cx >= tx0 - a.stamp && cx <= tx0 + kTile - 1 + a.stamp &&
          cy >= ty0 - a.stamp && cy <= ty0 + kTile - 1 + a.stamp) {
        const int k = atomicAdd(s_cnt, 1);
        s_cx[k] = cx;
        s_cy[k] = cy;
      }
    }
    __syncthreads();
    const int cnt = *s_cnt;
    for (int k = 0; k < cnt; ++k) {
      const bool in_x = abs(px - s_cx[k]) <= a.stamp;
#pragma unroll
      for (int q = 0; q < kCells; ++q)
        killed[q] |= in_x &&
                     abs(ty0 + warp + kWarps * q - s_cy[k]) <= a.stamp;
    }
    __syncthreads();
    if (tid == 0) *s_cnt = 0;
    __syncthreads();
  }

  int v = -1, i = INT_MAX, c = 0;  // rows in order: the first maximum
  const bool col_ok = px >= a.borderx && px < a.cols - a.borderx &&
                      (a.step == 1 || (px - a.borderx) % a.step == 0);
#pragma unroll
  for (int q = 0; q < kCells; ++q) {
    const int py = ty0 + warp + kWarps * q;
    if (px >= a.cols || py >= a.rows) continue;
    const int idx = py * a.cols + px;
    const bool ok = col_ok && !killed[q] && py >= a.bordery &&
                    py < a.rows - a.bordery &&
                    (a.step == 1 || (py - a.bordery) % a.step == 0);
    int m = -1;
    if (ok) {
      const int r = (int)a.resp[idx];  // C cast: truncation toward zero
      if (r >= a.floor_v) m = r;
    }
    a.map[idx] = m;
    if (m > v) {
      v = m;
      i = pack(py, px);
      c = 1;
    } else if (kTie && m == v) {
      c = min(c + 1, 2);
    }
  }
  block_best<kTie>(v, i, c, s_v, s_i, s_c);
  if (tid == 0) {
    const int t = blockIdx.y * gridDim.x + blockIdx.x;
    a.tile_v[t] = v;
    a.tile_i[t] = i;
    if constexpr (kTie) a.tile_c[t] = c;
  }
}

// The first lost slot at or after `from`, or n: a whole warp, 32 slots a
// step.
__device__ __forceinline__ int next_lost(const Args& a, int from) {
  const int lane = threadIdx.x & 31;
  for (int base = from & ~31; base < a.n; base += 32) {
    const int f = base + lane;
    const unsigned lost =
        __ballot_sync(0xffffffffu, f >= from && f < a.n && a.val[f] < 0);
    if (lost) return base + __ffs(lost) - 1;
  }
  return a.n;
}

// Steps 3 and 4, by one block, once every tile is built.  s_tile_v,
// s_tile_i: the tiles' bests, n_tiles ints each, s_tile_c (tie entry) their
// counts, n_tiles bytes; s_gv, s_gi, s_gc: kGroup * kWarps ints each.
template <bool kTie>
__device__ __forceinline__ void greedy_picks(const Args& a, int* s_v, int* s_i,
                                             int* s_c, int* s_gv, int* s_gi,
                                             int* s_gc, int* s_slot,
                                             int* s_tile_v, int* s_tile_i,
                                             unsigned char* s_tile_c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = gridDim.x, n_tiles = gridDim.x * gridDim.y;
  for (int t = tid; t < n_tiles; t += kThreads) {
    s_tile_v[t] = __ldcg(a.tile_v + t);
    s_tile_i[t] = __ldcg(a.tile_i + t);
    if constexpr (kTie) s_tile_c[t] = (unsigned char)__ldcg(a.tile_c + t);
  }
  int n_lost = 0;
  for (int base = 0; base < a.n; base += kThreads)
    n_lost += __syncthreads_count(base + tid < a.n && a.val[base + tid] < 0);
  if (warp == 0) {
    const int f = next_lost(a, 0);
    if (lane == 0) *s_slot = f;
  }
  __syncthreads();

  int tie = 0;  // thread 0's
  for (int pick = 0; pick < n_lost; ++pick) {
    // the best of the tiles' bests (with the map's count of its value)
    int bv = -1, bi = INT_MAX, bc = 0;
    for (int t = tid; t < n_tiles; t += kThreads) {
      if constexpr (kTie)
        keep_best(bv, bi, bc, s_tile_v[t], s_tile_i[t], s_tile_c[t]);
      else
        keep_best(bv, bi, s_tile_v[t], s_tile_i[t]);
    }
    block_best<kTie>(bv, bi, bc, s_v, s_i, s_c);
    if (bv < a.floor_v) break;
    if (kTie && bc > 1) tie = 1;

    const int py = bi >> 16, px = bi & 0xffff;
    int sl = 0;  // thread 0's
    if (tid == 0) {
      sl = *s_slot;
      a.x[sl] = (float)px;
      a.y[sl] = (float)py;
      a.val[sl] = bv;
    }
    // the pick's square, clipped to the map, and the tiles it meets
    const int x0 = max(px - a.stamp, 0), x1 = min(px + a.stamp, a.cols - 1);
    const int y0 = max(py - a.stamp, 0), y1 = min(py + a.stamp, a.rows - 1);
    const int t1x = x1 / kTile, t1y = y1 / kTile;
    bool stamped = false;
    for (int gy = y0 / kTile; gy <= t1y; gy += 2) {
      for (int gx = x0 / kTile; gx <= t1x; gx += 2) {
        // of these 2x2 tiles, scan again those whose best the square
        // kills (the tie entry: every live one): lane = column, rows in
        // order, so a column's first maximum is kept; a cell inside the
        // square is dead unread
        unsigned redo = 0;
        int cell[kGroup][kCells];  // all loads leave before one is used
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int ty = gy + (u >> 1), tx = gx + (u & 1);
          bool scan = ty <= t1y && tx <= t1x;
          if (scan) {
            const int old_v = s_tile_v[ty * tiles_x + tx];
            const int old_i = s_tile_i[ty * tiles_x + tx];
            const int oy = old_i >> 16, ox = old_i & 0xffff;
            // an empty tile stays empty, a live best the best
            if constexpr (kTie)
              scan = old_v >= 0;
            else
              scan = old_v >= 0 && ox >= x0 && ox <= x1 && oy >= y0 &&
                     oy <= y1;
          }
          redo |= (unsigned)scan << u;
          const int cx = tx * kTile + lane;
#pragma unroll
          for (int q = 0; q < kCells; ++q) {
            const int cy = ty * kTile + warp + kWarps * q;
            const bool dead = cx >= x0 && cx <= x1 && cy >= y0 && cy <= y1;
            cell[u][q] = scan && !dead && cx < a.cols && cy < a.rows
                             ? __ldcg(a.map + cy * a.cols + cx) : -1;
          }
        }
        if (!stamped) {
          // while those loads are under way: kill the square in the map
          // for later picks, and find the next lost slot
          stamped = true;
          for (int yy = y0 + warp; yy <= y1; yy += kWarps)
            for (int xx = x0 + lane; xx <= x1; xx += 32)
              a.map[yy * a.cols + xx] = -1;
          if (warp == 0) {
            const int f = next_lost(a, __shfl_sync(0xffffffffu, sl, 0) + 1);
            if (lane == 0) *s_slot = f;
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (!(redo >> u & 1)) continue;
          const int ty = gy + (u >> 1), cx = (gx + (u & 1)) * kTile + lane;
          int v = -1, i = INT_MAX, c = 0;
#pragma unroll
          for (int q = 0; q < kCells; ++q) {
            if (cell[u][q] > v) {
              v = cell[u][q];
              i = pack(ty * kTile + warp + kWarps * q, cx);
              c = 1;
            } else if (kTie && cell[u][q] == v) {
              c = min(c + 1, 2);
            }
          }
          warp_best<kTie>(v, i, c);
          if (lane == 0) {
            s_gv[u * kWarps + warp] = v;
            s_gi[u * kWarps + warp] = i;
            if constexpr (kTie) s_gc[u * kWarps + warp] = c;
          }
        }
        __syncthreads();
        if (warp < kGroup && (redo >> warp & 1)) {
          int rv = lane < kWarps ? s_gv[warp * kWarps + lane] : -1;
          int ri = lane < kWarps ? s_gi[warp * kWarps + lane] : INT_MAX;
          int rc = 0;
          if constexpr (kTie) rc = lane < kWarps ? s_gc[warp * kWarps + lane]
                                                 : 0;
          warp_best<kTie>(rv, ri, rc);
          if (lane == 0) {
            const int t = (gy + (warp >> 1)) * tiles_x + gx + (warp & 1);
            s_tile_v[t] = rv;
            s_tile_i[t] = ri;
            if constexpr (kTie) s_tile_c[t] = (unsigned char)rc;
          }
        }
        __syncthreads();
      }
    }
  }
  if (kTie && tid == 0) *a.tie = tie;

  // 4. what is still lost is NOT_FOUND at (-1, -1)
  for (int f = tid; f < a.n; f += kThreads) {
    if (a.val[f] < 0) {
      a.x[f] = -1.0f;
      a.y[f] = -1.0f;
      a.val[f] = KLT_NOT_FOUND;
    }
  }
}

template <bool kTie>
__global__ void __launch_bounds__(kThreads)
replace_lost(const __grid_constant__ Args a) {
  // greedy block: 2 * n_tiles ints, and in the tie entry n_tiles bytes
  extern __shared__ int s_tiles[];
  __shared__ int s_v[kWarps], s_i[kWarps], s_c[kTie ? kWarps : 1];
  __shared__ int s_gv[kGroup * kWarps], s_gi[kGroup * kWarps];
  __shared__ int s_gc[kTie ? kGroup * kWarps : 1];
  __shared__ int s_cx[kThreads], s_cy[kThreads];
  __shared__ int s_cnt, s_slot, s_last;
  const int tid = threadIdx.x;

  // the tie flag starts at 0, before any ticket (the greedy block, the
  // last to take one, writes the call's flag)
  if (kTie && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) *a.tie = 0;

  // 0. nothing lost, nothing to do (steps 3 and 4 touch lost slots only);
  // every block sees the same val, so all leave or none does
  int any_lost = 0;
  for (int f = tid; f < a.n; f += kThreads) any_lost |= a.val[f] < 0;
  if (tid == 0) s_cnt = 0;
  if (!__syncthreads_or(any_lost)) return;

  build_tile<kTie>(a, s_v, s_i, s_c, s_cx, s_cy, &s_cnt);

  // the last block to get here has every tile before it
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(a.ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) *a.ticket = 0;  // as the next call expects it

  const int n_tiles = gridDim.x * gridDim.y;
  greedy_picks<kTie>(a, s_v, s_i, s_c, s_gv, s_gi, s_gc, &s_slot, s_tiles,
                     s_tiles + n_tiles,
                     (unsigned char*)(s_tiles + 2 * n_tiles));
}

}  // namespace

// The side of a tile (the scratch holds two ints per tile after the map,
// three in the tie entry) and the most tiles a map may have.
extern "C" int klt_replace_tile() { return kTile; }
extern "C" int klt_replace_max_tiles() { return kMaxTiles; }

namespace {

template <bool kTie>
int launch_replace(const float* resp, int rows, int cols, float* x, float* y,
                   int* val, int n, int borderx, int bordery, int step,
                   int floor_v, int stamp, int* scratch, int* ticket,
                   int* tie, void* stream) {
  // a position is packed as row << 16 | column
  if (rows < 1 || cols < 1 || n < 0 || step < 1 || stamp < 0 ||
      rows > 0x7fff || cols > 0xffff || (kTie && !tie))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  if (grid.y > 65535 || (long)grid.x * grid.y > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  const int tiles = grid.x * grid.y;
  // a stamp wider than the map kills all of it: the same squares, and no
  // overflow in centre + stamp
  const int side = rows > cols ? rows : cols;
  if (stamp > side) stamp = side;
  const int per_tile = 2 * (int)sizeof(int) + (kTie ? 1 : 0);
  const size_t shared = (size_t)per_tile * tiles;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        replace_lost<kTie>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        per_tile * kMaxTiles);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t map = (size_t)rows * cols;
  Args a = {resp, rows, cols, x, y, val, n, borderx, bordery, step, floor_v,
            stamp, scratch, scratch + map, scratch + map + tiles, ticket,
            kTie ? scratch + map + 2 * tiles : nullptr, tie};
  replace_lost<kTie><<<grid, kThreads, shared, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// resp: device f32 [rows, cols]; x, y: device f32 [n]; val: device i32 [n],
// updated in place; scratch: device i32 [rows * cols + 2 * tiles], tiles =
// ceil(rows / 32) * ceil(cols / 32) <= klt_replace_max_tiles(), rows <= 32767,
// cols <= 65535; ticket: one
// device i32 that is 0 and that no other stream uses (the kernel leaves it
// 0).  Returns cudaGetLastError() after the launch.
extern "C" int klt_replace_lost(const float* resp, int rows, int cols,
                                float* x, float* y, int* val, int n,
                                int borderx, int bordery, int step,
                                int floor_v, int stamp, int* scratch,
                                int* ticket, void* stream) {
  return launch_replace<false>(resp, rows, cols, x, y, val, n, borderx,
                               bordery, step, floor_v, stamp, scratch, ticket,
                               nullptr, stream);
}

// The tie entry: klt_replace_lost's arguments with scratch device i32
// [rows * cols + 3 * tiles], and tie: one device i32 the call sets to 1 if
// at some pick more than one cell held the map's maximum, else 0.
extern "C" int klt_replace_lost_tie(const float* resp, int rows, int cols,
                                    float* x, float* y, int* val, int n,
                                    int borderx, int bordery, int step,
                                    int floor_v, int stamp, int* scratch,
                                    int* ticket, int* tie, void* stream) {
  return launch_replace<true>(resp, rows, cols, x, y, val, n, borderx,
                              bordery, step, floor_v, stamp, scratch, ticket,
                              tie, stream);
}
