// Kernel S: the candidate list of a selection and the lazy quicksort's
// large partitions, on the card that holds the response.
//
// Not a TPU kernel: klt_tpu builds the list and sorts it on the host, as
// the reference does (src/V1/selectGoodFeatures.c:394-424).  It replaces
// the O(n) head of the port's host selection chain: lazy_select.c's
// klt_candidate_list and the first partitions of klt_lazy_sort_begin /
// finalize_through, over the whole list, before the walk reads a few
// thousand of its rows.  The host resumes the sort from the state this
// leaves, on a prefix of the list (native.LazySort.resume).
//
// List entry (klt_select_list): a thread a row, the rows (x, y,
// (int)resp[y][x]) in klt_candidate_list's row-major order; (int) as
// truncate_value casts, toward zero in range and INT32_MIN for NaN and
// beyond int32 (the card's own cast gives 0 for NaN and saturates).  It
// also starts the state (int64 state[3 + 2 * cap], lazy_select.c's layout)
// with the one range [0, n) pending.
//
// Partition entry (klt_select_partitions): while a pending range meets rows
// [0, k0) and holds more than s_min rows, the leftmost such range is
// partitioned as klt_sort_points_desc partitions it: the middle row
// swapped to the front as the pivot P, then Hoare's loop.  That loop is a
// pairing: with L the positions of [1, n) whose value is <= P, ascending,
// and R those whose value is >= P, descending, it swaps L[k] and R[k] for
// every k below m, the number of leading k with L[k] < R[k], stops at j =
// R[m] where R[m] exists beyond L[m - 1] and at L[m - 1] otherwise (0 when
// m = 0), and swaps rows j and 0.  A position p of L is swapped exactly
// when more positions of R lie after it than of L before it, and its
// partner is R[#L before p]; likewise for R.  So a partition is a count
// pass, a scan and a swap pass, the same swaps as the host's loop.  The
// two sides go on the state's stack where finalize_through puts them; a
// partition that would leave more than cap ranges pending is left to the
// host, as are ranges after `rounds` partitions.
//
// What bounds it on an H100: neither bytes nor operations (a partition of
// the 255,744-row live list moves about 9 MB, 3 us at 3.35 TB/s), but the
// chain of dependent passes: each partition's scan needs its count pass,
// and the next partition's range needs the last one's pivot.  What the
// design does about it: one cooperative launch holds every partition, the
// passes separated by a grid barrier (a counter and a generation in
// scratch) instead of launches, with a block for each 2,048-row chunk of
// the first range, up to what the card holds at once; the range, pivot
// and counts live in device memory, so no host read sits between passes,
// and the launch is enqueued behind kernel D with no host wait.  Loads and
// stores of data that other blocks write go through L2 (ld.cg / st.cg):
// the L1 caches are not coherent across a barrier.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kListThreads = 256;
constexpr int kThreads = 256;
constexpr int kItems = 8;                     // rows a thread in a chunk
constexpr int kChunk = kThreads * kItems;     // 2,048 rows
constexpr int kWarps = kThreads / 32;
constexpr int kCtlInts = 16;
constexpr int kPadded = kChunk + (kChunk >> 5);  // the chunk, padded (pad)

// The partition entry's shared state, at the head of the scratch.
struct Ctl {
  unsigned int bar_count;  // blocks arrived at the grid barrier
  unsigned int bar_gen;    // barriers passed
  int m;                   // pairs swapped
  int l_last;              // L[m - 1], 0 when m = 0 (relative to lo)
  int r_next;              // R[m], -1 where R has no position m
  int slot;                // the range's entry in the state's stack
  int pivot;               // P
  int pad;
  long long lo, hi;        // the range partitioned; lo < 0: none
  long long pad2[2];
};
static_assert(sizeof(Ctl) == kCtlInts * 4, "Ctl is kCtlInts ints");

__device__ __forceinline__ int truncate_value(float v) {
  if (v >= -2147483648.0f && v < 2147483648.0f) return static_cast<int>(v);
  return INT_MIN;
}

__global__ void __launch_bounds__(kListThreads)
    list_kernel(const float* __restrict__ resp, int stride, int nx, int ny,
                int borderx, int bordery, int step, int* __restrict__ out,
                long long* __restrict__ state, int cap) {
  const long long n = static_cast<long long>(nx) * ny;
  const long long r =
      static_cast<long long>(blockIdx.x) * kListThreads + threadIdx.x;
  if (r == 0) {
    state[0] = cap;
    state[1] = n >= 2 ? 1 : 0;
    state[2] = n >= 2 ? 0 : n;
    if (n >= 2) {
      state[3] = 0;
      state[4] = n;
    }
  }
  if (r >= n) return;
  const int gy = static_cast<int>(r / nx);
  const int gx = static_cast<int>(r - static_cast<long long>(gy) * nx);
  const int x = borderx + gx * step;
  const int y = bordery + gy * step;
  out[3 * r] = x;
  out[3 * r + 1] = y;
  out[3 * r + 2] =
      truncate_value(resp[static_cast<long long>(y) * stride + x]);
}

// Every block of the cooperative launch waits here for all the others;
// what a block wrote before is visible to every block after.
__device__ void grid_sync(Ctl* ctl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &ctl->bar_gen;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(&ctl->bar_count, 1u) == gridDim.x - 1) {
      atomicExch(&ctl->bar_count, 0u);
      __threadfence();
      atomicAdd(&ctl->bar_gen, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ void swap_rows(int* rows, long long a, long long b) {
  if (a == b) return;
  int* ra = rows + 3 * a;
  int* rb = rows + 3 * b;
  const int a0 = __ldcg(ra), a1 = __ldcg(ra + 1), a2 = __ldcg(ra + 2);
  const int b0 = __ldcg(rb), b1 = __ldcg(rb + 1), b2 = __ldcg(rb + 2);
  __stcg(ra, b0);
  __stcg(ra + 1, b1);
  __stcg(ra + 2, b2);
  __stcg(rb, a0);
  __stcg(rb + 1, a1);
  __stcg(rb + 2, a2);
}

// One thread, between partitions: the last partition's pivot to its row j
// and its sides onto the stack in the place of its range (the right side
// below the left, as finalize_through leaves them), then the next range:
// the leftmost pending one that meets [0, k0) if it holds more than s_min
// rows and the stack has room for its two sides; its pivot to the front.
__device__ void finish_and_pick(int* rows, long long n, long long* state,
                                int k0, int s_min, bool finish, bool pick,
                                Ctl* ctl) {
  long long* ranges = state + 3;
  long long count = state[1];
  if (finish && __ldcg(&ctl->lo) >= 0) {
    const long long lo = __ldcg(&ctl->lo), hi = __ldcg(&ctl->hi);
    const int l_last = __ldcg(&ctl->l_last), r_next = __ldcg(&ctl->r_next);
    const long long j = lo + (r_next > l_last ? r_next : l_last);
    swap_rows(rows, j, lo);
    long long side[4];
    int a = 0;
    if (hi - (j + 1) >= 2) {
      side[2 * a] = j + 1;
      side[2 * a + 1] = hi;
      a++;
    }
    if (j - lo >= 2) {
      side[2 * a] = lo;
      side[2 * a + 1] = j;
      a++;
    }
    const long long slot = __ldcg(&ctl->slot);
    if (a == 0) {
      for (long long k = slot + 1; k < count; k++) {
        ranges[2 * (k - 1)] = ranges[2 * k];
        ranges[2 * (k - 1) + 1] = ranges[2 * k + 1];
      }
    } else if (a == 2) {
      for (long long k = count - 1; k > slot; k--) {
        ranges[2 * (k + 1)] = ranges[2 * k];
        ranges[2 * (k + 1) + 1] = ranges[2 * k + 1];
      }
    }
    for (int i = 0; i < a; i++) {
      ranges[2 * (slot + i)] = side[2 * i];
      ranges[2 * (slot + i) + 1] = side[2 * i + 1];
    }
    count += a - 1;
    state[1] = count;
    state[2] = count ? ranges[2 * (count - 1)] : n;
  }
  ctl->lo = -1;
  if (!pick) return;
  for (long long k = count - 1; k >= 0; k--) {  // leftmost first
    const long long lo = ranges[2 * k], hi = ranges[2 * k + 1];
    if (lo >= k0) return;
    if (hi - lo > s_min) {
      if (count + 1 > state[0]) return;  // no room: the host's
      swap_rows(rows, lo, lo + (hi - lo) / 2);
      ctl->lo = lo;
      ctl->hi = hi;
      ctl->slot = static_cast<int>(k);
      ctl->pivot = __ldcg(rows + 3 * lo + 2);
      ctl->m = 0;
      ctl->l_last = 0;
      ctl->r_next = -1;
      return;
    }
  }
}

// A block's sums of a and b (every thread gets them); red holds 2 *
// kWarps ints, free again when this returns.
__device__ __forceinline__ void block_sum2(int& a, int& b, int* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = b = 0;
  for (int w = 0; w < kWarps; w++) {
    a += red[w];
    b += red[kWarps + w];
  }
  __syncthreads();
}

// The block's exclusive prefix sums of a and b in thread order, and their
// totals; red holds 2 * kWarps ints, free again when this returns.
__device__ __forceinline__ void block_scan2(int& a, int& b, int& ta, int& tb,
                                            int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ia = a, ib = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int oa = __shfl_up_sync(0xffffffffu, ia, off);
    const int ob = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += oa;
      ib += ob;
    }
  }
  if (lane == 31) {
    red[warp] = ia;
    red[kWarps + warp] = ib;
  }
  __syncthreads();
  int wa = 0, wb = 0;
  ta = tb = 0;
  for (int w = 0; w < kWarps; w++) {
    if (w < warp) {
      wa += red[w];
      wb += red[kWarps + w];
    }
    ta += red[w];
    tb += red[kWarps + w];
  }
  __syncthreads();
  a = wa + ia - a;
  b = wb + ib - b;
}

// The chunk's rows in shared memory, a padded slot for every row so that
// a thread's kItems consecutive rows lie in distinct banks.
__device__ __forceinline__ int pad(int q) { return q + (q >> 5); }

__global__ void __launch_bounds__(kThreads)
    partition_kernel(int* rows, long long n, long long* state, int k0,
                     int s_min, int rounds, Ctl* ctl, int* cnt, int* lidx,
                     int* ridx) {
  __shared__ int vals[kPadded];
  __shared__ int red[2 * kWarps];
  const int t = threadIdx.x;
  for (int round = 0;; round++) {
    if (blockIdx.x == 0 && t == 0)
      finish_and_pick(rows, n, state, k0, s_min, round > 0, round < rounds,
                      ctl);
    grid_sync(ctl);
    const long long lo = __ldcg(&ctl->lo);
    if (lo < 0) return;
    const int len = static_cast<int>(__ldcg(&ctl->hi) - lo);
    const int pivot = __ldcg(&ctl->pivot);
    const int chunks = (len + kChunk - 1) / kChunk;
    const int* v = rows + 3 * lo + 2;  // row p's value at v[3 * p]

    // 1. each chunk's counts of L and R
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
      int le = 0, ge = 0;
      for (int i = 0; i < kItems; i++) {
        const int p = c * kChunk + i * kThreads + t;
        if (p >= 1 && p < len) {
          const int x = __ldcg(v + 3LL * p);
          le += x <= pivot;
          ge += x >= pivot;
        }
      }
      block_sum2(le, ge, red);
      if (t == 0) {
        __stcg(cnt + 2 * c, le);
        __stcg(cnt + 2 * c + 1, ge);
      }
    }
    grid_sync(ctl);

    // 2. each row's ranks: L's and R's positions of the pairs, and L[m-1],
    //    R[m] as the last swapped L and the last R left in place
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
      int le_before = 0, ge_after = 0;
      for (int k = t; k < chunks; k += kThreads) {
        if (k < c) le_before += __ldcg(cnt + 2 * k);
        if (k > c) ge_after += __ldcg(cnt + 2 * k + 1);
      }
      block_sum2(le_before, ge_after, red);
      const int base = c * kChunk;
      for (int i = 0; i < kItems; i++) {
        const int q = i * kThreads + t;
        const int p = base + q;
        vals[pad(q)] = p < len ? __ldcg(v + 3LL * p) : 0;
      }
      __syncthreads();
      unsigned int is_le = 0, is_ge = 0;
      int tle = 0, tge = 0;
      for (int i = 0; i < kItems; i++) {
        const int q = t * kItems + i;
        const int p = base + q;
        if (p >= 1 && p < len) {
          const int x = vals[pad(q)];
          if (x <= pivot) {
            is_le |= 1u << i;
            tle++;
          }
          if (x >= pivot) {
            is_ge |= 1u << i;
            tge++;
          }
        }
      }
      int total_le, total_ge;
      block_scan2(tle, tge, total_le, total_ge, red);
      int lb = le_before + tle;  // #L before the row
      int gi = tge;              // #R of the chunk up to the row
      int m = 0, l_last = 0, r_next = -1;
      for (int i = 0; i < kItems; i++) {
        const int p = base + t * kItems + i;
        const bool in_l = is_le >> i & 1u, in_r = is_ge >> i & 1u;
        gi += in_r;
        const int ga = ge_after + total_ge - gi;  // #R after the row
        if (in_l && ga > lb) {
          __stcg(lidx + lb, p);
          m++;
          l_last = p;
        }
        if (in_r) {
          if (lb > ga)
            __stcg(ridx + ga, p);
          else
            r_next = max(r_next, p);
        }
        lb += in_l;
      }
      for (int off = 16; off > 0; off >>= 1) {
        m += __shfl_xor_sync(0xffffffffu, m, off);
        l_last = max(l_last, __shfl_xor_sync(0xffffffffu, l_last, off));
        r_next = max(r_next, __shfl_xor_sync(0xffffffffu, r_next, off));
      }
      if ((t & 31) == 0) {
        if (m) {
          atomicAdd(&ctl->m, m);
          atomicMax(&ctl->l_last, l_last);
        }
        if (r_next >= 0) atomicMax(&ctl->r_next, r_next);
      }
      __syncthreads();  // vals is the next chunk's
    }
    grid_sync(ctl);

    // 3. the pairs' swaps: disjoint rows, in any order
    const int m = __ldcg(&ctl->m);
    for (int k = blockIdx.x * kThreads + t; k < m; k += gridDim.x * kThreads)
      swap_rows(rows, lo + __ldcg(lidx + k), lo + __ldcg(ridx + k));
    grid_sync(ctl);
  }
}

// Blocks of the partition entry that the card holds at once (cached per
// device), or 0 when the query fails.
int co_resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, partition_kernel,
                                                    kThreads, 0) !=
          cudaSuccess)
    return 0;
  cached[dev] = sms * per_sm;
  return cached[dev];
}

}  // namespace

extern "C" {

// The list of the nx x ny grid (x = borderx + step * i, y = bordery +
// step * j) of the f32 map resp (rows of `stride` floats) into out, int32
// [nx * ny, 3], and state (int64 [3 + 2 * cap]) started.
int klt_select_list(const float* resp, int stride, int nx, int ny,
                    int borderx, int bordery, int step, int* out,
                    long long* state, int cap, cudaStream_t stream) {
  const long long n = static_cast<long long>(nx) * ny;
  const long long blocks = n > 0 ? (n + kListThreads - 1) / kListThreads : 1;
  if (nx < 0 || ny < 0 || cap < 1 || blocks > INT_MAX)
    return cudaErrorInvalidValue;
  list_kernel<<<static_cast<unsigned int>(blocks), kListThreads, 0,
                stream>>>(resp, stride, nx, ny, borderx, bordery, step, out,
                          state, cap);
  return cudaGetLastError();
}

// Ints of scratch the partition entry needs for a list of n rows: the
// control block, two counts a chunk, and the pairs' positions.
long long klt_select_scratch_ints(long long n) {
  return kCtlInts + 2 * ((n + kChunk - 1) / kChunk) + 2 * (n / 2 + 1);
}

// The partitions of the n rows at `rows` from `state` (module comment).
// scratch: klt_select_scratch_ints(n) ints, zeroed before its first use
// (the grid barrier's counter; every call leaves it 0).
int klt_select_partitions(int* rows, long long n, long long* state, int k0,
                          int s_min, int rounds, int* scratch,
                          long long scratch_ints, cudaStream_t stream) {
  if (n < 0 || n > INT_MAX || s_min < 1 ||
      scratch_ints < klt_select_scratch_ints(n))
    return cudaErrorInvalidValue;
  const int most = co_resident_blocks();
  if (most < 1) return cudaErrorInvalidConfiguration;
  // one launch a call, also where no range is to be partitioned (the
  // kernel then stops at its first pick): the launch counts stay those of
  // the calls
  const long long chunks = (n + kChunk - 1) / kChunk;
  const int grid = static_cast<int>(chunks < 1 ? 1 : chunks < most ? chunks
                                                                    : most);
  Ctl* ctl = reinterpret_cast<Ctl*>(scratch);
  int* cnt = scratch + kCtlInts;
  int* lidx = cnt + 2 * chunks;
  int* ridx = lidx + (n / 2 + 1);
  void* args[] = {&rows, &n,      &state, &k0,  &s_min,
                  &rounds, &ctl, &cnt,   &lidx, &ridx};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)partition_kernel, dim3(grid), dim3(kThreads),
      args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
