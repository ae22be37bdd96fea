// Whole-row run expansion for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel radix_sort_tpu/ops/expand.py:expand_join_runs
// (body _make_kernel) and the word-by-word call schedule around it: one
// launch moves every column of a join's or an UNNEST's output row.
// Contract:
//   in:  ends, n_runs int32: the inclusive prefix sum of the runs' emits
//        (non-decreasing; the callers clamp it at `capacity`);
//        lo and m_copy, n_runs int32 each, read only if a column is copied;
//        up to kMaxCols columns of 1, 2, 4 or 8 bytes, moved as raw bits:
//        a broadcast column holds one value per run, a copied column n_src
//        values.
//   out: per column `capacity` slots. Run r owns the slots
//        [ends[r-1], ends[r]) (ends[-1] = 0); its slot j gets b[r] from a
//        broadcast column, and c[lo[r] + j] for j < m_copy[r], else 0, from
//        a copied column. Slots at or past the total ends[n_runs-1] get
//        the column's own tail bits. count[0] = the total.
// Slots at or past `capacity` are never written, and the copy index is
// clamped into [0, n_src), so malformed runs cannot move the kernel
// outside its buffers.
//
// Design. The TPU kernel walks the runs in order on one core, staging and
// appending each run, because Mosaic has no vector scatter. Here a block
// owns a tile of kTile output slots and works out the run of each slot
// itself (a load-balanced search):
//   1. A cooperative search finds the run of the tile's first live slot:
//      every round the block's threads probe kThreads entries of `ends` at
//      once. The first round brackets the interpolated guess (slot x of
//      `total` is near run x * n_runs / total), so runs of even length take
//      2 rounds, and 15M runs at worst 4, instead of a chain of 24
//      dependent loads.
//   2. From there the block walks the runs, kWalkStep at a time with one
//      round of coalesced loads: every run that starts inside the tile and
//      emits marks its first slot in shared memory, and a block-wide
//      max-scan hands each slot its run (each thread scans 32 consecutive
//      entries; a pad word after every 32 keeps neighbouring threads on
//      distinct banks, so the scan has no bank conflicts). Zero-emit runs
//      share their start with the next run and never mark, the resolution
//      of the reference's expand_offsets. A walk past kWalk runs (a long
//      cluster of zero-emit runs, such as an inner join's unmatched left
//      rows) stops: a second search finds the tile's last run and each slot
//      its run by binary search between the two, so the cluster costs one
//      tile a few probes per slot, not a walk over the cluster.
//   3. A broadcast column is written with neighbouring threads on
//      neighbouring 16-byte groups of slots (4 slots of 4 bytes, 2 of 8,
//      ...), so every store is a full 16-byte vector. A copied column is
//      read and written with neighbouring threads on neighbouring slots,
//      so a warp's gather covers 32 neighbouring slots, a few contiguous
//      pieces of c[lo + j], and each thread issues several gathers before
//      its stores.
// Nothing is staged in device memory, pre-filled or masked afterwards, and
// the count stays on the device.
//
// Bound on an H100: bytes moved. Each output slot is written once at its
// column's width, each per-run value (ends, lo, m_copy, broadcast columns)
// and each copied value read once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;               // output slots per block
constexpr int kPer = kTile / kThreads;    // slots per thread
constexpr int kWalkStep = 4 * kThreads;   // runs one walk round reads
constexpr int kWalk = 2 * kTile;          // the most runs a tile walks
constexpr int kGather = 8;                // copied slots a thread loads before it stores
constexpr int kMaxCols = 16;

struct Cols {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  long long tail[kMaxCols];
  int width[kMaxCols];
  int copied[kMaxCols];
  int n;
};

// The first r in [l, h] with ends[r] > t; h if there is none.
__device__ __forceinline__ int first_after(const int32_t* __restrict__ ends, int l, int h,
                                           long long t) {
  while (l < h) {
    const int mid = l + ((h - l) >> 1);
    if (__ldg(ends + mid) > t) h = mid; else l = mid + 1;
  }
  return l;
}

// The first r in [lo, hi) with ends[r] > x (hi if none), by the whole
// block: each round every thread probes one entry and the range shrinks
// kThreads-fold. Block-uniform result.
__device__ int block_search(const int32_t* __restrict__ ends, int lo, int hi, long long x) {
  while (lo < hi) {
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const long long p = lo + (long long)(threadIdx.x + 1) * step - 1;
    // `below` is a prefix of the threads (ends is non-decreasing), so its
    // count k puts the answer past probe k-1 and at or before probe k
    const int k = __syncthreads_count(p < hi && __ldg(ends + p) <= x);
    const int probes = (hi - lo) / step;  // probes inside [lo, hi)
    const int l = lo + k * step;
    if (k < probes) hi = l + step - 1;
    lo = l;
  }
  return lo;
}

// The first r in [0, n) with ends[r] > x (x < total = ends[n-1]): one
// round of kThreads probes kGuessStride apart around the interpolated
// guess x * n / total, then a block search inside the bracket they find
// (over the whole range if the probes do not bracket the answer).
__device__ int guess_search(const int32_t* __restrict__ ends, int n, int total, long long x) {
  constexpr int kGuessStride = 8;
  const long long base = x * n / total - (long long)kThreads / 2 * kGuessStride;
  const long long p = base + (long long)threadIdx.x * kGuessStride;
  // probes before 0 count as at or below x, probes at or past n as above
  const int k = __syncthreads_count(p < n && (p < 0 || __ldg(ends + (p < 0 ? 0 : p)) <= x));
  const long long lo = base + (long long)(k - 1) * kGuessStride;  // last probe at or below x
  const long long hi = base + (long long)k * kGuessStride;        // first probe above x
  if (k == 0 || k == kThreads || lo < 0 || hi > n) return block_search(ends, 0, n, x);
  return block_search(ends, (int)lo + 1, (int)hi, x);
}

// s_run keeps one pad word after every 32 entries, so that the 32
// consecutive entries a thread scans lie on 32 distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
constexpr int kPadded = kTile + kTile / 32;
static_assert(kPer == 32, "a thread scans one padded row of 32 entries");

// Inclusive max-scan of the kTile entries of s in place (values >= 0):
// each thread takes the maximum of its kPer consecutive entries, the
// threads' maxima are scanned across the block, and each thread rescans
// its entries from the maximum before it.
__device__ void block_max_scan(int32_t* s) {
  __shared__ int32_t warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* mine = s + pad(threadIdx.x * kPer);  // kPer = 32: no pad word inside
  int m = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) m = max(m, mine[k]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, m, o);
    if (lane >= o) m = max(m, y);
  }
  if (lane == 31) warp_max[warp] = m;
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, m, 1);
  if (lane == 0) before = 0;
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int k = 0; k < kPer; ++k) mine[k] = before = max(before, mine[k]);
}

// The V run indices of slots s0 .. s0 + V - 1 (s0 a multiple of V, so no
// pad word lies between them).
template <int V>
__device__ __forceinline__ void load_group(const int32_t* s_run, int s0, int32_t (&out)[V]) {
  const int32_t* a = s_run + pad(s0);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = a[k];
}

// A broadcast column's slots [t0, t0 + n_slots): live slots (< n_live)
// get their run's value, the rest the tail bits; 16-byte groups.
template <typename T>
__device__ __forceinline__ void write_broadcast(const T* __restrict__ src,
                                                T* __restrict__ dst, T tail,
                                                const int32_t* s_run, long long t0,
                                                int n_live, int n_slots) {
  constexpr int V = 16 / sizeof(T);
  union Vec {
    uint4 u;
    T e[V];
  };
  for (int s0 = threadIdx.x * V; s0 < n_slots; s0 += kThreads * V) {
    Vec v;
    if (s0 < n_live) {
      int32_t idx[V];
      load_group<V>(s_run, s0, idx);
#pragma unroll
      for (int k = 0; k < V; ++k) v.e[k] = s0 + k < n_live ? __ldg(src + idx[k]) : tail;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v.e[k] = tail;
    }
    if (s0 + V <= n_slots) {
      *reinterpret_cast<uint4*>(dst + t0 + s0) = v.u;
    } else {
      for (int k = 0; s0 + k < n_slots; ++k) dst[t0 + s0 + k] = v.e[k];
    }
  }
}

// A copied column's slots [t0, t0 + n_slots): slot j of run r gets
// src[lo[r] + j] for j < m_copy[r], else 0; past n_live the tail bits.
// Neighbouring threads take neighbouring slots; each thread issues
// kGather gathers before it stores.
template <typename T>
__device__ __forceinline__ void write_copied(const T* __restrict__ src, T* __restrict__ dst,
                                             T tail, const int32_t* s_run,
                                             const int32_t* __restrict__ ends,
                                             const int32_t* __restrict__ lo,
                                             const int32_t* __restrict__ m_copy, int n_src,
                                             long long t0, int n_live, int n_slots) {
  for (int q0 = 0; q0 < kPer; q0 += kGather) {
    T x[kGather];
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int s = (q0 + k) * kThreads + threadIdx.x;
      x[k] = tail;
      if (s < n_live) {
        const int r = s_run[pad(s)];
        const long long j = t0 + s - (r > 0 ? __ldg(ends + r - 1) : 0);
        const int mc = __ldg(m_copy + r);
        long long c = __ldg(lo + r) + j;
        c = c < 0 ? 0 : (c >= n_src ? n_src - 1 : c);
        x[k] = j < mc ? __ldg(src + c) : T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int s = (q0 + k) * kThreads + threadIdx.x;
      if (s < n_slots) dst[t0 + s] = x[k];
    }
  }
}

template <typename T>
__device__ __forceinline__ void write_col(const Cols& cols, int k, const int32_t* s_run,
                                          const int32_t* ends, const int32_t* lo,
                                          const int32_t* m_copy, int n_src, long long t0,
                                          int n_live, int n_slots) {
  const T* src = static_cast<const T*>(cols.src[k]);
  T* dst = static_cast<T*>(cols.dst[k]);
  const T tail = (T)cols.tail[k];
  if (cols.copied[k])
    write_copied<T>(src, dst, tail, s_run, ends, lo, m_copy, n_src, t0, n_live, n_slots);
  else
    write_broadcast<T>(src, dst, tail, s_run, t0, n_live, n_slots);
}

__global__ void __launch_bounds__(kThreads)
expand_rows(const int32_t* __restrict__ ends, const int32_t* __restrict__ lo,
            const int32_t* __restrict__ m_copy, int n_runs, int n_src, Cols cols,
            int capacity, int32_t* __restrict__ count) {
  __shared__ __align__(16) int32_t s_run[kPadded];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int total = n_runs > 0 ? __ldg(ends + n_runs - 1) : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) count[0] = total;
  const long long live_end = min((long long)total, (long long)capacity);
  const int n_live = (int)max(0LL, min((long long)kTile, live_end - t0));
  const int n_slots = (int)max(0LL, min((long long)kTile, capacity - t0));

  if (n_live > 0) {
    const long long t_end = t0 + n_live;
    const int r_lo = guess_search(ends, n_runs, total, t0);
    for (int q = threadIdx.x; q < kPadded; q += kThreads) s_run[q] = r_lo;
    __syncthreads();
    // runs after r_lo that start inside the tile and emit mark their
    // first slot; a round goes on only while all of its runs start inside
    bool walked = true;
    for (int base = r_lo + 1;; base += kWalkStep) {
      if (base - r_lo > kWalk) {
        walked = false;
        break;
      }
      int inside = 1;
#pragma unroll
      for (int k = 0; k < kWalkStep / kThreads; ++k) {
        const int r = base + k * kThreads + threadIdx.x;
        int start = INT32_MAX, end = 0;
        if (r < n_runs) {
          start = __ldg(ends + r - 1);
          end = __ldg(ends + r);
        }
        if (start < t_end) {
          if (start < end) s_run[pad(start - t0)] = r;
        } else {
          inside = 0;
        }
      }
      if (!__syncthreads_and(inside)) break;
    }
    if (walked) {
      block_max_scan(s_run);
    } else {
      const int r_hi = block_search(ends, r_lo, n_runs, t_end - 1);
      for (int s = threadIdx.x; s < n_live; s += kThreads)
        s_run[pad(s)] = first_after(ends, r_lo, r_hi, t0 + s);
    }
    __syncthreads();
  }

  for (int k = 0; k < cols.n; ++k) {
    switch (cols.width[k]) {
      case 1:
        write_col<uint8_t>(cols, k, s_run, ends, lo, m_copy, n_src, t0, n_live, n_slots);
        break;
      case 2:
        write_col<uint16_t>(cols, k, s_run, ends, lo, m_copy, n_src, t0, n_live, n_slots);
        break;
      case 4:
        write_col<uint32_t>(cols, k, s_run, ends, lo, m_copy, n_src, t0, n_live, n_slots);
        break;
      default:
        write_col<unsigned long long>(cols, k, s_run, ends, lo, m_copy, n_src, t0, n_live,
                                      n_slots);
        break;
    }
  }
}

}  // namespace

// Columns per launch, for the wrapper's checks.
extern "C" int rst_expand_max_cols() { return kMaxCols; }

// Returns cudaGetLastError() after the launch (0 on success). srcs, dsts,
// tails, widths and copied describe n_cols columns; every dst must be
// 16-byte aligned; count is one int32. lo and m_copy may be null when no
// column is copied.
extern "C" int rst_expand_rows(const void* ends, const void* lo, const void* m_copy,
                               int n_runs, int n_src, void* const* srcs, void* const* dsts,
                               const long long* tails, const int* widths, const int* copied,
                               int n_cols, void* count, int capacity, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || capacity < 0 || n_runs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c = {};
  bool any_copied = false;
  for (int k = 0; k < n_cols; ++k) {
    const int w = widths[k];
    if (w != 1 && w != 2 && w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(dsts[k]) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    c.src[k] = srcs[k];
    c.dst[k] = dsts[k];
    c.tail[k] = tails[k];
    c.width[k] = w;
    c.copied[k] = copied[k] != 0;
    any_copied |= c.copied[k] != 0;
  }
  if (any_copied && n_runs > 0 && (lo == nullptr || m_copy == nullptr || n_src < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  c.n = n_cols;
  const int n_tiles = (int)(((long long)capacity + kTile - 1) / kTile);
  expand_rows<<<n_tiles > 0 ? n_tiles : 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ends), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(m_copy), n_runs, n_src, c, capacity,
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
