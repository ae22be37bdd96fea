// Join-run expansion for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel radix_sort_tpu/ops/expand.py:expand_join_runs
// (body _make_kernel). Contract, identical to the reference's:
//   in:  rvs, n_r int32 words (right values in sorted-key order);
//        desc, n_runs rows of 8 int32 [kw, lw, lo, m_copy, m_emit, -, -, -];
//        end, the inclusive prefix sum of m_emit (int32, from the wrapper).
//   out: three int32 arrays of `capacity` words. Run r owns the slots
//        [end[r] - m_emit[r], end[r]); slot j of it gets kw and lw
//        broadcast and rv = rvs[lo + j] for j < m_copy, else 0. Slots at
//        or past the total end[n_runs-1] get the all-ones tail word.
//        count[0] = that total.
// Callers pre-clamp the emits so that the total is at most `capacity`;
// slots at or past `capacity` are never written, and the copy index is
// clamped into [0, n_r), so a malformed descriptor cannot move the kernel
// outside its buffers.
//
// Design. The TPU kernel walks the runs in order on one core, staging and
// appending each run, because Mosaic has no vector scatter. On a GPU every
// output slot can find its run on its own: slot t belongs to the first run
// whose end exceeds t (zero-emit runs share their end with the run before
// them, so they are never chosen -- the same resolution as the reference's
// expand_offsets). The search is cut in two so that it costs little:
//   1. tile_first_run: one thread per output tile of kTile slots finds the
//      tile's first run by binary search over all of `end`.
//   2. expand_runs: one block per tile; each thread finds the run of each
//      of its slots by binary search between its tile's first run and the
//      next tile's (a handful of L1-resident probes at any fanout), then
//      writes its three words.
// Neighbouring threads take neighbouring slots, so the three output
// streams are written in full 128-byte lines, and inside a run they read
// neighbouring words of rvs.
//
// Bound on an H100: bytes moved. Each output slot is written once (12
// bytes), each copied right value read once (4 bytes), each descriptor
// read once; nothing is staged or pre-filled. Carrying a whole wide row
// in one launch (instead of 2 broadcast + 1 copied word per call) is later
// work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // output slots per thread
constexpr int kTile = kThreads * kItems;
constexpr int kDescCols = 8;

// The first r in [l, h] with end[r] > t; h if there is none.
__device__ __forceinline__ int first_after(const int32_t* __restrict__ end, int l,
                                           int h, long long t) {
  while (l < h) {
    const int mid = l + ((h - l) >> 1);
    if (end[mid] > t) h = mid; else l = mid + 1;
  }
  return l;
}

__global__ void __launch_bounds__(kThreads)
tile_first_run(const int32_t* __restrict__ end, int n_runs, int n_tiles,
               int32_t* __restrict__ first, int32_t* __restrict__ count) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i > n_tiles) return;
  first[i] = n_runs > 0 ? first_after(end, 0, n_runs - 1, (long long)i * kTile) : 0;
  if (i == 0) count[0] = n_runs > 0 ? end[n_runs - 1] : 0;
}

__global__ void __launch_bounds__(kThreads)
expand_runs(const int32_t* __restrict__ rvs, int n_r,
            const int32_t* __restrict__ desc, const int32_t* __restrict__ end,
            int n_runs, const int32_t* __restrict__ first, int capacity,
            int32_t* __restrict__ ok, int32_t* __restrict__ ol,
            int32_t* __restrict__ orv) {
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long total = n_runs > 0 ? end[n_runs - 1] : 0;
  const int r_lo = first[blockIdx.x];
  const int r_hi = first[blockIdx.x + 1];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long t = t0 + k * kThreads + threadIdx.x;
    if (t >= capacity) return;
    if (t >= total) {
      ok[t] = -1;
      ol[t] = -1;
      orv[t] = -1;
      continue;
    }
    const int r = first_after(end, r_lo, r_hi, t);
    const int32_t* d = desc + (long long)r * kDescCols;
    const int4 head = __ldg(reinterpret_cast<const int4*>(d));  // kw, lw, lo, m_copy
    const long long j = t - (end[r] - __ldg(d + 4));
    int32_t v = 0;
    if (j < head.w) {
      long long s = (long long)head.z + j;
      s = s < 0 ? 0 : (s >= n_r ? n_r - 1 : s);
      v = __ldg(rvs + s);
    }
    ok[t] = head.x;
    ol[t] = head.y;
    orv[t] = v;
  }
}

}  // namespace

// Output slots per tile; the wrapper sizes the `first` scratch with it.
extern "C" int rst_expand_tile() { return kTile; }

// Returns cudaGetLastError() after the launches (0 on success). `first`
// is int32 scratch of n_tiles + 1 entries, n_tiles = ceil(capacity/kTile);
// `count` one int32. desc must be 16-byte aligned (row-major, 8 columns).
extern "C" int rst_expand_join_runs(const void* rvs, int n_r, const void* desc,
                                    const void* end, int n_runs, void* first,
                                    void* count, void* out_k, void* out_l,
                                    void* out_r, int capacity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (capacity + kTile - 1) / kTile;
  const int32_t* e = static_cast<const int32_t*>(end);
  int32_t* f = static_cast<int32_t*>(first);
  tile_first_run<<<n_tiles / kThreads + 1, kThreads, 0, s>>>(
      e, n_runs, n_tiles, f, static_cast<int32_t*>(count));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return static_cast<int>(err);
  expand_runs<<<n_tiles, kThreads, 0, s>>>(
      static_cast<const int32_t*>(rvs), n_r, static_cast<const int32_t*>(desc), e,
      n_runs, f, capacity, static_cast<int32_t*>(out_k),
      static_cast<int32_t*>(out_l), static_cast<int32_t*>(out_r));
  return static_cast<int>(cudaGetLastError());
}
