// Each equal-key run's value at its last row, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. merge_rank_pair (ops/query.py) needs, for every
// equal-key run of its union sort, the data count at the run's last row.
// The JAX package fills it backwards with a reversed running min, an XLA
// scan (radix_sort_tpu/ops/query.py merge_rank_pair); the port took a max
// per run with an atomic scatter, which sends every row of a run to one
// address, and atomics to one address serialise: a join's output padded to
// its capacity is one run of tens of millions of equal keys. The data count
// never decreases along the union, so a run's max is its value at its last
// row, and one plain store per run end gives the same int32.
// Contract:
//   in:  run_start, n bytes (bool): row i starts a run (row 0 does);
//        run_id, n int64: the run of row i (run_start's inclusive prefix
//        sum minus 1); values, n int32.
//   out: out[run_id[i]] = values[i] at every row i that ends a run, i.e.
//        i == n-1 or run_start[i+1]. No other entry of out is written, and
//        none outside [0, n) whatever run_id holds.
// Run ends are unique, so every entry is written once: no atomics, no
// contention whatever the run lengths, the same bits on every run.
//
// Design. Each thread reads 16 flags with one 16-byte load. Row i ends a
// run where flag i+1 is set, so a thread's last row takes the next lane's
// first flag by a shuffle (lane 31 loads it). A warp whose 512 rows hold
// no run end, the inside of a long run, stops there: 1 byte a row. Other
// warps walk their rows 32 at a time, neighbouring lanes on neighbouring
// rows, so the run_id and values loads at the run ends are coalesced, and
// each lane on a run end stores one int32 (neighbouring ends, neighbouring
// runs: the stores coalesce too).
//
// Bound on an H100: bytes moved. run_start is read once (1 byte a row),
// run_id and values at the run ends only (12 bytes a run), and out written
// once per run (4 bytes a run).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                // rows a thread: one 16-byte load of flags
constexpr int kWarpRows = 32 * kRows;    // rows a warp
constexpr long long kBlockRows = (long long)kThreads * kRows;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Bit j set where byte j of w is not zero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) m |= ((w >> (8 * j)) & 0xFFu) ? 1u << j : 0u;
  return m;
}

__global__ void __launch_bounds__(kThreads)
store_run_ends(const uint8_t* __restrict__ run_start, const int64_t* __restrict__ run_id,
               const int32_t* __restrict__ values, int32_t* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31;
  const long long warp_base =
      (long long)blockIdx.x * kBlockRows + (long long)(threadIdx.x >> 5) * kWarpRows;
  const long long base = warp_base + (long long)lane * kRows;
  // bit j: run_start[base + j] (0 past n)
  unsigned flags = 0;
  if (base + kRows <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(run_start + base));
    flags = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 | nonzero_bytes(v.z) << 8 |
            nonzero_bytes(v.w) << 12;
  } else {
    for (long long i = base; i < n; ++i) flags |= (run_start[i] ? 1u : 0u) << (i - base);
  }
  // run_start[base + kRows]: the next lane's first flag; lane 31 loads it
  unsigned next = __shfl_down_sync(kFull, flags & 1u, 1);
  if (lane == 31) next = (base + kRows < n && run_start[base + kRows]) ? 1u : 0u;
  // bit j: row base + j ends a run
  unsigned ends = flags >> 1 | next << (kRows - 1);
  if (base <= n - 1 && n - 1 < base + kRows) ends |= 1u << (n - 1 - base);
  if (!__any_sync(kFull, ends)) return;
  // row warp_base + 32k + lane is bit lane % 16 of lane 2k + lane / 16's ends
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const unsigned m = __shfl_sync(kFull, ends, 2 * k + (lane >> 4));
    if (m >> (lane & 15) & 1u) {
      const long long i = warp_base + 32LL * k + lane;
      const long long r = run_id[i];
      if (r >= 0 && r < n) out[r] = values[i];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). run_start must
// be 16-byte aligned; run_id, values and out hold n entries each.
extern "C" int rst_run_end_values(const void* run_start, const void* run_id, const void* values,
                                  void* out, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(run_start) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = (n + kBlockRows - 1) / kBlockRows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  store_run_ends<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(run_start), static_cast<const int64_t*>(run_id),
      static_cast<const int32_t*>(values), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
