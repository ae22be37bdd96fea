// Stable run scatter ("bucket extraction") for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel radix_sort_tpu/ops/extract.py:bucket_extract
// (body _make_kernel). Contract, identical to the reference's:
//   in:  nops int32 operands, each nchunks chunks of m words; chunk c is
//        grouped so that bucket d's run is [bounds[c,d], bounds[c,d+1]),
//        with 0 <= bounds[c,0] <= ... <= bounds[c,K] <= m.
//   out: per operand nbuckets*K regions of cap words; region (b, d) holds
//        bucket d's runs from parent region b's cpb chunks, concatenated in
//        chunk order (stable), then the sentinel up to cap. counts[b*K+d] =
//        that run total, uncapped: a count above cap is the caller's
//        overflow flag.
// Every output word is written once, by this kernel: nothing is pre-filled.
//
// Design. The TPU kernel's order comes from its sequential grid; blocks on
// a GPU run in no order, so order comes from offsets instead:
//   1. tile_totals and region_offsets: the chunks of each parent region are
//      cut into tiles of kScanTile chunks, one block each. A tile's bounds
//      rows are read once, coalesced, and summed per bucket (tile_totals);
//      then each block adds the totals of the tiles before it to its own
//      running sums and writes each run's destination offset, and the last
//      tile the region's count (region_offsets). Every block works at once,
//      where one block per region used to walk all of its chunks.
//   2. scatter_runs: one launch, one block per chunk plus fill blocks.
//      The fill blocks tile the whole output, kFillWords words each, and
//      write the sentinel at or past each region's count; a fill block
//      inside one region's live prefix exits at once, so the compactor's
//      long tail (one region) is spread over many blocks, and the tails are
//      written while the runs are scattered. In a chunk's block, every run
//      that holds words marks its first word in shared memory, and a
//      block-wide max-scan hands each word of the chunk its run (chunks of
//      a power of two up to kScanWords words; others search the bounds per
//      word, and K = 1 needs neither). The scan is free of bank conflicts:
//      each thread scans its own consecutive entries, and a pad word after
//      every 32 puts those of neighbouring threads on distinct banks. Each
//      thread loads U words of every operand before it stores any, and
//      writes word j to out[(b*K+d)*cap + off[c,d] + (j - bounds[c,d])].
//      Neighbouring threads read neighbouring words and, inside a run,
//      write neighbouring words, so every warp access is one contiguous
//      128-byte span.
// Writes at or past the region's capacity (or before its start) are
// dropped, so the kernel never writes outside its own region. The TPU
// kernel instead clamps its last quantum onto the region; the contents of
// an overflowed region are discarded by the caller either way.
//
// Bound on an H100: bytes moved. Every valid word is read once and every
// output word written once (valid words and sentinels), plus (K+1) bounds
// read per chunk; the design keeps the traffic at that floor with
// coalesced accesses and no staging.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxOps = 8;
constexpr int kThreads = 256;
constexpr int kScanTile = 64;     // chunks per scan block
constexpr int kFillWords = 8192;  // output words per fill block
constexpr int kScanWords = 32 * kThreads;  // the longest chunk whose runs a scan finds
constexpr int32_t kSentinel = 0x7FFFFFFF;

struct OpPtrs {
  const int32_t* in[kMaxOps];
  int32_t* out[kMaxOps];
};

__global__ void __launch_bounds__(kThreads)
tile_totals(const int32_t* __restrict__ bounds, int K, int cpb, int tiles,
            int32_t* __restrict__ tsum) {
  extern __shared__ int32_t s_tot[];
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x - b * tiles;
  const long long c0 = (long long)b * cpb + (long long)t * kScanTile;
  const int nc = min(kScanTile, cpb - t * kScanTile);
  for (int d = threadIdx.x; d < K; d += kThreads) s_tot[d] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < nc * K; i += kThreads) {
    const int c = i / K;
    const int d = i - c * K;
    const int32_t* row = bounds + (c0 + c) * (K + 1);
    atomicAdd(&s_tot[d], __ldg(row + d + 1) - __ldg(row + d));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < K; d += kThreads)
    tsum[(long long)blockIdx.x * K + d] = s_tot[d];
}

__global__ void __launch_bounds__(kThreads)
region_offsets(const int32_t* __restrict__ bounds, int K, int cpb, int tiles,
               const int32_t* __restrict__ tsum, int32_t* __restrict__ offs,
               int32_t* __restrict__ counts) {
  extern __shared__ int32_t s_carry[];
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x - b * tiles;
  const long long c0 = (long long)b * cpb + (long long)t * kScanTile;
  const int nc = min(kScanTile, cpb - t * kScanTile);
  for (int d = threadIdx.x; d < K; d += kThreads) s_carry[d] = 0;
  __syncthreads();
  const int32_t* ts = tsum + (long long)b * tiles * K;  // this region's earlier tiles
  for (int i = threadIdx.x; i < t * K; i += kThreads) atomicAdd(&s_carry[i % K], __ldg(ts + i));
  __syncthreads();
  for (int d = threadIdx.x; d < K; d += kThreads) {
    int run = s_carry[d];
#pragma unroll 8
    for (int c = 0; c < nc; ++c) {
      const int32_t* row = bounds + (c0 + c) * (K + 1);
      offs[(c0 + c) * K + d] = run;
      run += __ldg(row + d + 1) - __ldg(row + d);
    }
    if (t == tiles - 1) counts[(long long)b * K + d] = run;
  }
}

// Fill block f of the output: the sentinel into the words
// [f * kFillWords, (f + 1) * kFillWords) that lie at or past their region's
// count.
template <int NOPS>
__device__ void fill_tails(const OpPtrs& p, const int32_t* __restrict__ counts, long long cap,
                           long long total, int f) {
  const long long w0 = (long long)f * kFillWords;
  const long long w1 = min(w0 + kFillWords, total);
  long long r = w0 / cap;
  if ((w1 - 1) / cap == r && w1 - r * cap <= min((long long)__ldg(counts + r), cap))
    return;  // inside one region's live prefix
  const int4 s4 = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
  // cap is a multiple of 128 words, so a 4-word group lies in one region;
  // a thread's groups move forward, so its region only steps forward
  long long end = (r + 1) * cap;
  long long live = r * cap + min(max((long long)__ldg(counts + r), 0LL), cap);
  for (long long w = w0 + 4 * threadIdx.x; w < w1; w += 4 * kThreads) {
    while (w >= end) {
      ++r;
      live = end + min(max((long long)__ldg(counts + r), 0LL), cap);
      end += cap;
    }
    if (w + 4 <= live) continue;
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
      if (w >= live) {
        *reinterpret_cast<int4*>(p.out[o] + w) = s4;
      } else {
        for (long long k = live; k < w + 4; ++k) p.out[o][k] = kSentinel;
      }
    }
  }
}

// s_run keeps one pad word after every 32 entries, so that the
// consecutive entries a thread scans lie on distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Inclusive max-scan of the n entries of s in place (values >= 0), n a
// power of two from 4 * kThreads to 32 * kThreads: each thread takes the
// maximum of its n / kThreads consecutive entries, the threads' maxima
// are scanned across the block, and each thread rescans its entries from
// the maximum before it.
__device__ void block_max_scan(int32_t* s, int n) {
  __shared__ int32_t warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = n / kThreads;  // divides 32: no pad word inside a thread's entries
  int32_t* mine = s + pad(threadIdx.x * per);
  int m = 0;
  for (int k = 0; k < per; ++k) m = max(m, mine[k]);
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
  for (int k = 0; k < per; ++k) mine[k] = before = max(before, mine[k]);
}

// Blocks [0, nchunks) scatter one chunk each; the blocks after them fill
// the sentinel tails (fill_tails), so both run in one launch.
template <int NOPS>
__global__ void __launch_bounds__(kThreads)
scatter_runs(OpPtrs p, const int32_t* __restrict__ bounds,
             const int32_t* __restrict__ offs, const int32_t* __restrict__ counts,
             int nchunks, int K, int m, int cpb, long long cap, long long total,
             int use_scan) {
  constexpr int U = NOPS >= 8 ? 8 : 64 / NOPS;  // words a thread loads per operand at once
  if ((int)blockIdx.x >= nchunks) {
    fill_tails<NOPS>(p, counts, cap, total, blockIdx.x - nchunks);
    return;
  }
  extern __shared__ int32_t smem[];
  int32_t* s_run = smem;                      // run of each chunk word (use_scan)
  int32_t* sb = smem + (use_scan ? pad(m) : 0);  // bounds[c, 0..K]
  int32_t* so = sb + K + 1;                   // offs[c, 0..K-1]
  const long long c = blockIdx.x;
  const long long b = c / cpb;
  if (use_scan)
    for (int q = threadIdx.x; q < pad(m); q += kThreads) s_run[q] = 0;
  for (int t = threadIdx.x; t <= K; t += kThreads) sb[t] = bounds[c * (K + 1) + t];
  for (int t = threadIdx.x; t < K; t += kThreads) so[t] = offs[c * K + t];
  __syncthreads();
  const int lo = min(max(sb[0], 0), m);
  const int hi = min(max(sb[K], lo), m);
  if (use_scan) {
    // every run that holds words marks its first word; a max-scan hands
    // each word its run
    for (int d = threadIdx.x; d < K; d += kThreads)
      if (sb[d] < sb[d + 1] && sb[d] >= lo && sb[d] < hi) s_run[pad(sb[d])] = d;
    __syncthreads();
    block_max_scan(s_run, m);
    __syncthreads();
  }
  const int32_t* in[NOPS];
#pragma unroll
  for (int w = 0; w < NOPS; ++w) in[w] = p.in[w] + c * m;
  for (int j0 = lo + threadIdx.x; j0 < hi; j0 += kThreads * U) {
    int32_t v[U][NOPS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * kThreads;
#pragma unroll
      for (int w = 0; w < NOPS; ++w) v[u][w] = j < hi ? __ldg(in[w] + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= hi) break;
      int d = 0;
      if (use_scan) {
        d = s_run[pad(j)];
      } else if (K > 1) {  // the last run d in [0, K) that starts at or before j
        int h = K - 1;
        while (d < h) {
          const int mid = (d + h + 1) >> 1;
          if (sb[mid] <= j) d = mid; else h = mid - 1;
        }
      }
      const long long dst = (long long)so[d] + (j - sb[d]);
      if (dst < 0 || dst >= cap) continue;
      const long long o = (b * K + d) * cap + dst;
#pragma unroll
      for (int w = 0; w < NOPS; ++w) p.out[w][o] = v[u][w];
    }
  }
}

// The runs and the sentinel tails of one group of up to kMaxOps operands.
template <int NOPS>
void launch_group(const OpPtrs& p, const int32_t* bounds, const int32_t* offs,
                  const int32_t* counts, int nchunks, int K, int m, int cpb, long long cap,
                  long long total, cudaStream_t stream) {
  // the scan needs m words of shared memory: chunks of a power of two up
  // to kScanWords words
  const int use_scan = K > 1 && m >= 4 * kThreads && m <= kScanWords && (m & (m - 1)) == 0;
  const size_t smem = ((use_scan ? m + m / 32 : 0) + 2 * K + 1) * sizeof(int32_t);
  const long long nfill = (total + kFillWords - 1) / kFillWords;
  scatter_runs<NOPS><<<(unsigned)(nchunks + nfill), kThreads, smem, stream>>>(
      p, bounds, offs, counts, nchunks, K, m, cpb, cap, total, use_scan);
}

}  // namespace

// Chunks per scan tile, for the wrapper's scratch size.
extern "C" int rst_extract_scan_tile() { return kScanTile; }

// Returns cudaGetLastError() after the launches (0 on success). tsum is
// int32 scratch of (nchunks/cpb) * ceil(cpb/kScanTile) * K entries, offs
// of nchunks*K; counts has (nchunks/cpb)*K entries. Every operand and
// output must be 16-byte aligned, and cap a multiple of 128.
extern "C" int rst_bucket_extract(void** in_ptrs, void** out_ptrs, int nops,
                                  const void* bounds, void* tsum, void* offs, void* counts,
                                  int nchunks, int K, int m, int cpb, long long cap,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* bnd = static_cast<const int32_t*>(bounds);
  int32_t* ts = static_cast<int32_t*>(tsum);
  int32_t* off = static_cast<int32_t*>(offs);
  int32_t* cnt = static_cast<int32_t*>(counts);
  if (nchunks <= 0 || K <= 0 || cpb <= 0) return 0;
  if (m % 128 || cap % 128) return static_cast<int>(cudaErrorInvalidValue);
  const int nparents = nchunks / cpb;
  const int tiles = (cpb + kScanTile - 1) / kScanTile;
  const size_t smem = K * sizeof(int32_t);
  if (tiles > 1) tile_totals<<<nparents * tiles, kThreads, smem, s>>>(bnd, K, cpb, tiles, ts);
  region_offsets<<<nparents * tiles, kThreads, smem, s>>>(bnd, K, cpb, tiles, ts, off, cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)nparents * K * cap;
  for (int w0 = 0; w0 < nops; w0 += kMaxOps) {
    const int n = nops - w0 < kMaxOps ? nops - w0 : kMaxOps;
    OpPtrs p = {};
    for (int w = 0; w < n; ++w) {
      p.in[w] = static_cast<const int32_t*>(in_ptrs[w0 + w]);
      p.out[w] = static_cast<int32_t*>(out_ptrs[w0 + w]);
    }
    switch (n) {
      case 1: launch_group<1>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
      case 2: launch_group<2>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
      case 3: launch_group<3>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
      case 4: launch_group<4>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
      case 5: launch_group<5>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
      case 6: launch_group<6>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
      case 7: launch_group<7>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
      default: launch_group<8>(p, bnd, off, cnt, nchunks, K, m, cpb, cap, total, s); break;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
