// A stable merge of P sorted runs, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. After the distributed sort's exchange
// (parallel/dist_sort.py) each slot holds its rows as P runs, one from each
// source slot, back to back in source order, and each run is sorted: it is
// a piece of its source's stable local sort. The JAX package's step 4 sorts
// them again with lax.sort (radix_sort_tpu/parallel/dist_sort.py:488-493);
// the port did the same with a full stable sort. A merge whose ties go to
// the lower run gives the same rows, because the runs lie in source order.
// Contract:
//   in:  key, the rank word of every row (int32 or int64), P runs back to
//        back from row 0, run r of len[r] rows, each sorted ascending;
//        ncols operand columns of 1, 2, 4 or 8 bytes a row, laid out as
//        the key (one of them may be the key itself).
//   out: each column's rows in the stable order of the key, rows [0, n),
//        n = sum(len): row (r, i) comes before row (r', i') iff its key is
//        smaller, or the keys are equal and r < r', or r == r' and i < i'.
//        Nothing past row n is written.
//
// Bound on an H100: bytes moved. Every operand is read once and written
// once (32 bytes a row at 16-byte (key, payload) rows, 2.39 ms for 250M
// rows at 3.35 TB/s); the partition below reads a few sectors a sample.
//
// Design. Two kernels. merge_sorted_runs_partition takes every S-th row
// of each run as a sample and finds, by binary search in the other runs,
// how many rows of each run come before it (ties to the lower run), so
// the sample's place among all samples; each G-th sample in that order is
// a tile boundary, stored as its P co-ranks. Between consecutive samples a
// run has fewer than S rows, so a tile of G samples holds fewer than
// (G + P) S rows, whatever the key distribution: every tile fits shared
// memory. merge_sorted_runs gives each tile to one block: it copies the
// tile's P key segments into shared memory with cp.async, and the first
// payload column beside them, so that the payload's loads overlap the
// ranking. Each row's place in the tile is its index in its segment plus
// its rank in every other segment (a binary search in shared memory; equal
// keys count as before it in a lower run, after it in a higher one). The
// block then writes each column out in order, neighbouring threads on
// neighbouring output rows (coalesced stores), reading the staged column
// in shared memory through the inverse of those places. Each further
// column is staged and written in turn. No global scratch beyond the
// boundaries, no permutation in device memory, no gather.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRuns = 64;
constexpr int kMaxCols = 64;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

struct Runs {
  long long start[kMaxRuns];  // first row of run r
  long long len[kMaxRuns];
};

struct Cols {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int width[kMaxCols];  // bytes a row: 1, 2, 4 or 8
};

// Rows of the sorted a[0, n) that come before a row of key x: those below
// x, and with kTiesBefore those equal to it too.
template <bool kTiesBefore, typename K, typename I>
__device__ __forceinline__ I rank_in(const K* a, I n, K x) {
  I lo = 0, hi = n;
  while (lo < hi) {
    const I mid = lo + ((hi - lo) >> 1);
    const K v = a[mid];
    if (kTiesBefore ? !(x < v) : v < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename K>
__device__ __forceinline__ long long rank_in_run(const K* __restrict__ key, const Runs& runs,
                                                 int r, int s, K x) {
  return r < s ? rank_in<true>(key + runs.start[r], runs.len[r], x)
               : rank_in<false>(key + runs.start[r], runs.len[r], x);
}

// Sample q of the samples[0, samples): row j S of the run it falls in.
// Its rank among all samples is the count of samples before it in each
// run: ceil(co-rank / S). Samples whose rank is a multiple of group store
// their co-ranks as tile boundary rank / group; one more thread stores
// the end (every run whole).
template <typename K>
__global__ void __launch_bounds__(kThreads)
merge_sorted_runs_partition(const K* __restrict__ key, Runs runs, int p, long long spacing,
                            int group, long long samples, long long* __restrict__ bounds) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q > samples) return;
  if (q == samples) {
    const long long tiles = (samples + group - 1) / group;
    for (int r = 0; r < p; ++r) bounds[tiles * p + r] = runs.len[r];
    return;
  }
  int s = 0;
  long long j = q;
  for (;; ++s) {
    const long long c = (runs.len[s] + spacing - 1) / spacing;
    if (j < c) break;
    j -= c;
  }
  const long long i = j * spacing;
  const K x = key[runs.start[s] + i];
  long long k = j;
  for (int r = 0; r < p; ++r) {
    if (r != s) k += (rank_in_run(key, runs, r, s, x) + spacing - 1) / spacing;
  }
  if (k >= samples || k % group) return;
  long long* b = bounds + (k / group) * p;
  for (int r = 0; r < p; ++r) b[r] = r == s ? i : rank_in_run(key, runs, r, s, x);
}

template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(a), "l"(gmem), "n"(kBytes));
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Tile {
  long long src[kMaxRuns];  // global row of each segment's first row
  int off[kMaxRuns + 1];    // each segment's first row in the tile
  long long out;            // the tile's first output row
};

// Stage a column's tile segments, in segment order, into buf: by cp.async
// for 4- and 8-byte rows, by plain loads for narrower ones.
template <typename T>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ src, const Tile& tile,
                                      int p) {
  for (int r = 0; r < p; ++r) {
    const int o = tile.off[r], len = tile.off[r + 1] - o;
    const T* g = src + tile.src[r];
    for (int t = threadIdx.x; t < len; t += kThreads) {
      if constexpr (sizeof(T) >= 4) {
        copy_async<sizeof(T)>(buf + o + t, g + t);
      } else {
        buf[o + t] = g[t];
      }
    }
  }
}

__device__ __forceinline__ void stage_column(void* buf, const void* src, int width,
                                             const Tile& tile, int p) {
  switch (width) {
    case 1: stage(static_cast<uint8_t*>(buf), static_cast<const uint8_t*>(src), tile, p); break;
    case 2: stage(static_cast<uint16_t*>(buf), static_cast<const uint16_t*>(src), tile, p); break;
    case 4: stage(static_cast<uint32_t*>(buf), static_cast<const uint32_t*>(src), tile, p); break;
    default: stage(static_cast<uint64_t*>(buf), static_cast<const uint64_t*>(src), tile, p);
  }
}

// out[tile.out + t] = buf[inv[t]]: coalesced stores in output order.
template <typename T>
__device__ __forceinline__ void write_out(const T* buf, const uint16_t* inv, void* out,
                                          long long at, int m) {
  T* o = static_cast<T*>(out) + at;
  for (int t = threadIdx.x; t < m; t += kThreads) o[t] = buf[inv[t]];
}

__device__ __forceinline__ void write_column(const void* buf, const uint16_t* inv, void* out,
                                             int width, long long at, int m) {
  switch (width) {
    case 1: write_out(static_cast<const uint8_t*>(buf), inv, out, at, m); break;
    case 2: write_out(static_cast<const uint16_t*>(buf), inv, out, at, m); break;
    case 4: write_out(static_cast<const uint32_t*>(buf), inv, out, at, m); break;
    default: write_out(static_cast<const uint64_t*>(buf), inv, out, at, m);
  }
}

// One tile of output rows, between tile boundaries blockIdx.x and
// blockIdx.x + 1. Shared memory: the staged column (8 bytes a row), the
// keys, and inv (output row -> staged row), max_rows rows each.
template <typename K>
__global__ void __launch_bounds__(kThreads)
merge_sorted_runs(const K* __restrict__ key, Runs runs, Cols cols, int p, int ncols,
                  int key_col, int max_rows, const long long* __restrict__ bounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* buf = smem;
  K* keys = reinterpret_cast<K*>(smem + 8LL * max_rows);
  uint16_t* inv = reinterpret_cast<uint16_t*>(keys + max_rows);
  __shared__ Tile tile;
  if (threadIdx.x == 0) {
    const long long* lo = bounds + (long long)blockIdx.x * p;
    const long long* hi = lo + p;
    long long out = 0;
    int acc = 0;
    for (int r = 0; r < p; ++r) {
      const long long len = hi[r] - lo[r];
      if (len < 0 || acc + len > max_rows) __trap();  // runs not sorted
      tile.src[r] = runs.start[r] + lo[r];
      tile.off[r] = acc;
      acc += static_cast<int>(len);
      out += lo[r];
    }
    tile.off[p] = acc;
    tile.out = out;
  }
  __syncthreads();
  const int m = tile.off[p];
  // the keys, then the first payload column, both in flight at once
  stage(keys, key, tile, p);
  commit_async();
  int first = 0;
  while (first < ncols && first == key_col) ++first;
  if (first < ncols) stage_column(buf, cols.src[first], cols.width[first], tile, p);
  commit_async();
  wait_async<1>();
  __syncthreads();
  // each row's place in the tile: its index in its segment and its rank in
  // every other segment
  for (int s = 0; s < p; ++s) {
    const int o = tile.off[s], len = tile.off[s + 1] - o;
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const K x = keys[o + t];
      int place = t;
      for (int r = 0; r < p; ++r) {
        const int ro = tile.off[r], rl = tile.off[r + 1] - ro;
        if (r < s) place += rank_in<true>(keys + ro, rl, x);
        if (r > s) place += rank_in<false>(keys + ro, rl, x);
      }
      inv[place] = static_cast<uint16_t>(o + t);
    }
  }
  __syncthreads();
  for (int c = 0; c < ncols; ++c) {
    if (c == key_col) {
      write_out(keys, inv, cols.dst[c], tile.out, m);
      continue;
    }
    if (c != first) {
      stage_column(buf, cols.src[c], cols.width[c], tile, p);
      commit_async();
    }
    wait_async<0>();
    __syncthreads();
    write_column(buf, inv, cols.dst[c], cols.width[c], tile.out, m);
    __syncthreads();
  }
}

template <typename K>
int launch(const void* key, const long long* len, int p, const void* const* src,
           void* const* dst, const int* width, int ncols, int key_col, long long spacing,
           int group, long long* bounds, cudaStream_t stream) {
  Runs runs;
  long long samples = 0, at = 0;
  for (int r = 0; r < p; ++r) {
    runs.start[r] = at;
    runs.len[r] = len[r];
    at += len[r];
    samples += (len[r] + spacing - 1) / spacing;
  }
  if (samples == 0) return 0;
  Cols cols;
  for (int c = 0; c < ncols; ++c) {
    cols.src[c] = src[c];
    cols.dst[c] = dst[c];
    cols.width[c] = width[c];
  }
  const long long tiles = (samples + group - 1) / group;
  const long long max_rows = (group + p) * spacing;
  const long long smem = max_rows * (8 + sizeof(K) + 2);
  if (max_rows > 65535 || smem > kMaxSmem || tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const K* k = static_cast<const K*>(key);
  const long long pblocks = (samples + kThreads) / kThreads;  // samples + 1 threads
  merge_sorted_runs_partition<K><<<static_cast<unsigned>(pblocks), kThreads, 0, stream>>>(
      k, runs, p, spacing, group, samples, bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(merge_sorted_runs<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sorted_runs<K><<<static_cast<unsigned>(tiles), kThreads, static_cast<size_t>(smem),
                         stream>>>(k, runs, cols, p, ncols, key_col,
                                   static_cast<int>(max_rows), bounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a CUDA error code (0 on success). key_bytes 4 or 8; p runs of
// len[r] rows back to back; ncols columns (src, dst, width bytes), column
// key_col (or -1) the key itself; samples every `spacing` rows, tiles of
// `group` samples; bounds holds (ceil(samples / group) + 1) * p int64.
extern "C" int rst_merge_sorted_runs(const void* key, int key_bytes, const long long* len, int p,
                                     const void* const* src, void* const* dst, const int* width,
                                     int ncols, int key_col, long long spacing, int group,
                                     void* bounds, void* stream) {
  if (p < 1 || p > kMaxRuns || ncols < 0 || ncols > kMaxCols || spacing < 1 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < p; ++r) {
    if (len[r] < 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < ncols; ++c) {
    const int w = width[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(src[c]) % w || reinterpret_cast<uintptr_t>(dst[c]) % w)
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (key_col >= ncols || (key_col >= 0 && width[key_col] != key_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(key) % key_bytes)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto* b = static_cast<long long*>(bounds);
  auto* s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8)
    return launch<long long>(key, len, p, src, dst, width, ncols, key_col, spacing, group, b, s);
  if (key_bytes == 4)
    return launch<int>(key, len, p, src, dst, width, ncols, key_col, spacing, group, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
