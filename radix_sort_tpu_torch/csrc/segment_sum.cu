// SS: the sum of each group of key-sorted rows, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package sums a GROUP BY's float columns
// with jax.ops.segment_sum, a scatter that XLA emits; the port used
// index_add_, whose float atomics all land on one address when the groups
// are few (TPC-H Q1: ~15M rows into each of 4 groups). Here the rows are
// already sorted by key, so each group is one contiguous run and has one
// owner that stores it: no atomics, and the same bits on every run.
// Contract:
//   in:  x, n values (float16, bfloat16, float32 or float64); gid, n int64
//        dense group ids: 0 at the first row, and each row's id equal to
//        the row before's or one more (a running count of group starts,
//        as every caller makes it). Other ids are outside the contract.
//   out: out[g], g < G = gid[n - 1] + 1, is the sum of the rows of id g,
//        accumulated in float64 from +0.0 in a fixed order and rounded
//        once to x's type (as Tensor.to rounds a float64: through float32
//        for the 16-bit types). Rows [G, n) of out are +0.0.
//
// Bound on an H100: bytes moved. x is read once and every row of out is
// written once (2 n x's width: 0.94 GB, 0.28 ms, for Q1's 59M float64
// rows at 3.35 TB/s). gid adds 8 bytes a row where a tile holds more than
// one group, and a few sectors a tile elsewhere.
//
// Design. Two kernels. segment_sum_tiles gives each block a tile of
// kTile contiguous rows and first reads gid at the tile's two ends. When
// they are equal the tile is one group (almost every tile when the groups
// are few): the block reads the values with 16-byte loads, neighbouring
// threads on neighbouring vectors, sums them in float64 registers and
// reduces across the block, and never reads the interior of gid.
// Otherwise each thread takes kItems contiguous rows with their ids (read
// again, from the cache, with 16-byte loads) and sums its runs; a
// segmented scan by head flags across the warp (shuffles) and then across
// the block carries each run that crosses threads. A run that begins and
// ends inside the tile is a whole group: its sum goes to shared memory at
// its id's offset from the tile's first id, and the block stores those
// ids' sums to out in one coalesced pass (a thread's runs lie kItems rows
// from its neighbours', so stores straight to out would scatter). The
// tile's first and last groups may go
// on into the neighbouring tiles: their partials go to the carries, two a
// tile, (id, float64 partial). segment_sum_carries, one block, reduces the
// carries by id in tile order with the same scan, a chunk at a time (each
// read a chunk ahead), and stores each such group once. Each block also
// writes +0.0 to the rows [G, n) of out that fall in its tile's row range.
// Nothing of n rows in float64 is materialised.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // rows a thread in a tile of many groups
constexpr int kTile = kThreads * kItems;   // rows a block; ops/segment_sum.py TILE
constexpr long long kNone = -1;            // no id: before a tile, past its end

__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ double widen(float v) { return static_cast<double>(v); }
__device__ __forceinline__ double widen(__half v) { return static_cast<double>(__half2float(v)); }
__device__ __forceinline__ double widen(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}

template <typename T>
__device__ __forceinline__ T narrow(double s);
template <>
__device__ __forceinline__ double narrow<double>(double s) { return s; }
template <>
__device__ __forceinline__ float narrow<float>(double s) { return __double2float_rn(s); }
template <>
__device__ __forceinline__ __half narrow<__half>(double s) {
  return __float2half_rn(__double2float_rn(s));
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(double s) {
  return __float2bfloat16_rn(__double2float_rn(s));
}

// The 16 / sizeof(T) values at p (16-byte aligned), widened.
template <typename T>
__device__ __forceinline__ void load16(const T* p, double* out) {
  constexpr int kV = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  T e[kV];
  memcpy(e, &raw, 16);
#pragma unroll
  for (int i = 0; i < kV; ++i) out[i] = widen(e[i]);
}

struct Scratch {
  long long first[kThreads];  // each thread's first id (kNone: no rows)
  long long last[kThreads];   // each thread's last id
  double incl[kThreads];      // each thread's inclusive scan value
  double warp_v[kWarps];
  int warp_f[kWarps];
  long long g0, g1, groups;   // the tile's first and last ids, G
};

// The block's sum of v, in thread 0.
__device__ double block_sum(double v, Scratch& sc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sc.warp_v[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sc.warp_v[w];
  }
  return s;
}

// Inclusive segmented scan of (f, v) over the block's threads in order: a
// thread with f set starts afresh. Returns the thread's value; sc.incl
// holds every thread's when it returns.
__device__ double block_seg_scan(bool f, double v, Scratch& sc) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double vo = __shfl_up_sync(0xffffffffu, v, o);
    const int fo = __shfl_up_sync(0xffffffffu, static_cast<int>(f), o);
    if (lane >= o) {
      if (!f) v = vo + v;
      f = f || fo;
    }
  }
  if (lane == 31) {
    sc.warp_v[w] = v;
    sc.warp_f[w] = f;
  }
  __syncthreads();
  if (!f) {  // the open run of the warps before, in order
    double p = 0.0;
    for (int i = 0; i < w; ++i) p = sc.warp_f[i] ? sc.warp_v[i] : p + sc.warp_v[i];
    v = p + v;
  }
  sc.incl[threadIdx.x] = v;
  __syncthreads();
  return v;
}

// The runs of a block's rows, thread t holding rows [t kItems, t kItems + m)
// with ids k and values v: emit(id, sum) once for each run, with the sum of
// all its rows in the block, in a fixed order. Ends synchronised, with
// sc.last holding each thread's last id.
template <typename Emit>
__device__ void block_runs(const long long (&k)[kItems], const double (&v)[kItems], int m,
                           Scratch& sc, Emit&& emit) {
  const int tid = threadIdx.x;
  long long lastk = kNone;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < m) lastk = k[j];
  }
  sc.first[tid] = m ? k[0] : kNone;
  sc.last[tid] = lastk;
  __syncthreads();
  const long long pk = tid ? sc.last[tid - 1] : kNone;
  const long long nk = tid + 1 < kThreads ? sc.first[tid + 1] : kNone;
  // the thread's own rows: its first run's partial in head, each run that
  // begins and ends inside them emitted, the last run's partial in acc
  double acc = 0.0, head = 0.0;
  bool split = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < m) {
      if (j > 0 && k[j] != k[j - 1]) {
        if (split) {
          emit(k[j - 1], acc);
        } else {
          head = acc;
        }
        split = true;
        acc = 0.0;
      }
      acc += v[j];
    }
  }
  const bool starts = m > 0 && (tid == 0 || k[0] != pk);
  const double s = block_seg_scan(starts || split, acc, sc);
  if (split) emit(k[0], starts ? head : sc.incl[tid - 1] + head);
  if (m > 0 && nk != lastk) emit(lastk, s);
  __syncthreads();
}

// A staged sum's slot: one double of padding every 16, so that threads kItems
// rows apart store to different banks.
__device__ __forceinline__ long long padded(long long i) { return i + (i >> 4); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_tiles(const T* __restrict__ x, const long long* __restrict__ gid, long long n,
                      bool vec, T* __restrict__ out, long long* __restrict__ ckey,
                      double* __restrict__ cval) {
  __shared__ Scratch sc;
  __shared__ double stage[kTile + kTile / 16];  // the tile's inner groups' sums
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long t0 = tile * kTile, t1 = min(t0 + kTile, n);
  const bool full = vec && t1 - t0 == kTile;
  constexpr int kV = 16 / sizeof(T);
  constexpr int kVecs = kItems / kV;  // 16-byte vectors a thread
  // The tile's sum, read while thread 0 waits for the ids at its ends: in
  // a tile of one group it is all the block reads.
  double acc = 0.0;
  if (full) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      double e[kV];
      load16(x + t0 + (static_cast<long long>(j) * kThreads + tid) * kV, e);
#pragma unroll
      for (int i = 0; i < kV; ++i) acc += e[i];
    }
  } else {
    for (long long r = t0 + tid; r < t1; r += kThreads) acc += widen(x[r]);
  }
  if (tid == 0) {
    sc.g0 = gid[t0];
    sc.g1 = gid[t1 - 1];
    sc.groups = gid[n - 1] + 1;
  }
  __syncthreads();
  const long long g0 = sc.g0, g1 = sc.g1;
  // rows [G, n) of out that fall in the tile's rows
  const long long z0 = max(t0, sc.groups);
  if (full && z0 == t0) {
    uint4* o = reinterpret_cast<uint4*>(out + t0);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) o[j * kThreads + tid] = make_uint4(0, 0, 0, 0);
  } else {
    for (long long r = z0 + tid; r < t1; r += kThreads) out[r] = narrow<T>(0.0);
  }

  if (g0 == g1) {  // one group
    acc = block_sum(acc, sc);
    if (tid == 0) {
      ckey[2 * tile] = g0;
      ckey[2 * tile + 1] = g0;
      cval[2 * tile] = acc;
      cval[2 * tile + 1] = 0.0;
    }
    return;
  }

  // many groups: each thread's kItems rows again (from the cache), with ids
  const long long r0 = t0 + static_cast<long long>(tid) * kItems;
  const int m = static_cast<int>(max(0LL, min(static_cast<long long>(kItems), t1 - r0)));
  long long k[kItems];
  double v[kItems];
  if (vec && m == kItems) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) load16(x + r0 + j * kV, v + j * kV);
#pragma unroll
    for (int j = 0; j < kItems / 2; ++j) {
      const longlong2 p = __ldg(reinterpret_cast<const longlong2*>(gid + r0) + j);
      k[2 * j] = p.x;
      k[2 * j + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = j < m ? gid[r0 + j] : kNone;
      v[j] = j < m ? widen(x[r0 + j]) : 0.0;
    }
  }
  if (tid == 0) {
    ckey[2 * tile] = g0;
    ckey[2 * tile + 1] = g1;
  }
  // The ids between the tile's first and last are whole groups of the tile,
  // fewer than kTile of them (the ids are dense): their sums gather in
  // shared memory and go out in one coalesced pass; a thread's own runs
  // lie kItems apart from its neighbours', which stores straight to out
  // would scatter.
  block_runs(k, v, m, sc, [&](long long g, double s) {
    if (g == g0) {
      cval[2 * tile] = s;
    } else if (g == g1) {
      cval[2 * tile + 1] = s;
    } else {
      stage[padded(g - g0 - 1)] = s;
    }
  });
  for (long long i = tid; i < g1 - g0 - 1; i += kThreads) {
    out[g0 + 1 + i] = narrow<T>(stage[padded(i)]);
  }
}

// The carries' pass: one block reduces the (id, partial) pairs, sorted by
// id, kTile at a time, the run open at a chunk's end carried into the next.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_carries(const long long* __restrict__ ckey, const double* __restrict__ cval,
                        long long entries, T* __restrict__ out) {
  __shared__ Scratch sc;
  __shared__ long long open_key;
  __shared__ double open_sum;
  const int tid = threadIdx.x;
  if (tid == 0) {
    open_key = kNone;
    open_sum = 0.0;
  }
  // a thread's entries of the chunk at c0, read one chunk ahead
  const auto load = [&](long long c0, long long (&k)[kItems], double (&v)[kItems]) {
    const long long r0 = c0 + static_cast<long long>(tid) * kItems;
    const int m = static_cast<int>(max(0LL, min(static_cast<long long>(kItems), entries - r0)));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = j < m ? ckey[r0 + j] : kNone;
      v[j] = j < m ? cval[r0 + j] : 0.0;
    }
  };
  long long k[kItems];
  double v[kItems];
  load(0, k, v);
  for (long long c0 = 0; c0 < entries; c0 += kTile) {
    const long long c1 = min(c0 + kTile, entries);
    const long long r0 = c0 + static_cast<long long>(tid) * kItems;
    const int m = static_cast<int>(max(0LL, min(static_cast<long long>(kItems), c1 - r0)));
    long long kn[kItems];
    double vn[kItems];
    load(c1, kn, vn);
    __syncthreads();  // open_key / open_sum as the last chunk left them
    const long long in_key = open_key, first = ckey[c0], last = ckey[c1 - 1];
    const double in_sum = open_sum;
    const bool more = c1 < entries && ckey[c1] == last;  // the last run goes on
    // block_runs synchronises before it emits, so every thread has read
    // the carry in before one is written
    long long* const ok = &open_key;
    double* const os = &open_sum;
    block_runs(k, v, m, sc, [&](long long g, double s) {
      if (g == first && g == in_key) s = in_sum + s;
      if (g == last && more) {
        *ok = g;
        *os = s;
      } else {
        out[g] = narrow<T>(s);
      }
    });
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = kn[j];
      v[j] = vn[j];
    }
  }
}

template <typename T>
int launch(const void* x, const long long* gid, long long n, bool vec, void* out,
           long long* ckey, double* cval, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  T* o = static_cast<T*>(out);
  segment_sum_tiles<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(x), gid, n, vec, o, ckey, cval);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_sum_carries<T><<<1, kThreads, 0, stream>>>(ckey, cval, 2 * tiles, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a CUDA error code (0 on success). dtype: 0 float16, 1 bfloat16,
// 2 float32, 3 float64; x, gid and out of n rows; ckey (int64) and cval
// (float64) of 2 ceil(n / 4096) entries each, scratch.
extern "C" int rst_segment_sum_sorted(const void* x, int dtype, const void* gid, long long n,
                                      void* out, void* ckey, void* cval, void* stream) {
  static const int kWidth[] = {2, 2, 4, 8};
  if (dtype < 0 || dtype > 3 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int w = kWidth[dtype];
  const uintptr_t px = reinterpret_cast<uintptr_t>(x), pg = reinterpret_cast<uintptr_t>(gid),
                  po = reinterpret_cast<uintptr_t>(out);
  if (px % w || po % w || pg % 8 || reinterpret_cast<uintptr_t>(ckey) % 8 ||
      reinterpret_cast<uintptr_t>(cval) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec = (px | pg | po) % 16 == 0;
  const auto* g = static_cast<const long long*>(gid);
  auto* ck = static_cast<long long*>(ckey);
  auto* cv = static_cast<double*>(cval);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<__half>(x, g, n, vec, out, ck, cv, s);
    case 1: return launch<__nv_bfloat16>(x, g, n, vec, out, ck, cv, s);
    case 2: return launch<float>(x, g, n, vec, out, ck, cv, s);
    default: return launch<double>(x, g, n, vec, out, ck, cv, s);
  }
}
