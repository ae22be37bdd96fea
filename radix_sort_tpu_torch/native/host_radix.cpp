// Host-side native runtime: multi-threaded stable LSD radix sort.
//
// The TPU framework's host component: fast data preparation, dataset
// generation, and host-side verification for arrays too large to oracle with
// a comparison sort. Functionally equivalent to the reference crate's
// production engine (src/radix_sort/mod.rs:61-176) — stable 8-bit LSD passes
// with per-chunk histograms, a digit-major/chunk-minor exclusive prefix sum
// (the stability invariant, mod.rs:110-120), and a parallel scatter — built
// fresh in C++17/std::thread for this framework's host runtime.
//
// Additions over the reference semantics (documented, output-identical):
//   * trivial passes are skipped (all keys share the pass digit), which the
//     digit-major scan detects for free — a large win for small-range keys;
//   * an odd number of executed passes ends with the data in the temp
//     buffer; a final memcpy restores it (mod.rs:170-174 analogue).
//
// Exposed with a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename K, typename V, bool HasV>
void lsd_radix(K* keys, V* vals, K* tk, V* tv, int64_t n, int nthreads) {
  if (n <= 1) return;
  constexpr int PASSES = static_cast<int>(sizeof(K));
  nthreads = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(nthreads, (n + 65535) >> 16)));
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<std::vector<uint64_t>> hist(
      nthreads, std::vector<uint64_t>(256));

  K* src_k = keys;
  K* dst_k = tk;
  V* src_v = vals;
  V* dst_v = tv;

  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = pass * 8;

    {  // phase 1: per-chunk histograms (mod.rs:90-109 analogue)
      std::vector<std::thread> ts;
      for (int t = 0; t < nthreads; ++t) {
        ts.emplace_back([&, t] {
          auto& h = hist[t];
          std::fill(h.begin(), h.end(), 0);
          const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
          for (int64_t i = lo; i < hi; ++i)
            h[(src_k[i] >> shift) & 0xFF]++;
        });
      }
      for (auto& th : ts) th.join();
    }

    // phase 2: exclusive scan, digit-major chunk-minor (mod.rs:110-120);
    // also detects trivial passes (one digit owns every key)
    bool trivial = false;
    {
      uint64_t sum = 0;
      for (int d = 0; d < 256 && !trivial; ++d) {
        uint64_t digit_total = 0;
        for (int t = 0; t < nthreads; ++t) digit_total += hist[t][d];
        if (digit_total == static_cast<uint64_t>(n)) trivial = true;
      }
      if (!trivial) {
        for (int d = 0; d < 256; ++d) {
          for (int t = 0; t < nthreads; ++t) {
            const uint64_t c = hist[t][d];
            hist[t][d] = sum;
            sum += c;
          }
        }
      }
    }
    if (trivial) continue;

    {  // phase 3: parallel stable scatter (mod.rs:121-168 analogue)
      std::vector<std::thread> ts;
      for (int t = 0; t < nthreads; ++t) {
        ts.emplace_back([&, t] {
          auto& h = hist[t];
          const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
          for (int64_t i = lo; i < hi; ++i) {
            const unsigned d = (src_k[i] >> shift) & 0xFF;
            const uint64_t p = h[d]++;
            dst_k[p] = src_k[i];
            if constexpr (HasV) dst_v[p] = src_v[i];
          }
        });
      }
      for (auto& th : ts) th.join();
    }

    std::swap(src_k, dst_k);
    if constexpr (HasV) std::swap(src_v, dst_v);
  }

  if (src_k != keys) {
    std::memcpy(keys, src_k, static_cast<size_t>(n) * sizeof(K));
    if constexpr (HasV)
      std::memcpy(vals, src_v, static_cast<size_t>(n) * sizeof(V));
  }
}

struct none_t {};

}  // namespace

extern "C" {

void rst_sort_u32(uint32_t* keys, uint32_t* tmp, int64_t n, int threads) {
  lsd_radix<uint32_t, none_t, false>(keys, nullptr, tmp, nullptr, n, threads);
}

void rst_sort_u64(uint64_t* keys, uint64_t* tmp, int64_t n, int threads) {
  lsd_radix<uint64_t, none_t, false>(keys, nullptr, tmp, nullptr, n, threads);
}

void rst_sort_pairs_u32(uint32_t* keys, uint32_t* vals, uint32_t* tk,
                        uint32_t* tv, int64_t n, int threads) {
  lsd_radix<uint32_t, uint32_t, true>(keys, vals, tk, tv, n, threads);
}

void rst_sort_pairs_u64(uint64_t* keys, uint64_t* vals, uint64_t* tk,
                        uint64_t* tv, int64_t n, int threads) {
  lsd_radix<uint64_t, uint64_t, true>(keys, vals, tk, tv, n, threads);
}

int rst_num_threads(void) {
  const unsigned hc = std::thread::hardware_concurrency();
  return hc ? static_cast<int>(hc) : 4;
}

}  // extern "C"
