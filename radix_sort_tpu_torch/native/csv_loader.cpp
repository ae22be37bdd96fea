// Host-side native runtime: CSV ingestion (tokenize + type inference +
// dictionary encoding) in C++17.
//
// The framework's tabular data loader. The reference crate's only file
// I/O is raw-key transmute reads for the bench (src/main.rs:47-99); a
// query engine also needs structured ingestion. Measured on a ~1 GB
// mixed int/float/string/date file (this 1-core VM, BASELINE.md):
// 61-66 MB/s (~1.6 M rows/s) vs numpy genfromtxt's 9.7 MB/s — 6-7x.
// The two passes are independent per chunk, so a multi-core host could
// thread the scan; this VM has one core (nproc=1), so it is not.
// This loader:
//   * tokenizes RFC4180-style CSV (quoted fields, "" escapes, embedded
//     delimiters/newlines, CRLF) in one linear scan per pass;
//   * infers each column's type over ALL rows (candidate-set lattice:
//     int64, float64, date32 (ISO YYYY-MM-DD), timestamp-us (ISO date +
//     [T or space] + HH:MM:SS[.ffffff]), else string; a column of pure
//     dates resolves date32, dates mixed with timestamps resolves
//     timestamp (dates read as midnight), anything mixed with
//     non-members resolves string; empty fields are NULLs and don't
//     affect the type);
//   * dictionary-encodes string columns directly into the engine's
//     native format — uint32 codes + a distinct-value vocabulary — so
//     Table construction does no further per-row string work;
//   * reports empty fields as a per-column null mask (SQL NULL).
//
// Exposed with a C ABI for ctypes (no pybind11 in this environment).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

enum ColType { T_I64 = 0, T_F64 = 1, T_STR = 2, T_DATE = 3, T_TS = 4 };

struct Col {
  std::string name;
  int type = T_I64;
  bool seen_value = false;
  bool has_null = false;
  // inference candidate set: a field that fails a candidate's grammar
  // eliminates it; the final type is the first survivor in
  // int64 < float64 < date32 < timestamp-us order (string = none left)
  bool can_i = true, can_f = true, can_d = true, can_t = true;
  std::vector<int64_t> i64;  // also date32 epoch days / timestamp-us
  std::vector<double> f64;
  std::vector<uint32_t> codes;
  std::vector<uint8_t> mask;
  std::vector<std::string> vocab;  // by code, in first-seen order
};

struct Csv {
  std::vector<Col> cols;
  int64_t nrows = 0;
  std::string vocab_blob;  // scratch for the accessor
  std::vector<int64_t> vocab_offs;
};

thread_local std::string g_err;

// strip unquoted-field whitespace (genfromtxt autostrip parity)
inline void strip(const char*& p, size_t& len) {
  while (len && (*p == ' ' || *p == '\t')) { ++p; --len; }
  while (len && (p[len - 1] == ' ' || p[len - 1] == '\t')) --len;
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

inline bool parse_i64(const char* p, size_t len, int64_t& out) {
  // hand-rolled signed decimal with overflow check — ~3x strtoll (no
  // errno, no copy, no locale); the loader's hottest per-field call
  if (len == 0 || len > 20) return false;
  const char* e = p + len;
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = *p == '-';
    ++p;
  }
  if (p == e) return false;
  uint64_t v = 0;
  for (; p < e; ++p) {
    if (!is_digit(*p)) return false;
    const unsigned d = static_cast<unsigned>(*p - '0');
    if (v > (UINT64_MAX - d) / 10) return false;
    v = v * 10 + d;
  }
  const uint64_t lim =
      neg ? (1ULL << 63) : (1ULL << 63) - 1;  // |INT64_MIN| / INT64_MAX
  if (v > lim) return false;
  out = neg ? -static_cast<int64_t>(v - 1) - 1 : static_cast<int64_t>(v);
  return true;
}

// grammar-only float check for the inference pass: [+-]digits[.digits]
// [eE[+-]digits] with at least one digit — no strtod (which costs
// ~150 ns/field and dominated pass 1; the VALUE is only needed in pass 2
// for columns that actually resolve float)
inline bool float_shape(const char* p, size_t len) {
  // same 63-char cap as parse_f64_slow: a longer numeric field must
  // degrade the column to STRING in pass 1, never resolve float and
  // then fail to parse in pass 2 (silent 0.0; caught in round-5 review)
  if (len > 63) return false;
  const char* e = p + len;
  if (p < e && (*p == '+' || *p == '-')) ++p;
  bool dig = false;
  while (p < e && is_digit(*p)) { ++p; dig = true; }
  if (p < e && *p == '.') {
    ++p;
    while (p < e && is_digit(*p)) { ++p; dig = true; }
  }
  if (!dig) return false;
  if (p < e && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < e && (*p == '+' || *p == '-')) ++p;
    if (p >= e) return false;
    while (p < e && is_digit(*p)) ++p;
  }
  return p == e;
}

inline bool float_special(const char* p, size_t len) {
  // strtod also accepts [+-]inf / infinity / nan (case-insensitive)
  if (len && (*p == '+' || *p == '-')) { ++p; --len; }
  auto eq = [&](const char* w, size_t wl) {
    if (len != wl) return false;
    for (size_t i = 0; i < wl; ++i)
      if ((p[i] | 0x20) != w[i]) return false;
    return true;
  };
  return eq("inf", 3) || eq("infinity", 8) || eq("nan", 3);
}

inline bool parse_f64_slow(const char* p, size_t len, double& out) {
  if (len == 0 || len > 63) return false;
  char tmp[64];
  std::memcpy(tmp, p, len);
  tmp[len] = 0;
  char* end = nullptr;
  out = std::strtod(tmp, &end);
  return end == tmp + len;
}

inline bool parse_f64(const char* p, size_t len, double& out) {
  // exact fast path (~5x strtod): value = m * 10^e with m <= 15
  // significant digits (exact in double) and |e| <= 22 (10^e exact in
  // double), so the single multiply/divide is correctly rounded — the
  // classic float-parse fast case. Everything else goes to strtod.
  static const double P10[23] = {
      1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
      1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
      1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
  const char* q = p;
  const char* e = p + len;
  bool neg = false;
  if (q < e && (*q == '+' || *q == '-')) {
    neg = *q == '-';
    ++q;
  }
  uint64_t m = 0;
  int digits = 0, frac = 0;
  bool dig = false;
  for (; q < e && is_digit(*q); ++q) {
    dig = true;
    if (++digits > 15) return parse_f64_slow(p, len, out);
    m = m * 10 + static_cast<unsigned>(*q - '0');
  }
  if (q < e && *q == '.') {
    ++q;
    for (; q < e && is_digit(*q); ++q) {
      dig = true;
      if (++digits > 15) return parse_f64_slow(p, len, out);
      m = m * 10 + static_cast<unsigned>(*q - '0');
      ++frac;
    }
  }
  if (!dig) return parse_f64_slow(p, len, out);  // inf/nan/empty
  int exp10 = -frac;
  if (q < e && (*q == 'e' || *q == 'E')) {
    ++q;
    bool eneg = false;
    if (q < e && (*q == '+' || *q == '-')) {
      eneg = *q == '-';
      ++q;
    }
    if (q >= e) return false;
    int ev = 0;
    for (; q < e && is_digit(*q); ++q) {
      ev = ev * 10 + (*q - '0');
      if (ev > 400) return parse_f64_slow(p, len, out);
    }
    exp10 += eneg ? -ev : ev;
  }
  if (q != e) return false;
  double v;
  if (exp10 >= 0) {
    if (exp10 > 22) return parse_f64_slow(p, len, out);
    v = static_cast<double>(m) * P10[exp10];
  } else {
    if (exp10 < -22) return parse_f64_slow(p, len, out);
    v = static_cast<double>(m) / P10[-exp10];
  }
  out = neg ? -v : v;
  return true;
}

// string interning without per-row std::string construction: open
// addressing on an FNV-1a hash of the raw bytes, verifying against the
// owned vocab entry on hit (C++17 unordered_map can't look up by
// string_view without an allocation)
struct Intern {
  std::vector<uint32_t> slots;  // id + 1; 0 = empty
  size_t count = 0;

  static uint64_t hash(const char* p, size_t len) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < len; ++i) {
      h ^= static_cast<unsigned char>(p[i]);
      h *= 1099511628211ULL;
    }
    return h;
  }

  uint32_t get(const char* p, size_t len, std::vector<std::string>& vocab) {
    if (slots.empty()) slots.assign(1024, 0);
    if (count * 2 >= slots.size()) {  // rehash at 50% load
      std::vector<uint32_t> old;
      old.swap(slots);
      slots.assign(old.size() * 2, 0);
      for (uint32_t s : old) {
        if (!s) continue;
        const std::string& v = vocab[s - 1];
        size_t i = hash(v.data(), v.size()) & (slots.size() - 1);
        while (slots[i]) i = (i + 1) & (slots.size() - 1);
        slots[i] = s;
      }
    }
    size_t i = hash(p, len) & (slots.size() - 1);
    while (slots[i]) {
      const std::string& v = vocab[slots[i] - 1];
      if (v.size() == len && std::memcmp(v.data(), p, len) == 0)
        return slots[i] - 1;
      i = (i + 1) & (slots.size() - 1);
    }
    const uint32_t id = static_cast<uint32_t>(vocab.size());
    vocab.emplace_back(p, len);
    slots[i] = id + 1;
    ++count;
    return id;
  }
};

// days since 1970-01-01 for a civil date (Howard Hinnant's public-domain
// days_from_civil, the same algorithm dates.py uses on device)
inline int64_t days_from_civil(int64_t y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + static_cast<int64_t>(doe) - 719468;
}

// strict ISO date prefix YYYY-MM-DD (calendar-validated, incl. leap
// years); on success sets epoch days
inline bool parse_date_prefix(const char* p, size_t len, int64_t& days) {
  if (len < 10 || p[4] != '-' || p[7] != '-') return false;
  for (int i : {0, 1, 2, 3, 5, 6, 8, 9})
    if (!is_digit(p[i])) return false;
  const int y = (p[0] - '0') * 1000 + (p[1] - '0') * 100 +
                (p[2] - '0') * 10 + (p[3] - '0');
  const unsigned m = (p[5] - '0') * 10 + (p[6] - '0');
  const unsigned d = (p[8] - '0') * 10 + (p[9] - '0');
  if (m < 1 || m > 12 || d < 1) return false;
  static const unsigned mdays[12] = {31, 28, 31, 30, 31, 30,
                                     31, 31, 30, 31, 30, 31};
  unsigned dm = mdays[m - 1];
  if (m == 2 && y % 4 == 0 && (y % 100 != 0 || y % 400 == 0)) dm = 29;
  if (d > dm) return false;
  days = days_from_civil(y, m, d);
  return true;
}

inline bool parse_date(const char* p, size_t len, int64_t& days) {
  return len == 10 && parse_date_prefix(p, len, days);
}

// ISO timestamp: date + (' '|'T') + HH:MM:SS[.f{1,}] -> epoch
// microseconds (fraction digits beyond 6 truncate); a bare date also
// parses (midnight), so date columns promote cleanly to timestamp
inline bool parse_ts_full(const char* p, size_t len, int64_t& us) {
  int64_t days;
  if (len < 19 || !parse_date_prefix(p, len, days)) return false;
  if (p[10] != ' ' && p[10] != 'T') return false;
  if (p[13] != ':' || p[16] != ':') return false;
  for (int i : {11, 12, 14, 15, 17, 18})
    if (!is_digit(p[i])) return false;
  const int hh = (p[11] - '0') * 10 + (p[12] - '0');
  const int mm = (p[14] - '0') * 10 + (p[15] - '0');
  const int ss = (p[17] - '0') * 10 + (p[18] - '0');
  if (hh > 23 || mm > 59 || ss > 59) return false;
  size_t pos = 19;
  int64_t frac = 0;
  int fd = 0;
  if (pos < len && p[pos] == '.') {
    ++pos;
    if (pos >= len || !is_digit(p[pos])) return false;
    while (pos < len && is_digit(p[pos])) {
      if (fd < 6) frac = frac * 10 + (p[pos] - '0');
      ++fd;
      ++pos;
    }
    for (; fd < 6; ++fd) frac *= 10;
  }
  if (pos != len) return false;
  us = (((days * 24 + hh) * 60 + mm) * 60 + ss) * 1000000LL + frac;
  return true;
}

inline bool parse_ts(const char* p, size_t len, int64_t& us) {
  int64_t days;
  if (parse_date(p, len, days)) {  // a bare date is a midnight timestamp
    us = days * 86400000000LL;
    return true;
  }
  return parse_ts_full(p, len, us);
}

// Walk the buffer field by field. cb(row, col, ptr, len, quoted) is
// called for every field; rows are 0-based EXCLUDING the header (which
// is row -1). Returns false (with g_err set) on structural errors.
template <typename CB>
bool for_each_field(const std::string& buf, char delim, CB&& cb) {
  const char* p = buf.data();
  const char* e = p + buf.size();
  int64_t row = -1;
  int col = 0;
  int ncols = -1;
  std::string unq;  // scratch for unescaping quoted fields
  while (p < e) {
    const char* fs;
    size_t flen;
    bool quoted = false;
    if (*p == '"') {
      quoted = true;
      unq.clear();
      ++p;
      while (true) {
        if (p >= e) {
          g_err = "unterminated quoted field";
          return false;
        }
        if (*p == '"') {
          if (p + 1 < e && p[1] == '"') {  // "" escape
            unq.push_back('"');
            p += 2;
          } else {
            ++p;
            break;
          }
        } else {
          unq.push_back(*p++);
        }
      }
      fs = unq.data();
      flen = unq.size();
    } else {
      fs = p;
      while (p < e && *p != delim && *p != '\n' && *p != '\r') ++p;
      flen = static_cast<size_t>(p - fs);
      strip(fs, flen);
    }
    if (!cb(row, col, fs, flen, quoted)) return false;
    ++col;
    if (p < e && *p == delim) {
      ++p;
      continue;
    }
    // record end (or EOF)
    if (p < e && *p == '\r') ++p;
    if (p < e && *p == '\n') ++p;
    if (ncols < 0) {
      ncols = col;
    } else if (col != ncols) {
      g_err = "row " + std::to_string(row) + " has " +
              std::to_string(col) + " fields, expected " +
              std::to_string(ncols);
      return false;
    }
    col = 0;
    ++row;
    // skip blank trailing lines
    while (p < e && (*p == '\n' || *p == '\r')) ++p;
  }
  if (col != 0) {
    g_err = "file ends mid-record";
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

const char* rst_csv_last_error() { return g_err.c_str(); }

void* rst_csv_parse(const char* path, char delim) {
  g_err.clear();
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) {
    g_err = std::string("cannot open ") + path;
    return nullptr;
  }
  const std::streamsize sz = f.tellg();
  f.seekg(0);
  std::string buf(static_cast<size_t>(sz), '\0');
  if (sz && !f.read(&buf[0], sz)) {
    g_err = std::string("short read on ") + path;
    return nullptr;
  }
  if (buf.empty()) {
    g_err = "empty file";
    return nullptr;
  }
  auto csv = new Csv();
  // pass 1: header names + per-column type inference over every field
  bool ok = for_each_field(
      buf, delim,
      [&](int64_t row, int col, const char* p, size_t len, bool quoted) {
        if (row < 0) {
          csv->cols.emplace_back();
          csv->cols.back().name.assign(p, len);
          return true;
        }
        if (col >= static_cast<int>(csv->cols.size())) {
          g_err = "more fields than header columns";
          return false;
        }
        Col& c = csv->cols[col];
        if (col == 0) csv->nrows = row + 1;
        if (len == 0 && !quoted) return true;  // NULL: type-neutral
        c.seen_value = true;
        if (!(c.can_i || c.can_f || c.can_d || c.can_t)) return true;
        int64_t iv;
        double dv;
        if (quoted) {
          // quoted fields are text by intent
          c.can_i = c.can_f = c.can_d = c.can_t = false;
          return true;
        }
        (void)dv;
        // a valid int is a valid float, a valid date is a valid
        // (midnight) timestamp — each pair costs ONE parse per field;
        // floats validate by grammar only (no strtod until pass 2)
        if (c.can_i || c.can_f) {
          if (c.can_i && parse_i64(p, len, iv)) {
            // both candidates survive
          } else {
            c.can_i = false;
            if (c.can_f && !(float_shape(p, len) ||
                             float_special(p, len)))
              c.can_f = false;
          }
        }
        if (c.can_d || c.can_t) {
          if (parse_date(p, len, iv)) {
            // both candidates survive
          } else {
            c.can_d = false;
            if (c.can_t && !parse_ts_full(p, len, iv)) c.can_t = false;
          }
        }
        return true;
      });
  if (!ok) {
    delete csv;
    return nullptr;
  }
  for (auto& c : csv->cols)
    c.type = c.can_i   ? T_I64
             : c.can_f ? T_F64
             : c.can_d ? T_DATE
             : c.can_t ? T_TS
                       : T_STR;
  if (csv->nrows == 0) {
    // header-only file: zero-row columns (all int64)
    for (auto& c : csv->cols) c.mask.clear();
    return csv;
  }
  // pass 2: convert under the final types
  for (auto& c : csv->cols) {
    c.mask.assign(static_cast<size_t>(csv->nrows), 0);
    if (c.type == T_I64 || c.type == T_DATE || c.type == T_TS)
      c.i64.resize(csv->nrows);
    else if (c.type == T_F64) c.f64.resize(csv->nrows);
    else c.codes.resize(csv->nrows);
  }
  std::vector<Intern> maps(csv->cols.size());
  ok = for_each_field(
      buf, delim,
      [&](int64_t row, int col, const char* p, size_t len, bool quoted) {
        if (row < 0) return true;
        Col& c = csv->cols[col];
        if (len == 0 && !quoted) {
          c.mask[row] = 1;
          c.has_null = true;
          return true;  // typed slot stays 0 (the engine's invariant)
        }
        if (c.type == T_I64) {
          parse_i64(p, len, c.i64[row]);
        } else if (c.type == T_DATE) {
          parse_date(p, len, c.i64[row]);  // epoch days
        } else if (c.type == T_TS) {
          parse_ts(p, len, c.i64[row]);  // epoch microseconds
        } else if (c.type == T_F64) {
          parse_f64(p, len, c.f64[row]);
        } else {
          c.codes[row] = maps[col].get(p, len, c.vocab);
        }
        return true;
      });
  if (!ok) {
    delete csv;
    return nullptr;
  }
  return csv;
}

long long rst_csv_nrows(void* h) { return static_cast<Csv*>(h)->nrows; }

int rst_csv_ncols(void* h) {
  return static_cast<int>(static_cast<Csv*>(h)->cols.size());
}

const char* rst_csv_col_name(void* h, int j) {
  return static_cast<Csv*>(h)->cols[j].name.c_str();
}

int rst_csv_col_type(void* h, int j) {
  return static_cast<Csv*>(h)->cols[j].type;
}

int rst_csv_col_has_null(void* h, int j) {
  return static_cast<Csv*>(h)->cols[j].has_null ? 1 : 0;
}

void rst_csv_col_i64(void* h, int j, long long* out) {
  auto& c = static_cast<Csv*>(h)->cols[j];
  std::memcpy(out, c.i64.data(), c.i64.size() * sizeof(int64_t));
}

void rst_csv_col_f64(void* h, int j, double* out) {
  auto& c = static_cast<Csv*>(h)->cols[j];
  std::memcpy(out, c.f64.data(), c.f64.size() * sizeof(double));
}

void rst_csv_col_codes(void* h, int j, unsigned int* out) {
  auto& c = static_cast<Csv*>(h)->cols[j];
  std::memcpy(out, c.codes.data(), c.codes.size() * sizeof(uint32_t));
}

void rst_csv_col_mask(void* h, int j, unsigned char* out) {
  auto& c = static_cast<Csv*>(h)->cols[j];
  std::memcpy(out, c.mask.data(), c.mask.size());
}

long long rst_csv_vocab_count(void* h, int j) {
  return static_cast<long long>(static_cast<Csv*>(h)->cols[j].vocab.size());
}

// concatenated utf-8 vocab bytes; offs has vocab_count+1 entries
long long rst_csv_vocab_bytes(void* h, int j) {
  auto* csv = static_cast<Csv*>(h);
  auto& c = csv->cols[j];
  csv->vocab_blob.clear();
  csv->vocab_offs.clear();
  csv->vocab_offs.push_back(0);
  for (auto& s : c.vocab) {
    csv->vocab_blob += s;
    csv->vocab_offs.push_back(
        static_cast<int64_t>(csv->vocab_blob.size()));
  }
  return static_cast<long long>(csv->vocab_blob.size());
}

void rst_csv_vocab(void* h, int j, char* blob, long long* offs) {
  auto* csv = static_cast<Csv*>(h);
  (void)j;  // rst_csv_vocab_bytes(h, j) must have been called for j
  std::memcpy(blob, csv->vocab_blob.data(), csv->vocab_blob.size());
  std::memcpy(offs, csv->vocab_offs.data(),
              csv->vocab_offs.size() * sizeof(int64_t));
}

void rst_csv_free(void* h) { delete static_cast<Csv*>(h); }

// ---------------------------------------------------------------------
// Raw-row interning for in-memory string columns (strings.encode's
// native path): rows are FIXED-WIDTH byte records (numpy 'U' dtype =
// UTF-32 with trailing zero padding; equal strings <=> equal records).
// One linear scan assigns first-seen-order codes and records each
// distinct value's first row, so Python can build the sorted vocabulary
// from a tiny gather + argsort over DISTINCT values only — replacing
// np.unique's O(n log n) string sort over ALL rows (measured 40-50 s at
// 16M rows vs ~1-2 s here, BASELINE.md).
// ---------------------------------------------------------------------

struct InternRaw {
  std::vector<int64_t> firsts;  // first row index per code
};

void* rst_intern_rows(const char* data, long long n, long long rowbytes,
                      unsigned int* codes_out) {
  auto* st = new InternRaw();
  std::vector<uint32_t> slots(1024, 0);  // id + 1; 0 = empty
  size_t count = 0;
  const size_t rb = static_cast<size_t>(rowbytes);
  for (long long r = 0; r < n; ++r) {
    const char* p = data + r * rb;
    if (count * 2 >= slots.size()) {  // rehash at 50% load
      std::vector<uint32_t> old;
      old.swap(slots);
      slots.assign(old.size() * 2, 0);
      for (uint32_t s : old) {
        if (!s) continue;
        const char* v = data + st->firsts[s - 1] * rb;
        size_t i = Intern::hash(v, rb) & (slots.size() - 1);
        while (slots[i]) i = (i + 1) & (slots.size() - 1);
        slots[i] = s;
      }
    }
    size_t i = Intern::hash(p, rb) & (slots.size() - 1);
    uint32_t id;
    for (;;) {
      if (!slots[i]) {
        id = static_cast<uint32_t>(count);
        st->firsts.push_back(r);
        slots[i] = id + 1;
        ++count;
        break;
      }
      const char* v = data + st->firsts[slots[i] - 1] * rb;
      if (std::memcmp(v, p, rb) == 0) {
        id = slots[i] - 1;
        break;
      }
      i = (i + 1) & (slots.size() - 1);
    }
    codes_out[r] = id;
  }
  return st;
}

long long rst_intern_count(void* h) {
  return static_cast<long long>(static_cast<InternRaw*>(h)->firsts.size());
}

void rst_intern_firsts(void* h, long long* out) {
  auto& f = static_cast<InternRaw*>(h)->firsts;
  std::memcpy(out, f.data(), f.size() * sizeof(int64_t));
}

void rst_intern_free(void* h) { delete static_cast<InternRaw*>(h); }

// ---------------------------------------------------------------------
// Sorted-vocabulary merge (strings.unify's native path): one linear
// two-pointer merge over two SORTED fixed-width UTF-32 arrays replaces
// np.union1d's combined re-sort (measured ~39 s for 10.6M + 10.6M
// vocabularies vs linear time here, BASELINE.md). Comparison is
// code-point lexicographic with zero-padding semantics — exactly
// numpy's unicode order.
// ---------------------------------------------------------------------

inline int cmp_u32_rows(const uint32_t* a, int64_t wa, const uint32_t* b,
                        int64_t wb) {
  const int64_t w = wa < wb ? wa : wb;
  for (int64_t i = 0; i < w; ++i)
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  for (int64_t i = w; i < wa; ++i)
    if (a[i]) return 1;
  for (int64_t i = w; i < wb; ++i)
    if (b[i]) return -1;
  return 0;
}

// Returns the union size. remap_a/remap_b map old codes -> union codes;
// (out_src, out_idx) describe union entry k as source array (0=a, 1=b)
// and index within it, so the caller stitches the union with two numpy
// gathers. Output buffers must hold na + nb entries.
long long rst_merge_sorted_u32(
    const uint32_t* a, long long na, long long wa,
    const uint32_t* b, long long nb, long long wb,
    unsigned int* remap_a, unsigned int* remap_b,
    unsigned char* out_src, unsigned int* out_idx) {
  int64_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    const int c = cmp_u32_rows(a + i * wa, wa, b + j * wb, wb);
    if (c < 0) {
      out_src[k] = 0;
      out_idx[k] = static_cast<unsigned int>(i);
      remap_a[i++] = static_cast<unsigned int>(k++);
    } else if (c > 0) {
      out_src[k] = 1;
      out_idx[k] = static_cast<unsigned int>(j);
      remap_b[j++] = static_cast<unsigned int>(k++);
    } else {
      out_src[k] = 0;
      out_idx[k] = static_cast<unsigned int>(i);
      remap_a[i++] = static_cast<unsigned int>(k);
      remap_b[j++] = static_cast<unsigned int>(k++);
    }
  }
  for (; i < na; ++i, ++k) {
    out_src[k] = 0;
    out_idx[k] = static_cast<unsigned int>(i);
    remap_a[i] = static_cast<unsigned int>(k);
  }
  for (; j < nb; ++j, ++k) {
    out_src[k] = 1;
    out_idx[k] = static_cast<unsigned int>(j);
    remap_b[j] = static_cast<unsigned int>(k);
  }
  return static_cast<long long>(k);
}

}  // extern "C"
