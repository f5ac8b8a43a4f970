// Shared helpers for the native featurizers/ingest (single header so a
// parity-critical fix can never land in one translation unit and miss
// the other — that drift has happened once).
#pragma once

#include <charconv>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <locale.h>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace oni {

// String interner: stable ids in first-seen order, arena-backed views so
// hot-path lookups never allocate, plus a lazily-built (blob, offsets)
// export for the ctypes side.  Interning invalidates any prior export.
struct Interner {
  std::unordered_map<std::string_view, int32_t> ids;
  std::deque<std::string> arena;
  std::string blob;
  std::vector<int64_t> offsets;

  int32_t intern(std::string_view s) {
    auto it = ids.find(s);
    if (it != ids.end()) return it->second;
    blob.clear();
    offsets.clear();
    arena.emplace_back(s);
    int32_t id = (int32_t)ids.size();
    ids.emplace(std::string_view(arena.back()), id);
    return id;
  }

  void build_export() {
    if (!offsets.empty()) return;
    offsets.push_back(0);
    size_t total = 0;
    for (const auto& s : arena) total += s.size();
    blob.reserve(total);
    for (const auto& s : arena) {
      blob += s;
      offsets.push_back((int64_t)blob.size());
    }
  }
};

// Open-addressing uint64 -> int64 map (linear probing, power-of-two
// capacity, 0.5 max load).  The featurizers' hot loops do several map
// operations per row; std::unordered_map's node allocations and
// pointer-chasing made the flow pass-B aggregation the pipeline's
// hottest block (~1.2 us/row of ~1.8).  Keys must never equal EMPTY
// (~0ull) — the packed (id << 32 | id) keys used here cannot.
struct FlatMap64 {
  static constexpr uint64_t EMPTY = ~0ull;
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  size_t count = 0, mask = 0;

  explicit FlatMap64(size_t expected = 16) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    keys.assign(cap, EMPTY);
    vals.resize(cap);
    mask = cap - 1;
  }

  static uint64_t mix(uint64_t x) {  // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
  }

  void grow() {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<int64_t> ov = std::move(vals);
    size_t cap = (mask + 1) * 2;
    keys.assign(cap, EMPTY);
    vals.resize(cap);
    mask = cap - 1;
    for (size_t i = 0; i < ok.size(); i++) {
      if (ok[i] == EMPTY) continue;
      size_t p = mix(ok[i]) & mask;
      while (keys[p] != EMPTY) p = (p + 1) & mask;
      keys[p] = ok[i];
      vals[p] = ov[i];
    }
  }

  // Returns the slot's value reference; *inserted reports whether the
  // key was new (value then undefined — caller must set it).
  int64_t& probe(uint64_t key, bool* inserted) {
    if (count * 2 >= mask + 1) grow();
    size_t p = mix(key) & mask;
    while (keys[p] != EMPTY && keys[p] != key) p = (p + 1) & mask;
    *inserted = keys[p] == EMPTY;
    if (*inserted) {
      keys[p] = key;
      count++;
    }
    return vals[p];
  }
};

// ASCII whitespace exactly (' ', '\t', '\n', '\v', '\f', '\r').  NOT
// std::isspace: that is LC_CTYPE-locale-dependent (e.g. 0xA0 counts as
// space under a Latin-1 locale), which would make featurization depend
// on the host environment.  CPython's float() additionally strips some
// unicode spaces (U+0085/U+00A0...) — a documented divergence
// (flow_featurize.cpp header), same class as underscored numerals.
inline bool ascii_space(char c) {
  return c == ' ' || (c >= '\t' && c <= '\r');
}

// Floating-point charconv landed in GCC 11; GCC 10 (this container's
// toolchain) ships integer-only from_chars/to_chars, which used to
// fail the whole native build — every featurizer silently fell back to
// the ~20x-slower Python paths.  The compat branch below reproduces
// the exact semantics through strtod_l / correctly-rounded snprintf
// (glibc), pinned to the "C" locale per-thread via uselocale so a host
// process locale cannot change parsing or formatting; parity with
// CPython stays pinned by the native test suite, which now RUNS on
// GCC-10 hosts instead of skipping.
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
#define ONI_FP_CHARCONV 1
#else
#define ONI_FP_CHARCONV 0
#endif

inline locale_t c_locale() {
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return c_loc;
}

// Python float(): trimmed token, optional '+', decimal/exponent/inf/nan;
// out-of-range saturates to +-inf / +-0.0; anything else -> NaN.
// The saturation fallback pins LC_NUMERIC to "C" so a host process with
// a different locale can't change how the digits parse.
inline double to_double(std::string_view s) {
  size_t b = 0, e = s.size();
  while (b < e && ascii_space(s[b])) b++;
  while (e > b && ascii_space(s[e - 1])) e--;
  if (b == e) return NAN;
  std::string_view t = s.substr(b, e - b);
  if (t[0] == '+') t.remove_prefix(1);
  if (t.empty()) return NAN;
#if ONI_FP_CHARCONV
  double v;
  auto [p, ec] = std::from_chars(t.data(), t.data() + t.size(), v);
  if (ec == std::errc::result_out_of_range && p == t.data() + t.size()) {
    std::string z(t);
    return strtod_l(z.c_str(), nullptr, c_locale());
  }
  if (ec != std::errc() || p != t.data() + t.size()) return NAN;
  return v;
#else
  // strtod accepts three token shapes from_chars rejects; filter them
  // so both branches parse identically: a SECOND '+' (one was already
  // stripped), a hex prefix (from_chars consumes just the "0" and the
  // full-consumption check below turns that into NaN), and leading
  // whitespace can't occur (trimmed above).  Saturation on ERANGE is
  // strtod's native behavior — same as the charconv branch's fallback.
  if (t[0] == '+') return NAN;
  size_t d = (t[0] == '-') ? 1 : 0;
  if (t.size() > d + 1 && t[d] == '0' && (t[d + 1] == 'x' || t[d + 1] == 'X'))
    return NAN;
  std::string z(t);
  char* endp = nullptr;
  double v = strtod_l(z.c_str(), &endp, c_locale());
  if (endp != z.c_str() + z.size()) return NAN;
  return v;
#endif
}

// bin(v) = #{cuts c : v > c} (quantiles.bin_values; NaN > c is false).
inline int bin_of(double v, const double* cuts, int n) {
  int b = 0;
  for (int i = 0; i < n; i++) b += v > cuts[i];
  return b;
}

inline void append_int(std::string& s, int v) {
  char buf[16];
  auto [p, ec] = std::to_chars(buf, buf + sizeof(buf), v);
  (void)ec;
  s.append(buf, p);
}

// Constant-memory file streaming: reads 4MB chunks, carries the partial
// trailing line between chunks, and hands newline-complete buffers to
// `on_buffer(ptr, len)`.  Returns false (setting `err`) on open/read
// failure — fread reports EOF and I/O errors identically, so ferror is
// the only truncation signal.
template <class F>
inline bool stream_file(const char* path, std::string& err, F&& on_buffer) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return false;
  }
  std::string pending;
  std::vector<char> buf(1 << 22);
  size_t got;
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    size_t last_nl = got;
    while (last_nl > 0 && buf[last_nl - 1] != '\n') last_nl--;
    if (last_nl == 0) {
      pending.append(buf.data(), got);
      continue;
    }
    size_t start = 0;
    if (!pending.empty()) {
      const char* nl = (const char*)memchr(buf.data(), '\n', got);
      pending.append(buf.data(), (size_t)(nl - buf.data() + 1));
      on_buffer(pending.data(), (int64_t)pending.size());
      pending.clear();
      start = (size_t)(nl - buf.data() + 1);
    }
    on_buffer(buf.data() + start, (int64_t)(last_nl - start));
    if (last_nl < got) pending.assign(buf.data() + last_nl, got - last_nl);
  }
  if (ferror(f)) {
    err = std::string("read error on ") + path;
    fclose(f);
    return false;
  }
  fclose(f);
  if (!pending.empty()) on_buffer(pending.data(), (int64_t)pending.size());
  return true;
}

inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline int64_t file_size_of(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseeko(f, 0, SEEK_END) != 0) {
    fclose(f);
    return -1;
  }
  int64_t n = (int64_t)ftello(f);
  fclose(f);
  return n;
}

// First line of `path`, exactly as sequential ingest would see it: the
// bytes before the first '\n', with ONE trailing '\r' stripped.
// *end_off is the offset just past that '\n' (where data begins for a
// skip-header shard plan).  Returns false with err EMPTY when the file
// holds no '\n' at all (single-line/empty file — callers take the
// sequential path), false with err SET on I/O failure.
inline bool read_first_line(const char* path, std::string& out,
                            int64_t* end_off, std::string& err) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return false;
  }
  out.clear();
  int64_t pos = 0;
  std::vector<char> buf(1 << 20);
  size_t got;
  bool found = false;
  while (!found && (got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    const char* nl = (const char*)memchr(buf.data(), '\n', got);
    if (nl) {
      out.append(buf.data(), (size_t)(nl - buf.data()));
      pos += (int64_t)(nl - buf.data()) + 1;
      found = true;
    } else {
      out.append(buf.data(), got);
      pos += (int64_t)got;
    }
  }
  if (ferror(f)) {
    err = std::string("read error on ") + path;
    fclose(f);
    return false;
  }
  fclose(f);
  if (!found) return false;
  if (end_off) *end_off = pos;
  if (!out.empty() && out.back() == '\r') out.pop_back();
  return true;
}

// Line-aligned shard plan for parallel ingest: `workers`+1 offsets
// bounding [data_start, size) into [b[i], b[i+1]) ranges, each range
// beginning at a line start (the byte after a '\n'; b[0] = data_start).
// Adjacent ranges can collapse to empty when one line spans several
// raw splits — concatenated in order the ranges always cover the input
// exactly once, so a CRLF pair or a multi-megabyte line is never torn
// across workers.  Empty vector with err set on I/O failure.
inline std::vector<int64_t> shard_bounds(const char* path,
                                         int64_t data_start, int64_t size,
                                         int workers, std::string& err) {
  std::vector<int64_t> b{data_start};
  FILE* f = fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return {};
  }
  std::vector<char> buf(1 << 20);
  int64_t span = size - data_start;
  for (int i = 1; i < workers; i++) {
    int64_t cand = data_start + span * i / workers;
    if (cand < b.back()) cand = b.back();
    int64_t pos = cand, bound = size;
    if (fseeko(f, pos, SEEK_SET) != 0) {
      err = std::string("cannot seek in ") + path;
      fclose(f);
      return {};
    }
    while (pos < size) {
      size_t want = (size_t)std::min<int64_t>((int64_t)buf.size(),
                                              size - pos);
      size_t got = fread(buf.data(), 1, want, f);
      if (got == 0) break;
      const char* nl = (const char*)memchr(buf.data(), '\n', got);
      if (nl) {
        bound = pos + (int64_t)(nl - buf.data()) + 1;
        break;
      }
      pos += (int64_t)got;
    }
    if (ferror(f)) {
      err = std::string("read error on ") + path;
      fclose(f);
      return {};
    }
    b.push_back(bound);
  }
  fclose(f);
  b.push_back(size);
  return b;
}

// stream_file restricted to the byte range [begin, end): same chunked
// reads and partial-line carry, so a worker sees newline-complete
// buffers for exactly its shard.  The trailing unterminated line is
// flushed at range end — only the LAST shard of a file can hold one
// (every other range ends right after a '\n' by shard_bounds
// construction).
template <class F>
inline bool stream_file_range(const char* path, int64_t begin, int64_t end,
                              std::string& err, F&& on_buffer) {
  if (begin >= end) return true;
  FILE* f = fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return false;
  }
  if (fseeko(f, begin, SEEK_SET) != 0) {
    err = std::string("cannot seek in ") + path;
    fclose(f);
    return false;
  }
  std::string pending;
  std::vector<char> buf(1 << 22);
  int64_t remaining = end - begin;
  size_t got;
  while (remaining > 0 &&
         (got = fread(buf.data(), 1,
                      (size_t)std::min<int64_t>((int64_t)buf.size(),
                                                remaining),
                      f)) > 0) {
    remaining -= (int64_t)got;
    size_t last_nl = got;
    while (last_nl > 0 && buf[last_nl - 1] != '\n') last_nl--;
    if (last_nl == 0) {
      pending.append(buf.data(), got);
      continue;
    }
    size_t start = 0;
    if (!pending.empty()) {
      const char* nl = (const char*)memchr(buf.data(), '\n', got);
      pending.append(buf.data(), (size_t)(nl - buf.data() + 1));
      on_buffer(pending.data(), (int64_t)pending.size());
      pending.clear();
      start = (size_t)(nl - buf.data() + 1);
    }
    on_buffer(buf.data() + start, (int64_t)(last_nl - start));
    if (last_nl < got) pending.assign(buf.data() + last_nl, got - last_nl);
  }
  if (ferror(f)) {
    err = std::string("read error on ") + path;
    fclose(f);
    return false;
  }
  fclose(f);
  if (!pending.empty()) on_buffer(pending.data(), (int64_t)pending.size());
  return true;
}

// str(float): CPython repr — shortest round-trip digits, fixed notation
// for decimal exponents in [-4, 16), scientific ("1e+16", "1e-05",
// two-plus exponent digits, explicit sign) outside, ".0" suffix on
// integral fixed values.  std::to_chars' shortest *general* format
// picks scientific wherever it is shorter (1e15 -> "1e+15",
// 0.0001 -> "1e-04"), which diverges from Python inside that window —
// so take shortest-scientific digits and re-format per Python's rule.
inline std::string jvm_double(double v) {
  char buf[64];
  if (!std::isfinite(v)) {
    // "inf" / "-inf" / "nan" == str(float); NaN sign/payload dropped
    // like to_chars (and Python).
    if (std::isnan(v)) return "nan";
    return v < 0 ? "-inf" : "inf";
  }
#if ONI_FP_CHARCONV
  auto [p, ec] = std::to_chars(buf, buf + sizeof(buf), v,
                               std::chars_format::scientific);
  (void)ec;
  std::string_view s(buf, (size_t)(p - buf));
#else
  // Shortest-round-trip scientific digits without float to_chars:
  // correctly-rounded %.*e (glibc) at increasing precision until the
  // value round-trips.  Minimal precision implies a nonzero last digit
  // (a trailing zero would round-trip one digit shorter), so the digit
  // string below matches to_chars' shortest output; the C locale is
  // pinned per-thread so '.' is the radix regardless of host locale.
  locale_t old_loc = uselocale(c_locale());
  int len = 0;
  for (int prec = 0; prec <= 17; prec++) {
    len = snprintf(buf, sizeof(buf), "%.*e", prec, v);
    if (strtod(buf, nullptr) == v) break;
  }
  uselocale(old_loc);
  std::string_view s(buf, (size_t)len);
#endif
  bool neg = s.front() == '-';
  if (neg) s.remove_prefix(1);
  size_t epos = s.find('e');
  std::string digits(1, s[0]);
  if (epos > 1) digits.append(s.substr(2, epos - 2));  // skip the '.'
  int exp10 = 0;
  std::from_chars(s.data() + epos + 1 + (s[epos + 1] == '+'),
                  s.data() + s.size(), exp10);
  std::string out;
  if (neg) out += '-';
  if (exp10 >= -4 && exp10 < 16) {
    if (exp10 < 0) {
      out += "0.";
      out.append((size_t)(-exp10 - 1), '0');
      out += digits;
    } else if ((size_t)exp10 + 1 >= digits.size()) {
      out += digits;
      out.append((size_t)exp10 + 1 - digits.size(), '0');
      out += ".0";
    } else {
      out.append(digits, 0, (size_t)exp10 + 1);
      out += '.';
      out.append(digits, (size_t)exp10 + 1, std::string::npos);
    }
  } else {
    out += digits[0];
    if (digits.size() > 1) {
      out += '.';
      out.append(digits, 1, std::string::npos);
    }
    out += 'e';
    out += exp10 < 0 ? '-' : '+';
    int ae = exp10 < 0 ? -exp10 : exp10;
    if (ae < 10) out += '0';
    append_int(out, ae);
  }
  return out;
}

}  // namespace oni
