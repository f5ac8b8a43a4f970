// Native DNS featurizer — the C++ fast path for the DNS "pre" stage
// (dns_pre_lda.scala featurization, reimplemented in
// oni_ml_tpu/features/dns.py).  This is the stage the reference's
// authors sized a 62-executor x 12-core Spark cluster for
// (dns_pre_lda.scala:1-2, SURVEY.md §6).
//
// Split of responsibilities with Python (features/native_dns.py), same
// shape as the flow featurizer:
//   pass A (ingest_*): row filtering (8 fields), unix_tstamp/frame_len
//     numeric extraction, subdomain extraction (reverse-DNS +
//     country-code TLD handling), Shannon entropy, interning of
//     client IPs / domains / subdomains / qry_type / qry_rcode.
//   cuts: Python computes the five ECDF cut lists (deciles over
//     tstamp/frame_len, quintiles over the positive subsets) with
//     quantiles.ecdf_cuts — single implementation of the quantile rule.
//   pass B (finish): binning, whitelist flag, word construction
//     ("top_blen_btime_bsub_bent_bper_type_rcode"), first-seen-order
//     per-client word counts (dns_pre_lda.scala:330).
//
// Rows are exchanged and stored with the ASCII unit separator \x1f so
// parquet-sourced fields containing commas (frame_time!) survive; CSV
// files are split on ',' at ingest and re-joined with \x1f.
//
// Entropy matches Python bit-for-bit: character counts accumulate in
// first-seen order (Counter's iteration order) and the sum uses the
// same -(c/n)*log2(c/n) expression, so identical libm gives identical
// doubles.  Known divergence: characters are bytes here, codepoints in
// Python — identical for the ASCII/punycode names DNS carries.

#include "common.h"

#include <charconv>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ISO country-code TLDs, verbatim from dns_pre_lda.scala:180 (including
// the stray empty string and "krd") — mirrors features/dns.py.
using oni::Interner;
using oni::to_double;
using oni::bin_of;
using oni::append_int;

const char* kCountryCodes =
    "ac ad ae af ag ai al am an ao aq ar as at au aw ax az ba bb bd be bf bg "
    "bh bi bj bm bn bo bq br bs bt bv bw by bz ca cc cd cf cg ch ci ck cl cm "
    "cn co cr cu cv cw cx cy cz de dj dk dm do dz ec ee eg eh er es et eu fi "
    "fj fk fm fo fr ga gb gd ge gf gg gh gi gl gm gn gp gq gr gs gt gu gw gy "
    "hk hm hn hr ht hu id ie il im in io iq ir is it je jm jo jp ke kg kh ki "
    "km kn kp kr krd kw ky kz la lb lc li lk lr ls lt lu lv ly ma mc md me "
    "mg mh mk ml mm mn mo mp mq mr ms mt mu mv mw mx my mz na nc ne nf ng ni "
    "nl no np nr nu nz om pa pe pf pg ph pk pl pm pn pr ps pt pw py qa re ro "
    "rs ru rw sa sb sc sd se sg sh si sj sk sl sm sn so sr ss st su sv sx sy "
    "sz tc td tf tg th tj tk tl tm tn to tp tr tt tv tw tz ua ug uk us uy uz "
    "va vc ve vg vi vn vu wf ws ye yt za zm zw";

const std::unordered_set<std::string>& country_codes() {
  static const std::unordered_set<std::string>* set = [] {
    auto* s = new std::unordered_set<std::string>;
    const char* p = kCountryCodes;
    while (*p) {
      const char* q = p;
      while (*q && *q != ' ') q++;
      s->emplace(p, (size_t)(q - p));
      p = *q ? q + 1 : q;
    }
    s->emplace("");  // the reference set contains the empty string
    return s;
  }();
  return *set;
}

// Shannon entropy with Python's exact summation: counts in first-seen
// character order (Counter iteration order) and CPython 3.12+ builtin
// sum()'s Neumaier compensated accumulation (Python/bltinmodule.c) —
// plain left-to-right accumulation differs in the last ulp.
double entropy_of(std::string_view s) {
  if (s.empty()) return 0.0;
  int32_t count[256] = {0};
  unsigned char order[256];
  int n_distinct = 0;
  for (unsigned char c : s) {
    if (count[c]++ == 0) order[n_distinct++] = c;
  }
  double n = (double)s.size();
  double hi = 0.0, comp = 0.0;
  for (int i = 0; i < n_distinct; i++) {
    double p = (double)count[order[i]] / n;
    double x = -(p)*log2(p);
    double t = hi + x;
    if (fabs(hi) >= fabs(x))
      comp += (hi - t) + x;
    else
      comp += (x - t) + hi;
    hi = t;
  }
  return hi + comp;
}

constexpr int NCOLS = 8;
// Field indices (dns_pre_lda.scala:149; features/dns.py DNS_COLUMNS).
constexpr int C_TSTAMP = 1, C_FLEN = 2, C_IPDST = 3, C_QNAME = 4;
constexpr int C_QTYPE = 6, C_QRCODE = 7;
constexpr char SEP = '\x1f';

struct Dfz {
  std::string rows;                   // \x1f-joined fields, rows appended
  FILE* spill = nullptr;              // when set, rows stream here
  int64_t spill_len = 0;              // instead of the in-RAM blob
  bool spill_err = false;             // short write (ENOSPC etc.)
  std::string rowbuf;                 // reused per-row join buffer
  std::vector<int64_t> row_off{0};
  std::vector<double> tstamp_, flen_, entropy_;
  std::vector<int32_t> sublen_, nparts_;
  Interner ips, domains, subdomains, qtypes, qrcodes;
  std::vector<int32_t> ip_id, dom_id, sub_id, qtype_id, qrcode_id;
  int64_t num_raw = -1;
  // A CSV-sourced field containing the \x1f transport separator would
  // split into extra columns when the stored rows blob is re-split on
  // the Python side; flag it so the caller can discard this handle and
  // re-run through the pure-Python path instead of emitting misaligned
  // results rows.
  bool unsafe = false;

  // finish() outputs
  std::vector<int32_t> top;
  Interner words;
  std::vector<int32_t> word_id;
  std::vector<int32_t> wc_ip, wc_word;
  std::vector<int64_t> wc_cnt;

  // Wall spent in the deterministic merges of the parallel paths
  // (pass-A shard-table remap + pass-B word/count merge).
  int64_t merge_ns = 0;

  std::string error;

  void add_row(const std::string_view* f) {
    if (spill) {
      // Stored rows are only re-read at emit time; streaming them to
      // the spill file keeps RSS bounded by the numeric/interned
      // arrays.  Short writes must surface as errors, not as offsets
      // past the end of the file.
      rowbuf.clear();
      for (int i = 0; i < NCOLS; i++) {
        if (i) rowbuf += SEP;
        rowbuf.append(f[i].data(), f[i].size());
      }
      if (fwrite(rowbuf.data(), 1, rowbuf.size(), spill)
          != rowbuf.size()) {
        spill_err = true;
        error = "short write to rows spill file (disk full?)";
      }
      spill_len += (int64_t)rowbuf.size();
      row_off.push_back(spill_len);
    } else {
      for (int i = 0; i < NCOLS; i++) {
        if (i) rows += SEP;
        rows.append(f[i].data(), f[i].size());
      }
      row_off.push_back((int64_t)rows.size());
    }

    tstamp_.push_back(to_double(f[C_TSTAMP]));
    flen_.push_back(to_double(f[C_FLEN]));
    ip_id.push_back(ips.intern(f[C_IPDST]));
    qtype_id.push_back(qtypes.intern(f[C_QTYPE]));
    qrcode_id.push_back(qrcodes.intern(f[C_QRCODE]));

    // extract_subdomain (dns_pre_lda.scala:185-220 / features/dns.py).
    std::string_view url = f[C_QNAME];
    std::vector<std::string_view> parts;
    size_t start = 0;
    for (size_t i = 0; i <= url.size(); i++) {
      if (i == url.size() || url[i] == '.') {
        parts.push_back(url.substr(start, i - start));
        start = i + 1;
      }
    }
    while (parts.size() > 1 && parts.back().empty()) parts.pop_back();
    size_t n = parts.size();
    std::string_view domain = "None";
    std::string sub = "None";
    bool is_ip = n > 2 && parts[n - 1] == "arpa" && parts[n - 2] == "in-addr";
    if (n > 2 && !is_ip) {
      bool cc = country_codes().count(std::string(parts[n - 1])) > 0;
      size_t keep = cc ? n - 3 : n - 2;
      domain = parts[keep];
      if (keep >= 1) {
        sub.clear();
        for (size_t i = 0; i < keep; i++) {
          if (i) sub += '.';
          sub.append(parts[i].data(), parts[i].size());
        }
      } else if (!cc) {
        sub.clear();  // unreachable (keep = n-2 >= 1 when n > 2)
      }
    }
    dom_id.push_back(domains.intern(domain));
    sub_id.push_back(subdomains.intern(sub));
    sublen_.push_back(sub != "None" ? (int32_t)sub.size() : 0);
    nparts_.push_back((int32_t)n);
    entropy_.push_back(entropy_of(sub));
  }

  // Split a line on `sep`; keep iff exactly 8 fields.
  void add_line(std::string_view line, char sep) {
    // A CSV-sourced \x1f would re-split the stored rows blob.  An
    // embedded lone '\r' is fine here: rows are recovered by offsets,
    // not delimiters, and the Python fallback reader uses the same
    // line semantics (split on '\n', strip one trailing '\r'), so both
    // engines preserve it in the field.
    if (sep != SEP && line.find(SEP) != std::string_view::npos)
      unsafe = true;
    std::string_view f[NCOLS];
    int nf = 0;
    size_t start = 0;
    for (size_t i = 0; i <= line.size(); i++) {
      if (i == line.size() || line[i] == sep) {
        if (nf < NCOLS) f[nf] = line.substr(start, i - start);
        nf++;
        start = i + 1;
      }
    }
    if (nf == NCOLS) add_row(f);
  }

  void ingest(const char* buf, int64_t len, char sep, bool skip_empty) {
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
      const char* stop = nl ? nl : end;
      const char* s2 = stop;
      if (s2 > p && s2[-1] == '\r') s2--;
      std::string_view line(p, (size_t)(s2 - p));
      if (!(skip_empty && line.empty())) add_line(line, sep);
      p = nl ? nl + 1 : end;
    }
  }
};

// Pass-B state over one contiguous event range: binning, whitelist
// flag, word construction, first-seen per-client aggregation.  The
// sequential path runs one PassD over all events with `words` bound to
// h->words; the parallel path runs one per shard with a shard-local
// interner and merges deterministically in shard order — both walk
// each event through exactly this code (the flow featurizer's PassB
// design).
struct PassD {
  Dfz* h;
  Interner& words;
  const double* tc;
  const double* lc;
  const double* sc;
  const double* ec;
  const double* pc;
  int ntc, nlc, nsc, nec, npc;
  const std::vector<int32_t>& dom_top;

  oni::FlatMap64 pos;
  std::vector<int32_t> w_ip, w_w;  // word ids are in `words`
  std::vector<int64_t> w_c;

  // The word is a pure function of (top, 5 bins, qtype, qrcode); unique
  // combinations number far below the row count, so cache the interned
  // id behind a packed integer key and skip the per-row string build.
  // Packing limits (bins < 256, interner ids < 2048, top in 0..3) hold
  // for any real day; rows beyond them fall back to building the word.
  oni::FlatMap64 word_cache;
  std::string word;  // scratch

  PassD(Dfz* h_, Interner& w, const std::vector<int32_t>& dt,
        size_t expected)
      : h(h_), words(w), dom_top(dt), pos(expected / 2) {}

  void event(size_t i) {
    int bt = bin_of(h->tstamp_[i], tc, ntc);
    int bl = bin_of((double)h->flen_[i], lc, nlc);
    int bs = bin_of((double)h->sublen_[i], sc, nsc);
    int be = bin_of(h->entropy_[i], ec, nec);
    int bp = bin_of((double)h->nparts_[i], pc, npc);
    int tp = dom_top[(size_t)h->dom_id[i]];
    h->top[i] = tp;

    int32_t qt = h->qtype_id[i], qr = h->qrcode_id[i];
    bool cacheable =
        (unsigned)bt < 256 && (unsigned)bl < 256 && (unsigned)bs < 256 &&
        (unsigned)be < 256 && (unsigned)bp < 256 && (unsigned)tp < 4 &&
        (uint32_t)qt < 2048 && (uint32_t)qr < 2048;
    uint64_t wkey = 0;
    int64_t* wslot = nullptr;
    bool fresh = true;
    if (cacheable) {
      wkey = ((uint64_t)tp << 62) | ((uint64_t)bt << 54) |
             ((uint64_t)bl << 46) | ((uint64_t)bs << 38) |
             ((uint64_t)be << 30) | ((uint64_t)bp << 22) |
             ((uint64_t)(uint32_t)qt << 11) | (uint64_t)(uint32_t)qr;
      if (wkey != oni::FlatMap64::EMPTY)
        wslot = &word_cache.probe(wkey, &fresh);
    }
    int32_t wid;
    if (!fresh) {
      wid = (int32_t)*wslot;
    } else {
      // word = top_blen_btime_bsub_bent_bper_type_rcode
      // (dns_pre_lda.scala:320-327; raw type/rcode field text).
      word.clear();
      append_int(word, tp);
      word += '_';
      append_int(word, bl);
      word += '_';
      append_int(word, bt);
      word += '_';
      append_int(word, bs);
      word += '_';
      append_int(word, be);
      word += '_';
      append_int(word, bp);
      word += '_';
      word += h->qtypes.arena[(size_t)h->qtype_id[i]];
      word += '_';
      word += h->qrcodes.arena[(size_t)h->qrcode_id[i]];
      wid = words.intern(word);
      if (wslot) *wslot = wid;
    }
    h->word_id[i] = wid;

    uint64_t key = ((uint64_t)(uint32_t)h->ip_id[i] << 32) | (uint32_t)wid;
    int64_t& slot = pos.probe(key, &fresh);
    if (fresh) {
      slot = (int64_t)w_c.size();
      w_ip.push_back(h->ip_id[i]);
      w_w.push_back(wid);
      w_c.push_back(1);
    } else {
      w_c[(size_t)slot]++;
    }
  }
};

using oni::now_ns;

}  // namespace

extern "C" {

void* dfz_create() { return new Dfz(); }
void dfz_destroy(void* hv) {
  Dfz* h = (Dfz*)hv;
  if (h->spill) fclose(h->spill);
  delete h;
}
const char* dfz_error(void* h) { return ((Dfz*)h)->error.c_str(); }

// Route stored rows to `path` instead of RAM.  Must be called before
// any ingest — row offsets are absolute positions in ONE store, so
// retargeting mid-run (or after in-RAM rows exist) would make them
// read past EOF / wrong bytes at emit.  -1 with dfz_error set on
// misuse or when the file can't open.
int dfz_set_spill(void* hv, const char* path) {
  Dfz* h = (Dfz*)hv;
  if (!h->tstamp_.empty() || h->spill) {
    h->error = "dfz_set_spill must be called once, before any ingest";
    return -1;
  }
  h->spill = fopen(path, "wb");
  if (!h->spill) {
    h->error = std::string("cannot open spill file ") + path;
    return -1;
  }
  return 0;
}

// Returns the spilled byte count, or -1 when any write/flush failed.
int64_t dfz_spill_flush(void* hv) {
  Dfz* h = (Dfz*)hv;
  if (h->spill) {
    if (fflush(h->spill) != 0 || ferror(h->spill)) {
      h->spill_err = true;
      if (h->error.empty())
        h->error = "flush of rows spill file failed (disk full?)";
    }
  }
  return h->spill_err ? -1 : h->spill_len;
}

int64_t dfz_ingest_csv_file(void* hv, const char* path, int skip_header) {
  Dfz* h = (Dfz*)hv;
  bool skipping = skip_header != 0;
  bool ok = oni::stream_file(
      path, h->error, [h, &skipping](const char* p, int64_t n) {
        if (skipping) {
          const char* nl = (const char*)memchr(p, '\n', (size_t)n);
          if (!nl) return;  // header longer than this buffer
          skipping = false;
          n -= (nl + 1 - p);
          p = nl + 1;
        }
        h->ingest(p, n, ',', /*skip_empty=*/true);
      });
  return (ok && !h->spill_err) ? (int64_t)h->tstamp_.size() : -1;
}

// Rows pre-split by the caller (parquet, feedback): fields joined by
// \x1f, rows by \n.
int64_t dfz_ingest_rows(void* hv, const char* buf, int64_t len) {
  Dfz* h = (Dfz*)hv;
  h->ingest(buf, len, SEP, /*skip_empty=*/true);
  return h->spill_err ? -1 : (int64_t)h->tstamp_.size();
}

int dfz_unsafe(void* hv) { return ((Dfz*)hv)->unsafe ? 1 : 0; }

void dfz_mark_raw(void* hv) {
  Dfz* h = (Dfz*)hv;
  h->num_raw = (int64_t)h->tstamp_.size();
}
int64_t dfz_num_raw(void* hv) {
  Dfz* h = (Dfz*)hv;
  return h->num_raw >= 0 ? h->num_raw : (int64_t)h->tstamp_.size();
}
int64_t dfz_num_events(void* hv) {
  return (int64_t)((Dfz*)hv)->tstamp_.size();
}

const double* dfz_tstamp(void* h) { return ((Dfz*)h)->tstamp_.data(); }
const double* dfz_frame_len(void* h) { return ((Dfz*)h)->flen_.data(); }
const double* dfz_entropy(void* h) { return ((Dfz*)h)->entropy_.data(); }
const int32_t* dfz_sublen(void* h) { return ((Dfz*)h)->sublen_.data(); }
const int32_t* dfz_nparts(void* h) { return ((Dfz*)h)->nparts_.data(); }

// Shard the CSV file into line-aligned byte ranges and run pass A over
// them on `workers` std::threads, each into its own shard-local Dfz,
// then merge in shard order: every shard-local interner (client IPs,
// domains, subdomains, qtypes, qrcodes) re-interns into the parent in
// local first-seen order, reproducing the sequential first-seen order
// exactly (flow_featurize.cpp ffz_ingest_file_parallel design notes;
// spill handling and RSS tradeoff identical).
int64_t dfz_ingest_csv_file_parallel(void* hv, const char* path,
                                     int skip_header, int workers) {
  Dfz* h = (Dfz*)hv;
  if (workers <= 1) return dfz_ingest_csv_file(hv, path, skip_header);
  int64_t size = oni::file_size_of(path);
  if (size < 0) {
    h->error = std::string("cannot open ") + path;
    return -1;
  }
  int64_t data_start = 0;
  if (skip_header) {
    std::string hdr, err;
    if (!oni::read_first_line(path, hdr, &data_start, err)) {
      if (!err.empty()) {
        h->error = err;
        return -1;
      }
      // No '\n' at all: the whole file is the header — nothing to
      // ingest (the sequential path drops it the same way).
      return (int64_t)h->tstamp_.size();
    }
  }
  std::string err;
  std::vector<int64_t> bounds =
      oni::shard_bounds(path, data_start, size, workers, err);
  if (bounds.empty()) {
    h->error = err;
    return -1;
  }
  std::vector<std::unique_ptr<Dfz>> shards((size_t)workers);
  std::vector<int> ok((size_t)workers, 1);
  std::vector<std::thread> threads;
  for (int k = 0; k < workers; k++) {
    shards[(size_t)k] = std::make_unique<Dfz>();
    Dfz* w = shards[(size_t)k].get();
    int64_t lo = bounds[(size_t)k], hi = bounds[(size_t)k + 1];
    threads.emplace_back([w, path, lo, hi, &ok, k] {
      ok[(size_t)k] = oni::stream_file_range(
                          path, lo, hi, w->error,
                          [w](const char* p, int64_t n) {
                            w->ingest(p, n, ',', /*skip_empty=*/true);
                          })
                          ? 1
                          : 0;
    });
  }
  for (auto& t : threads) t.join();
  for (int k = 0; k < workers; k++) {
    if (!ok[(size_t)k]) {
      h->error = shards[(size_t)k]->error;
      return -1;
    }
  }

  int64_t t0 = now_ns();
  {
    size_t tot_ev = 0, tot_bytes = 0;
    for (int k = 0; k < workers; k++) {
      tot_ev += shards[(size_t)k]->tstamp_.size();
      tot_bytes += shards[(size_t)k]->rows.size();
    }
    h->tstamp_.reserve(h->tstamp_.size() + tot_ev);
    h->flen_.reserve(h->flen_.size() + tot_ev);
    h->entropy_.reserve(h->entropy_.size() + tot_ev);
    h->sublen_.reserve(h->sublen_.size() + tot_ev);
    h->nparts_.reserve(h->nparts_.size() + tot_ev);
    h->row_off.reserve(h->row_off.size() + tot_ev);
    if (!h->spill) h->rows.reserve(h->rows.size() + tot_bytes);
  }
  for (int k = 0; k < workers; k++) {
    Dfz* w = shards[(size_t)k].get();
    h->unsafe = h->unsafe || w->unsafe;
    // Remap every shard-local interner into the parent (local
    // first-seen order -> global first-seen order).
    Interner* locals[5] = {&w->ips, &w->domains, &w->subdomains,
                           &w->qtypes, &w->qrcodes};
    Interner* globals[5] = {&h->ips, &h->domains, &h->subdomains,
                            &h->qtypes, &h->qrcodes};
    std::vector<int32_t>* ids[5] = {&w->ip_id, &w->dom_id, &w->sub_id,
                                    &w->qtype_id, &w->qrcode_id};
    std::vector<int32_t>* outs[5] = {&h->ip_id, &h->dom_id, &h->sub_id,
                                     &h->qtype_id, &h->qrcode_id};
    for (int t = 0; t < 5; t++) {
      std::vector<int32_t> map(locals[t]->arena.size());
      for (size_t j = 0; j < locals[t]->arena.size(); j++)
        map[j] = globals[t]->intern(locals[t]->arena[j]);
      outs[t]->reserve(outs[t]->size() + ids[t]->size());
      for (int32_t lid : *ids[t])
        outs[t]->push_back(map[(size_t)lid]);
    }
    h->tstamp_.insert(h->tstamp_.end(), w->tstamp_.begin(),
                      w->tstamp_.end());
    h->flen_.insert(h->flen_.end(), w->flen_.begin(), w->flen_.end());
    h->entropy_.insert(h->entropy_.end(), w->entropy_.begin(),
                       w->entropy_.end());
    h->sublen_.insert(h->sublen_.end(), w->sublen_.begin(),
                      w->sublen_.end());
    h->nparts_.insert(h->nparts_.end(), w->nparts_.begin(),
                      w->nparts_.end());
    if (h->spill) {
      if (!w->rows.empty() &&
          fwrite(w->rows.data(), 1, w->rows.size(), h->spill) !=
              w->rows.size()) {
        h->spill_err = true;
        h->error = "short write to rows spill file (disk full?)";
      }
      for (size_t j = 1; j < w->row_off.size(); j++)
        h->row_off.push_back(h->spill_len + w->row_off[j]);
      h->spill_len += (int64_t)w->rows.size();
    } else {
      int64_t base = (int64_t)h->rows.size();
      h->rows += w->rows;
      for (size_t j = 1; j < w->row_off.size(); j++)
        h->row_off.push_back(base + w->row_off[j]);
    }
    shards[(size_t)k].reset();  // free shard memory as the merge walks
  }
  h->merge_ns += now_ns() - t0;
  return h->spill_err ? -1 : (int64_t)h->tstamp_.size();
}

int64_t dfz_merge_ns(void* hv) { return ((Dfz*)hv)->merge_ns; }

static void build_dom_top(Dfz* h, const char* top_blob, int64_t top_len,
                          std::vector<int32_t>& dom_top) {
  std::unordered_set<std::string_view> top_set;
  const char* p = top_blob;
  const char* end = top_blob + top_len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* stop = nl ? nl : end;
    if (stop > p) top_set.emplace(p, (size_t)(stop - p));
    p = nl ? nl + 1 : end;
  }
  // Whitelist flag per unique domain, not per row.
  dom_top.resize(h->domains.arena.size());
  for (size_t i = 0; i < h->domains.arena.size(); i++) {
    const std::string& d = h->domains.arena[i];
    dom_top[i] = d == "intel" ? 2 : (top_set.count(d) ? 1 : 0);
  }
}

// top_blob: '\n'-joined whitelisted base-domain names (load_top_domains
// output), decoded into a set for the flag pass.
int dfz_finish(void* hv, const double* tc, int ntc, const double* lc,
               int nlc, const double* sc, int nsc, const double* ec, int nec,
               const double* pc, int npc, const char* top_blob,
               int64_t top_len) {
  Dfz* h = (Dfz*)hv;
  size_t n = h->tstamp_.size();

  std::vector<int32_t> dom_top;
  build_dom_top(h, top_blob, top_len, dom_top);

  h->top.resize(n);
  h->word_id.resize(n);

  PassD p(h, h->words, dom_top, n);
  p.tc = tc;
  p.lc = lc;
  p.sc = sc;
  p.ec = ec;
  p.pc = pc;
  p.ntc = ntc;
  p.nlc = nlc;
  p.nsc = nsc;
  p.nec = nec;
  p.npc = npc;
  for (size_t i = 0; i < n; i++) p.event(i);

  h->wc_ip = std::move(p.w_ip);
  h->wc_word = std::move(p.w_w);
  h->wc_cnt = std::move(p.w_c);
  return 0;
}

// Pass B over `workers` contiguous event ranges (shard-local word
// interners + first-seen maps), merged deterministically in shard
// order — byte-identical output to dfz_finish given identical cuts
// (flow_featurize.cpp ffz_finish_mt design notes).
int dfz_finish_mt(void* hv, const double* tc, int ntc, const double* lc,
                  int nlc, const double* sc, int nsc, const double* ec,
                  int nec, const double* pc, int npc, const char* top_blob,
                  int64_t top_len, int workers) {
  Dfz* h = (Dfz*)hv;
  size_t n = h->tstamp_.size();
  if (workers <= 1 || n < 2)
    return dfz_finish(hv, tc, ntc, lc, nlc, sc, nsc, ec, nec, pc, npc,
                      top_blob, top_len);
  if ((size_t)workers > n) workers = (int)n;

  std::vector<int32_t> dom_top;
  build_dom_top(h, top_blob, top_len, dom_top);
  h->top.resize(n);
  h->word_id.resize(n);

  std::vector<std::unique_ptr<Interner>> local_words((size_t)workers);
  std::vector<std::unique_ptr<PassD>> passes((size_t)workers);
  std::vector<std::thread> threads;
  for (int k = 0; k < workers; k++) {
    size_t lo = n * (size_t)k / (size_t)workers;
    size_t hi = n * ((size_t)k + 1) / (size_t)workers;
    local_words[(size_t)k] = std::make_unique<Interner>();
    passes[(size_t)k] = std::make_unique<PassD>(
        h, *local_words[(size_t)k], dom_top, hi - lo);
    PassD* p = passes[(size_t)k].get();
    p->tc = tc;
    p->lc = lc;
    p->sc = sc;
    p->ec = ec;
    p->pc = pc;
    p->ntc = ntc;
    p->nlc = nlc;
    p->nsc = nsc;
    p->nec = nec;
    p->npc = npc;
    threads.emplace_back([p, lo, hi] {
      for (size_t i = lo; i < hi; i++) p->event(i);
    });
  }
  for (auto& t : threads) t.join();

  int64_t t0 = now_ns();
  // Sequential word interning (order is the id contract), parallel
  // per-range id rewrites, merge maps pre-sized for the real entry
  // totals (flow ffz_finish_mt design notes).
  std::vector<std::vector<int32_t>> wmaps((size_t)workers);
  for (int k = 0; k < workers; k++) {
    Interner& lw = *local_words[(size_t)k];
    std::vector<int32_t>& wmap = wmaps[(size_t)k];
    wmap.resize(lw.arena.size());
    for (size_t j = 0; j < lw.arena.size(); j++)
      wmap[j] = h->words.intern(lw.arena[j]);
  }
  {
    std::vector<std::thread> rewrite;
    for (int k = 0; k < workers; k++) {
      const std::vector<int32_t>* wmap = &wmaps[(size_t)k];
      size_t lo = n * (size_t)k / (size_t)workers;
      size_t hi = n * ((size_t)k + 1) / (size_t)workers;
      rewrite.emplace_back([h, wmap, lo, hi] {
        for (size_t i = lo; i < hi; i++)
          h->word_id[i] = (*wmap)[(size_t)h->word_id[i]];
      });
    }
    for (auto& t : rewrite) t.join();
  }
  size_t tot = 0;
  for (int k = 0; k < workers; k++) tot += passes[(size_t)k]->w_c.size();
  oni::FlatMap64 pos(tot);
  std::vector<int32_t> w_ip, w_w;
  std::vector<int64_t> w_c;
  w_ip.reserve(tot);
  w_w.reserve(tot);
  w_c.reserve(tot);
  for (int k = 0; k < workers; k++) {
    const std::vector<int32_t>& wmap = wmaps[(size_t)k];
    PassD& p = *passes[(size_t)k];
    for (size_t e = 0; e < p.w_c.size(); e++) {
      int32_t gw = wmap[(size_t)p.w_w[e]];
      uint64_t key =
          ((uint64_t)(uint32_t)p.w_ip[e] << 32) | (uint32_t)gw;
      bool fresh;
      int64_t& slot = pos.probe(key, &fresh);
      if (fresh) {
        slot = (int64_t)w_c.size();
        w_ip.push_back(p.w_ip[e]);
        w_w.push_back(gw);
        w_c.push_back(p.w_c[e]);
      } else {
        w_c[(size_t)slot] += p.w_c[e];
      }
    }
    passes[(size_t)k].reset();
  }
  h->wc_ip = std::move(w_ip);
  h->wc_word = std::move(w_w);
  h->wc_cnt = std::move(w_c);
  h->merge_ns += now_ns() - t0;
  return 0;
}

const int32_t* dfz_top(void* h) { return ((Dfz*)h)->top.data(); }

const int32_t* dfz_ids(void* hv, int which) {
  Dfz* h = (Dfz*)hv;
  switch (which) {
    case 0: return h->ip_id.data();
    case 1: return h->dom_id.data();
    case 2: return h->sub_id.data();
    case 3: return h->word_id.data();
    default: return nullptr;
  }
}

static Interner& dtable_of(void* hv, int which) {
  Dfz* h = (Dfz*)hv;
  switch (which) {
    case 0: return h->ips;
    case 1: return h->domains;
    case 2: return h->subdomains;
    default: return h->words;
  }
}
int64_t dfz_table_count(void* hv, int which) {
  return (int64_t)dtable_of(hv, which).arena.size();
}
const char* dfz_table_blob(void* hv, int which) {
  Interner& t = dtable_of(hv, which);
  t.build_export();
  return t.blob.data();
}
int64_t dfz_table_blob_len(void* hv, int which) {
  Interner& t = dtable_of(hv, which);
  t.build_export();
  return (int64_t)t.blob.size();
}
const int64_t* dfz_table_offsets(void* hv, int which) {
  Interner& t = dtable_of(hv, which);
  t.build_export();
  return t.offsets.data();
}

const char* dfz_rows_blob(void* hv) {
  Dfz* h = (Dfz*)hv;
  return h->spill ? nullptr : h->rows.data();  // spilled: read the file
}
int64_t dfz_rows_blob_len(void* hv) {
  Dfz* h = (Dfz*)hv;
  return h->spill ? h->spill_len : (int64_t)h->rows.size();
}
const int64_t* dfz_row_offsets(void* hv) {
  return ((Dfz*)hv)->row_off.data();
}

int64_t dfz_wc_len(void* hv) { return (int64_t)((Dfz*)hv)->wc_cnt.size(); }
const int32_t* dfz_wc_ip(void* hv) { return ((Dfz*)hv)->wc_ip.data(); }
const int32_t* dfz_wc_word(void* hv) { return ((Dfz*)hv)->wc_word.data(); }
const int64_t* dfz_wc_count(void* hv) { return ((Dfz*)hv)->wc_cnt.data(); }

}  // extern "C"
