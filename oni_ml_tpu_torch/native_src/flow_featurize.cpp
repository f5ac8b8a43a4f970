// Native netflow featurizer — the C++ fast path for the flow "pre"
// stage (flow_pre_lda.scala featurization, reimplemented in
// oni_ml_tpu/features/flow.py).  The Python path runs ~140k rows/s;
// a 30-day corpus (BASELINE config 3) needs millions of rows/s, which
// is exactly the scale the reference threw a Spark/YARN cluster at
// (SURVEY.md §2.2).  This does the same work in one process: parse +
// filter, numeric extraction, binning, word construction, and per-IP
// word-count aggregation.
//
// Split of responsibilities with Python (oni_ml_tpu/features/native_flow.py):
//   pass A (ingest_*): line filtering (removeHeader + 27-field check),
//     numeric columns (fractional time, ibyt, ipkt, the swapped
//     port columns), IP interning, raw-line retention.
//   cuts: Python computes ECDF cuts from pass-A arrays with the SAME
//     quantiles.ecdf_cuts used by the Python path — one semantics, one
//     implementation (SURVEY §7 hard part (b)).
//   pass B (finish): bin by cuts, adjust_port word construction with
//     JVM-double formatting, word interning, first-seen-order word
//     counts (src docs then dest docs, flow_pre_lda.scala:366-373).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  All
// pointers returned by getters stay valid until ffz_destroy.
//
// Known deliberate divergences from Python float():  underscored
// numerals ("1_0") and unusual unicode whitespace are rejected (NaN) —
// neither occurs in netflow CSVs.

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
#include <vector>

namespace {

using oni::jvm_double;

constexpr int NCOLS = 27;
// Column indices (flow_pre_lda.scala:46-72); 10/11 keep the reference's
// swapped dport/sport naming (oni_ml_tpu/features/flow.py docstring).
constexpr int C_HOUR = 4, C_MIN = 5, C_SEC = 6, C_SIP = 8, C_DIP = 9;
constexpr int C_10 = 10, C_11 = 11, C_IPKT = 16, C_IBYT = 17;

using oni::Interner;
using oni::to_double;
using oni::bin_of;

struct Ffz {
  bool skip_header;
  bool have_header = false;
  std::string header;

  std::string lines;                   // stripped kept rows, concatenated
  FILE* spill = nullptr;               // when set, rows stream here
  int64_t spill_len = 0;               // instead of the in-RAM blob
  bool spill_err = false;              // short write (ENOSPC etc.)
  std::vector<int64_t> line_off{0};
  std::vector<double> time_, ibyt_, ipkt_, c10_, c11_;
  Interner ips;
  std::vector<int32_t> sip_id, dip_id;
  int64_t num_raw = -1;

  // finish() outputs
  std::vector<int32_t> tbin, bbin, pbin;
  Interner words;
  std::vector<int32_t> wp_id, sw_id, dw_id;
  std::vector<int32_t> wc_ip, wc_word;
  std::vector<int64_t> wc_cnt;

  // Wall spent in the DETERMINISTIC merges of the parallel paths
  // (pass-A shard-table remap + pass-B word/count merge) — the
  // sequential-overhead term the runner reports as merge_wall_s.
  int64_t merge_ns = 0;

  std::string error;

  void add_line(std::string_view raw) {
    // Mirror the Python path: lines are compared for removeHeader
    // before strip, then stripped and split.
    if (skip_header) {
      if (!have_header) {
        header.assign(raw);
        have_header = true;
        return;
      }
      if (raw == header) return;
    }
    size_t b = 0, e = raw.size();
    while (b < e && oni::ascii_space(raw[b])) b++;
    while (e > b && oni::ascii_space(raw[e - 1])) e--;
    std::string_view line = raw.substr(b, e - b);

    std::string_view f[NCOLS];
    int nf = 0;
    size_t start = 0;
    for (size_t i = 0; i <= line.size(); i++) {
      if (i == line.size() || line[i] == ',') {
        if (nf < NCOLS) f[nf] = line.substr(start, i - start);
        nf++;
        start = i + 1;
      }
    }
    if (nf != NCOLS) return;

    if (spill) {
      // Raw rows are only re-read at emit time (for flagged events);
      // streaming them to the spill file keeps RSS bounded by the
      // numeric arrays however many days are ingested.  A short write
      // (ENOSPC mid-way through a 30-day ingest) must surface as an
      // error, not as offsets pointing past the end of the file.
      if (fwrite(line.data(), 1, line.size(), spill) != line.size()) {
        spill_err = true;
        error = "short write to raw-lines spill file (disk full?)";
      }
      spill_len += (int64_t)line.size();
      line_off.push_back(spill_len);
    } else {
      lines.append(line.data(), line.size());
      line_off.push_back((int64_t)lines.size());
    }
    double h = to_double(f[C_HOUR]), m = to_double(f[C_MIN]),
           s = to_double(f[C_SEC]);
    time_.push_back(h + m / 60.0 + s / 3600.0);
    ibyt_.push_back(to_double(f[C_IBYT]));
    ipkt_.push_back(to_double(f[C_IPKT]));
    c10_.push_back(to_double(f[C_10]));
    c11_.push_back(to_double(f[C_11]));
    sip_id.push_back(ips.intern(f[C_SIP]));
    dip_id.push_back(ips.intern(f[C_DIP]));
  }

  void ingest_buffer(const char* buf, int64_t len) {
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
      const char* stop = nl ? nl : end;
      // Drop one trailing '\r' (text files from Windows exports).
      const char* s2 = stop;
      if (s2 > p && s2[-1] == '\r') s2--;
      add_line(std::string_view(p, (size_t)(s2 - p)));
      p = nl ? nl + 1 : end;
    }
  }
};

// Pass-B state over one contiguous event range: binning, adjust_port
// word construction, and first-seen (doc, word) aggregation.  The
// sequential path runs ONE PassB over all events with `words` bound to
// h->words; the parallel path runs one per shard with a shard-local
// interner, then merges deterministically in shard order — both walk
// each event through exactly this code, so the per-event logic cannot
// drift between the two paths.
struct PassB {
  Ffz* h;
  Interner& words;
  const double* tc;
  const double* bc;
  const double* pc;
  int ntc, nbc, npc;
  // First-seen-order (doc, word) counts; src map emitted before dest
  // (flow_pre_lda.scala:366-373 union order).  FlatMap64 (common.h):
  // unordered_map's node churn made these probes the hottest block of
  // the whole pipeline.
  oni::FlatMap64 src_pos, dst_pos;
  std::vector<int32_t> s_ip, s_w, d_ip, d_w;  // word ids are in `words`
  std::vector<int64_t> s_c, d_c;
  // Words are a function of (word_port, time_bin, ibyt_bin, ipkt_bin):
  // the unique combinations number in the thousands while rows number
  // in the millions, so cache (wp_id, bins) -> (base, prefixed) word
  // ids and skip the string building on the hot path.  Port doubles
  // are keyed by bit pattern (our NaNs are the single NAN constant
  // from to_double).
  oni::FlatMap64 wp_cache;    // port bits -> wp_id
  oni::FlatMap64 word_cache;  // wp_id+bins -> (base, prefixed) packed
  std::string word;           // scratch

  PassB(Ffz* h_, Interner& w, size_t expected)
      : h(h_), words(w), src_pos(expected / 2), dst_pos(expected / 2) {}

  void event(size_t i) {
    int tb = bin_of(h->time_[i], tc, ntc);
    int bb = bin_of(h->ibyt_[i], bc, nbc);
    int pb = bin_of(h->ipkt_[i], pc, npc);
    h->tbin[i] = tb;
    h->bbin[i] = bb;
    h->pbin[i] = pb;

    // adjust_port (flow_pre_lda.scala:317-359; see features/flow.py for
    // the case table).  dport := col10, sport := col11 (reference swap).
    double dport = h->c10_[i], sport = h->c11_[i];
    double lo = (sport < dport) ? sport : dport;  // std::min semantics
    double hi = (dport < sport) ? sport : dport;  // std::max semantics
    int p_case;
    double word_port;
    if ((dport <= 1024 || sport <= 1024) && (dport > 1024 || sport > 1024) &&
        lo != 0) {
      p_case = 2;
      word_port = lo;
    } else if (dport > 1024 && sport > 1024) {
      p_case = 3;
      word_port = 333333.0;
    } else if (dport == 0 && sport != 0) {
      p_case = 4;
      word_port = sport;
    } else if (sport == 0 && dport != 0) {
      p_case = 4;
      word_port = dport;
    } else {
      p_case = 1;
      word_port = (lo == 0) ? hi : 111111.0;
    }

    uint64_t wp_bits;
    memcpy(&wp_bits, &word_port, 8);
    int32_t wp_id;
    if (wp_bits == oni::FlatMap64::EMPTY) {
      // A hostile "-nan(0xf...f)" field bit-patterns to the map's empty
      // sentinel; skip the cache (the interner still dedupes).
      wp_id = words.intern(jvm_double(word_port));
    } else {
      bool fresh;
      int64_t& slot = wp_cache.probe(wp_bits, &fresh);
      if (fresh) slot = words.intern(jvm_double(word_port));
      wp_id = (int32_t)slot;
    }

    bool src_prefixed =
        (p_case == 2 && sport < dport) || (p_case == 4 && dport == 0);
    bool dst_prefixed =
        (p_case == 2 && dport < sport) || (p_case == 4 && sport == 0);

    // Bins are bounded by the cut counts; the finish entry points
    // reject cut lists that would overflow the 12-bit fields.  A wp_id
    // past 28 bits (>268M distinct port strings) skips the cache
    // instead of aliasing.
    uint64_t wkey = ((uint64_t)(uint32_t)wp_id << 36) |
                    ((uint64_t)tb << 24) | ((uint64_t)bb << 12) | (uint64_t)pb;
    bool cacheable = (uint32_t)wp_id < (1u << 28) &&
                     wkey != oni::FlatMap64::EMPTY;
    bool fresh = true;
    int64_t* wslot = nullptr;
    if (cacheable) wslot = &word_cache.probe(wkey, &fresh);
    struct WordIds {
      int32_t base, prefixed;
    } wi;
    if (!fresh) {
      wi.base = (int32_t)(uint32_t)(*wslot >> 32);
      wi.prefixed = (int32_t)(uint32_t)*wslot;
    } else {
      word.clear();
      word += words.arena[(size_t)wp_id];
      word += '_';
      word += jvm_double((double)tb);
      word += '_';
      word += jvm_double((double)bb);
      word += '_';
      word += jvm_double((double)pb);
      wi.base = words.intern(word);
      wi.prefixed = words.intern("-1_" + word);
      if (wslot)
        *wslot = ((int64_t)(uint32_t)wi.base << 32) | (uint32_t)wi.prefixed;
    }
    int32_t src_wid = src_prefixed ? wi.prefixed : wi.base;
    int32_t dst_wid = dst_prefixed ? wi.prefixed : wi.base;
    h->wp_id[i] = wp_id;
    h->sw_id[i] = src_wid;
    h->dw_id[i] = dst_wid;

    uint64_t ks = ((uint64_t)(uint32_t)h->sip_id[i] << 32) |
                  (uint32_t)src_wid;
    int64_t& sslot = src_pos.probe(ks, &fresh);
    if (fresh) {
      sslot = (int64_t)s_c.size();
      s_ip.push_back(h->sip_id[i]);
      s_w.push_back(src_wid);
      s_c.push_back(1);
    } else {
      s_c[(size_t)sslot]++;
    }
    uint64_t kd = ((uint64_t)(uint32_t)h->dip_id[i] << 32) |
                  (uint32_t)dst_wid;
    int64_t& dslot = dst_pos.probe(kd, &fresh);
    if (fresh) {
      dslot = (int64_t)d_c.size();
      d_ip.push_back(h->dip_id[i]);
      d_w.push_back(dst_wid);
      d_c.push_back(1);
    } else {
      d_c[(size_t)dslot]++;
    }
  }
};

using oni::now_ns;

}  // namespace

extern "C" {

void* ffz_create(int skip_header) {
  Ffz* h = new Ffz();
  h->skip_header = skip_header != 0;
  return h;
}
void ffz_destroy(void* hv) {
  Ffz* h = (Ffz*)hv;
  if (h->spill) fclose(h->spill);
  delete h;
}

// Route kept raw rows to `path` instead of RAM.  Must be called once,
// before any ingest — line offsets are absolute positions in ONE
// store, so retargeting mid-run (or after in-RAM rows exist) would
// make them read past EOF / wrong bytes at emit; -1 with ffz_error set
// on misuse or when the file can't open.  ffz_spill_flush makes the
// bytes visible to a reader (mmap) — the handle stays open so later
// ingests (feedback rows) keep appending.
int ffz_set_spill(void* hv, const char* path) {
  Ffz* h = (Ffz*)hv;
  if (!h->time_.empty() || h->spill) {
    h->error = "ffz_set_spill must be called once, before any ingest";
    return -1;
  }
  h->spill = fopen(path, "wb");
  if (!h->spill) {
    h->error = std::string("cannot open spill file ") + path;
    return -1;
  }
  return 0;
}

// Returns the spilled byte count, or -1 when any write/flush failed
// (ffz_error describes it) — callers must not mmap a short file.
int64_t ffz_spill_flush(void* hv) {
  Ffz* h = (Ffz*)hv;
  if (h->spill) {
    if (fflush(h->spill) != 0 || ferror(h->spill)) {
      h->spill_err = true;
      if (h->error.empty())
        h->error = "flush of raw-lines spill file failed (disk full?)";
    }
  }
  return h->spill_err ? -1 : h->spill_len;
}
const char* ffz_error(void* h) { return ((Ffz*)h)->error.c_str(); }

int64_t ffz_ingest_file(void* hv, const char* path) {
  Ffz* h = (Ffz*)hv;
  bool ok = oni::stream_file(path, h->error, [h](const char* p, int64_t n) {
    h->ingest_buffer(p, n);
  });
  return (ok && !h->spill_err) ? (int64_t)h->time_.size() : -1;
}

int64_t ffz_ingest_buffer(void* hv, const char* buf, int64_t len) {
  Ffz* h = (Ffz*)hv;
  h->ingest_buffer(buf, len);
  return h->spill_err ? -1 : (int64_t)h->time_.size();
}

void ffz_mark_raw(void* hv) {
  Ffz* h = (Ffz*)hv;
  h->num_raw = (int64_t)h->time_.size();
}
int64_t ffz_num_raw(void* hv) {
  Ffz* h = (Ffz*)hv;
  return h->num_raw >= 0 ? h->num_raw : (int64_t)h->time_.size();
}
int64_t ffz_num_events(void* hv) { return (int64_t)((Ffz*)hv)->time_.size(); }

const double* ffz_num_time(void* h) { return ((Ffz*)h)->time_.data(); }
const double* ffz_ibyt(void* h) { return ((Ffz*)h)->ibyt_.data(); }
const double* ffz_ipkt(void* h) { return ((Ffz*)h)->ipkt_.data(); }

// Shard the file into line-aligned byte ranges and run pass A over
// them on `workers` std::threads, each into its own shard-local Ffz
// (own interner, own arrays, rows buffered in RAM), then merge in
// shard order: shard-local ip ids are re-interned into the parent in
// local first-seen order, which reproduces the SEQUENTIAL first-seen
// order exactly — every merged array, table, and downstream artifact
// is byte-identical to ffz_ingest_file's.  The header contract is
// preserved by pre-reading the first line of the first file into the
// parent (workers then drop equal lines, including shard 0's copy).
// With a spill file active, kept rows buffer per shard and append to
// the spill at merge time — peak RSS grows by roughly ONE file's kept
// bytes (freed shard-by-shard), not the whole multi-file corpus.
int64_t ffz_ingest_file_parallel(void* hv, const char* path, int workers) {
  Ffz* h = (Ffz*)hv;
  if (workers <= 1) return ffz_ingest_file(hv, path);
  int64_t size = oni::file_size_of(path);
  if (size < 0) {
    h->error = std::string("cannot open ") + path;
    return -1;
  }
  if (h->skip_header && !h->have_header) {
    std::string hdr, err;
    if (!oni::read_first_line(path, hdr, nullptr, err)) {
      if (!err.empty()) {
        h->error = err;
        return -1;
      }
      // No '\n' anywhere: the whole file is one line — sequential
      // semantics (it becomes the header) with none of the threading.
      return ffz_ingest_file(hv, path);
    }
    h->header = hdr;
    h->have_header = true;
  }
  std::string err;
  std::vector<int64_t> bounds =
      oni::shard_bounds(path, 0, size, workers, err);
  if (bounds.empty()) {
    h->error = err;
    return -1;
  }
  std::vector<std::unique_ptr<Ffz>> shards((size_t)workers);
  std::vector<int> ok((size_t)workers, 1);
  std::vector<std::thread> threads;
  for (int k = 0; k < workers; k++) {
    shards[(size_t)k] = std::make_unique<Ffz>();
    Ffz* w = shards[(size_t)k].get();
    w->skip_header = h->skip_header;
    w->have_header = h->have_header;
    w->header = h->header;
    int64_t lo = bounds[(size_t)k], hi = bounds[(size_t)k + 1];
    threads.emplace_back([w, path, lo, hi, &ok, k] {
      ok[(size_t)k] = oni::stream_file_range(
                          path, lo, hi, w->error,
                          [w](const char* p, int64_t n) {
                            w->ingest_buffer(p, n);
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
      tot_ev += shards[(size_t)k]->time_.size();
      tot_bytes += shards[(size_t)k]->lines.size();
    }
    h->time_.reserve(h->time_.size() + tot_ev);
    h->ibyt_.reserve(h->ibyt_.size() + tot_ev);
    h->ipkt_.reserve(h->ipkt_.size() + tot_ev);
    h->c10_.reserve(h->c10_.size() + tot_ev);
    h->c11_.reserve(h->c11_.size() + tot_ev);
    h->sip_id.reserve(h->sip_id.size() + tot_ev);
    h->dip_id.reserve(h->dip_id.size() + tot_ev);
    h->line_off.reserve(h->line_off.size() + tot_ev);
    if (!h->spill) h->lines.reserve(h->lines.size() + tot_bytes);
  }
  for (int k = 0; k < workers; k++) {
    Ffz* w = shards[(size_t)k].get();
    std::vector<int32_t> ipmap(w->ips.arena.size());
    for (size_t j = 0; j < w->ips.arena.size(); j++)
      ipmap[j] = h->ips.intern(w->ips.arena[j]);
    size_t wn = w->time_.size();
    h->time_.insert(h->time_.end(), w->time_.begin(), w->time_.end());
    h->ibyt_.insert(h->ibyt_.end(), w->ibyt_.begin(), w->ibyt_.end());
    h->ipkt_.insert(h->ipkt_.end(), w->ipkt_.begin(), w->ipkt_.end());
    h->c10_.insert(h->c10_.end(), w->c10_.begin(), w->c10_.end());
    h->c11_.insert(h->c11_.end(), w->c11_.begin(), w->c11_.end());
    h->sip_id.reserve(h->sip_id.size() + wn);
    h->dip_id.reserve(h->dip_id.size() + wn);
    for (size_t i = 0; i < wn; i++) {
      h->sip_id.push_back(ipmap[(size_t)w->sip_id[i]]);
      h->dip_id.push_back(ipmap[(size_t)w->dip_id[i]]);
    }
    if (h->spill) {
      if (!w->lines.empty() &&
          fwrite(w->lines.data(), 1, w->lines.size(), h->spill) !=
              w->lines.size()) {
        h->spill_err = true;
        h->error = "short write to raw-lines spill file (disk full?)";
      }
      for (size_t j = 1; j < w->line_off.size(); j++)
        h->line_off.push_back(h->spill_len + w->line_off[j]);
      h->spill_len += (int64_t)w->lines.size();
    } else {
      int64_t base = (int64_t)h->lines.size();
      h->lines += w->lines;
      for (size_t j = 1; j < w->line_off.size(); j++)
        h->line_off.push_back(base + w->line_off[j]);
    }
    shards[(size_t)k].reset();  // free shard memory as the merge walks
  }
  h->merge_ns += now_ns() - t0;
  return h->spill_err ? -1 : (int64_t)h->time_.size();
}

int64_t ffz_merge_ns(void* hv) { return ((Ffz*)hv)->merge_ns; }

int ffz_finish(void* hv, const double* tc, int ntc, const double* bc,
               int nbc, const double* pc, int npc) {
  Ffz* h = (Ffz*)hv;
  // Bin values are at most the cut count; the word-cache key packs each
  // into 12 bits and wp_id into 28.
  if (ntc > 4095 || nbc > 4095 || npc > 4095) {
    h->error = "cut lists longer than 4095 are not supported";
    return -1;
  }
  size_t n = h->time_.size();
  h->tbin.resize(n);
  h->bbin.resize(n);
  h->pbin.resize(n);
  h->wp_id.resize(n);
  h->sw_id.resize(n);
  h->dw_id.resize(n);

  PassB p(h, h->words, n);
  p.tc = tc;
  p.bc = bc;
  p.pc = pc;
  p.ntc = ntc;
  p.nbc = nbc;
  p.npc = npc;
  for (size_t i = 0; i < n; i++) p.event(i);

  h->wc_ip = std::move(p.s_ip);
  h->wc_ip.insert(h->wc_ip.end(), p.d_ip.begin(), p.d_ip.end());
  h->wc_word = std::move(p.s_w);
  h->wc_word.insert(h->wc_word.end(), p.d_w.begin(), p.d_w.end());
  h->wc_cnt = std::move(p.s_c);
  h->wc_cnt.insert(h->wc_cnt.end(), p.d_c.begin(), p.d_c.end());
  return 0;
}

// Pass B over `workers` contiguous event ranges, each through its own
// PassB with a shard-local word interner, then a deterministic merge:
// walking shard word tables in shard order re-interns every word in
// its global first-intern order, and walking the shard-local
// first-seen (doc, word) maps in shard order (all src, then all dst)
// reproduces the sequential aggregation order with counts summed
// across shards.  Byte-identical to ffz_finish given identical cuts.
int ffz_finish_mt(void* hv, const double* tc, int ntc, const double* bc,
                  int nbc, const double* pc, int npc, int workers) {
  Ffz* h = (Ffz*)hv;
  size_t n = h->time_.size();
  if (workers <= 1 || n < 2)
    return ffz_finish(hv, tc, ntc, bc, nbc, pc, npc);
  if (ntc > 4095 || nbc > 4095 || npc > 4095) {
    h->error = "cut lists longer than 4095 are not supported";
    return -1;
  }
  if ((size_t)workers > n) workers = (int)n;
  h->tbin.resize(n);
  h->bbin.resize(n);
  h->pbin.resize(n);
  h->wp_id.resize(n);
  h->sw_id.resize(n);
  h->dw_id.resize(n);

  std::vector<std::unique_ptr<Interner>> local_words((size_t)workers);
  std::vector<std::unique_ptr<PassB>> passes((size_t)workers);
  std::vector<std::thread> threads;
  for (int k = 0; k < workers; k++) {
    size_t lo = n * (size_t)k / (size_t)workers;
    size_t hi = n * ((size_t)k + 1) / (size_t)workers;
    local_words[(size_t)k] = std::make_unique<Interner>();
    passes[(size_t)k] =
        std::make_unique<PassB>(h, *local_words[(size_t)k], hi - lo);
    PassB* p = passes[(size_t)k].get();
    p->tc = tc;
    p->bc = bc;
    p->pc = pc;
    p->ntc = ntc;
    p->nbc = nbc;
    p->npc = npc;
    threads.emplace_back([p, lo, hi] {
      for (size_t i = lo; i < hi; i++) p->event(i);
    });
  }
  for (auto& t : threads) t.join();

  int64_t t0 = now_ns();
  // Word merge order is the id contract, so the interning walk is
  // sequential; the per-event id rewrites only READ the finished wmaps
  // and touch disjoint ranges, so they fan back out across threads.
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
        for (size_t i = lo; i < hi; i++) {
          h->wp_id[i] = (*wmap)[(size_t)h->wp_id[i]];
          h->sw_id[i] = (*wmap)[(size_t)h->sw_id[i]];
          h->dw_id[i] = (*wmap)[(size_t)h->dw_id[i]];
        }
      });
    }
    for (auto& t : rewrite) t.join();
  }
  // Size the merge maps for the REAL entry totals up front: growing
  // from n/2 through repeated rehashes was the hottest block of the
  // merge on high-cardinality days (pairs-per-event near 1).
  size_t tot_s = 0, tot_d = 0;
  for (int k = 0; k < workers; k++) {
    tot_s += passes[(size_t)k]->s_c.size();
    tot_d += passes[(size_t)k]->d_c.size();
  }
  std::vector<int32_t> s_ip, s_w, d_ip, d_w;
  std::vector<int64_t> s_c, d_c;
  // The src and dst aggregations are independent streams with separate
  // maps and outputs, so their (inherently sequential, shard-ordered)
  // merges run concurrently on two threads — each walks shards in
  // order, preserving its stream's first-seen contract.
  std::thread src_merge([&] {
    oni::FlatMap64 src_pos(tot_s);
    s_ip.reserve(tot_s);
    s_w.reserve(tot_s);
    s_c.reserve(tot_s);
    for (int k = 0; k < workers; k++) {
      PassB& p = *passes[(size_t)k];
      const std::vector<int32_t>& wmap = wmaps[(size_t)k];
      for (size_t e = 0; e < p.s_c.size(); e++) {
        int32_t gw = wmap[(size_t)p.s_w[e]];
        uint64_t key =
            ((uint64_t)(uint32_t)p.s_ip[e] << 32) | (uint32_t)gw;
        bool fresh;
        int64_t& slot = src_pos.probe(key, &fresh);
        if (fresh) {
          slot = (int64_t)s_c.size();
          s_ip.push_back(p.s_ip[e]);
          s_w.push_back(gw);
          s_c.push_back(p.s_c[e]);
        } else {
          s_c[(size_t)slot] += p.s_c[e];
        }
      }
    }
  });
  {
    oni::FlatMap64 dst_pos(tot_d);
    d_ip.reserve(tot_d);
    d_w.reserve(tot_d);
    d_c.reserve(tot_d);
    for (int k = 0; k < workers; k++) {
      PassB& p = *passes[(size_t)k];
      const std::vector<int32_t>& wmap = wmaps[(size_t)k];
      for (size_t e = 0; e < p.d_c.size(); e++) {
        int32_t gw = wmap[(size_t)p.d_w[e]];
        uint64_t key =
            ((uint64_t)(uint32_t)p.d_ip[e] << 32) | (uint32_t)gw;
        bool fresh;
        int64_t& slot = dst_pos.probe(key, &fresh);
        if (fresh) {
          slot = (int64_t)d_c.size();
          d_ip.push_back(p.d_ip[e]);
          d_w.push_back(gw);
          d_c.push_back(p.d_c[e]);
        } else {
          d_c[(size_t)slot] += p.d_c[e];
        }
      }
    }
  }
  src_merge.join();
  for (int k = 0; k < workers; k++) passes[(size_t)k].reset();
  h->wc_ip = std::move(s_ip);
  h->wc_ip.insert(h->wc_ip.end(), d_ip.begin(), d_ip.end());
  h->wc_word = std::move(s_w);
  h->wc_word.insert(h->wc_word.end(), d_w.begin(), d_w.end());
  h->wc_cnt = std::move(s_c);
  h->wc_cnt.insert(h->wc_cnt.end(), d_c.begin(), d_c.end());
  h->merge_ns += now_ns() - t0;
  return 0;
}

const int32_t* ffz_bins(void* hv, int which) {
  Ffz* h = (Ffz*)hv;
  switch (which) {
    case 0: return h->tbin.data();
    case 1: return h->bbin.data();
    default: return h->pbin.data();
  }
}

const int32_t* ffz_ids(void* hv, int which) {
  Ffz* h = (Ffz*)hv;
  switch (which) {
    case 0: return h->sip_id.data();
    case 1: return h->dip_id.data();
    case 2: return h->wp_id.data();
    case 3: return h->sw_id.data();
    default: return h->dw_id.data();
  }
}

static Interner& table_of(void* hv, int which) {
  Ffz* h = (Ffz*)hv;
  return which == 0 ? h->ips : h->words;
}
int64_t ffz_table_count(void* hv, int which) {
  return (int64_t)table_of(hv, which).arena.size();
}
const char* ffz_table_blob(void* hv, int which) {
  Interner& t = table_of(hv, which);
  t.build_export();
  return t.blob.data();
}
int64_t ffz_table_blob_len(void* hv, int which) {
  Interner& t = table_of(hv, which);
  t.build_export();
  return (int64_t)t.blob.size();
}
const int64_t* ffz_table_offsets(void* hv, int which) {
  Interner& t = table_of(hv, which);
  t.build_export();
  return t.offsets.data();
}

const char* ffz_lines_blob(void* hv) {
  Ffz* h = (Ffz*)hv;
  return h->spill ? nullptr : h->lines.data();  // spilled: read the file
}
int64_t ffz_lines_blob_len(void* hv) {
  Ffz* h = (Ffz*)hv;
  return h->spill ? h->spill_len : (int64_t)h->lines.size();
}
const int64_t* ffz_line_offsets(void* hv) {
  return ((Ffz*)hv)->line_off.data();
}

int64_t ffz_wc_len(void* hv) { return (int64_t)((Ffz*)hv)->wc_cnt.size(); }
const int32_t* ffz_wc_ip(void* hv) { return ((Ffz*)hv)->wc_ip.data(); }
const int32_t* ffz_wc_word(void* hv) { return ((Ffz*)hv)->wc_word.data(); }
const int64_t* ffz_wc_count(void* hv) { return ((Ffz*)hv)->wc_cnt.data(); }

}  // extern "C"
