// Native CSV emit for the scoring stage (scoring/score.py).
//
// Profiling the score stage on a 400k-event day: the device dot
// products cost ~0.05s while Python row assembly — featurized_row()
// per kept event (blob slice, decode, split, list concat, str() per
// float) — cost ~1.8s, >90% of the stage (the stage
// it replaces is the reference's executor-side CSV write,
// flow_post_lda.scala:245-248).  This TU assembles the entire output
// buffer in one pass over the kept-row order instead.
//
// Inputs are the arena blobs/offset arrays and per-event numeric
// columns that NativeFlowFeatures / NativeDnsFeatures already hold as
// numpy arrays + bytes (features/native_flow.py, native_dns.py) — no
// featurizer handle needed, so this works on unpickled features too.
// Output bytes are BIT-IDENTICAL to the Python emit loop: jvm_double
// (common.h) reproduces str(float) exactly, integer columns print via
// to_chars, and string ordering/min-max pairing is bytewise like
// Python's str comparison (UTF-8 preserves code-point order).
//
// The returned buffer is heap-allocated; the caller frees it with
// emit_free.

#include "common.h"

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>

namespace {

using oni::append_int;
using oni::jvm_double;

inline std::string_view seg(const char* blob, const int64_t* off, int64_t i) {
  return std::string_view(blob + off[i], (size_t)(off[i + 1] - off[i]));
}

inline void append_i64(std::string& s, int64_t v) {
  char buf[24];
  auto [p, ec] = std::to_chars(buf, buf + sizeof(buf), v);
  (void)ec;
  s.append(buf, p);
}

char* to_heap(const std::string& s, int64_t* out_len) {
  char* buf = new char[s.size()];
  memcpy(buf, s.data(), s.size());
  *out_len = (int64_t)s.size();
  return buf;
}

}  // namespace

extern "C" {

void emit_free(char* buf) { delete[] buf; }

// Flow scored rows: for each event i in `order`, the raw comma-joined
// line + 8 featurized columns + src/dest scores, newline-terminated
// (NativeFlowFeatures.featurized_row + score_flow's emit).
char* flow_emit(
    const char* lines_blob, const int64_t* line_off,
    const char* ip_blob, const int64_t* ip_off,
    const char* word_blob, const int64_t* word_off,
    const int32_t* sip_id, const int32_t* dip_id,
    const int32_t* wp_id, const int32_t* sw_id, const int32_t* dw_id,
    const double* num_time, const int64_t* ibyt_bin,
    const int64_t* ipkt_bin, const int64_t* time_bin,
    const double* src_scores, const double* dest_scores,
    const int64_t* order, int64_t n_out, int64_t* out_len) {
  std::string out;
  out.reserve((size_t)n_out * 192);
  for (int64_t j = 0; j < n_out; j++) {
    int64_t i = order[j];
    out.append(seg(lines_blob, line_off, i));
    out += ',';
    out += jvm_double(num_time[i]);
    out += ',';
    append_i64(out, ibyt_bin[i]);
    out += ',';
    append_i64(out, ipkt_bin[i]);
    out += ',';
    append_i64(out, time_bin[i]);
    out += ',';
    out.append(seg(word_blob, word_off, wp_id[i]));
    out += ',';
    std::string_view s = seg(ip_blob, ip_off, sip_id[i]);
    std::string_view d = seg(ip_blob, ip_off, dip_id[i]);
    if (d < s) std::swap(s, d);
    out.append(s);
    out += ' ';
    out.append(d);
    out += ',';
    out.append(seg(word_blob, word_off, sw_id[i]));
    out += ',';
    out.append(seg(word_blob, word_off, dw_id[i]));
    out += ',';
    out += jvm_double(src_scores[i]);
    out += ',';
    out += jvm_double(dest_scores[i]);
    out += '\n';
  }
  return to_heap(out, out_len);
}

// DNS scored rows: the stored row fields (\x1f-joined) re-joined with
// ',' + 7 featurized columns + score (NativeDnsFeatures.featurized_row
// + score_dns's emit).
char* dns_emit(
    const char* rows_blob, const int64_t* row_off,
    const char* dom_blob, const int64_t* dom_off,
    const char* sub_blob, const int64_t* sub_off,
    const char* word_blob, const int64_t* word_off,
    const int32_t* dom_id, const int32_t* sub_id, const int32_t* word_id,
    const int64_t* sublen, const int64_t* nparts, const double* entropy,
    const int64_t* top, const double* scores,
    const int64_t* order, int64_t n_out, int64_t* out_len) {
  std::string out;
  out.reserve((size_t)n_out * 128);
  for (int64_t j = 0; j < n_out; j++) {
    int64_t i = order[j];
    size_t start = out.size();
    out.append(seg(rows_blob, row_off, i));
    // \x1f -> ',' as a plain byte loop: separators land every ~8
    // bytes in a DNS row, so a memchr-per-hit scan is SLOWER here
    // (measured 0.87s vs 0.69s on the 400k-event scoring stage —
    // per-call overhead dominates at that hit density).
    for (size_t q = start; q < out.size(); q++)
      if (out[q] == '\x1f') out[q] = ',';
    out += ',';
    out.append(seg(dom_blob, dom_off, dom_id[i]));
    out += ',';
    out.append(seg(sub_blob, sub_off, sub_id[i]));
    out += ',';
    append_i64(out, sublen[i]);
    out += ',';
    append_i64(out, nparts[i]);
    out += ',';
    out += jvm_double(entropy[i]);
    out += ',';
    append_i64(out, top[i]);
    out += ',';
    out.append(seg(word_blob, word_off, word_id[i]));
    out += ',';
    out += jvm_double(scores[i]);
    out += '\n';
  }
  return to_heap(out, out_len);
}

// Fused gather-dot for event scoring: out[i] = <theta[ip_idx[i]],
// p[w_idx[i]]> in float64, accumulated k=0..K-1 in index order —
// bit-identical to the sequential k-order fold (the reference's
// zip/map/sum).  NOT einsum: np.einsum's SIMD partial sums round in
// a different order in the last ulp (that is why score.py replaced
// it and the golden CSVs moved).  The
// numpy path materializes two [N, K] float64 gather temporaries
// (~1.6 GB at a 5M-event day) before the dot; this reads the two rows
// and writes one double per event.  flow_post_lda.scala:227-239's
// per-event Map lookup + dot, minus the lookups (ids are pre-resolved
// against the interned tables by score.py's O(unique) LUT).
// No FMA fusion (both build paths pass -ffp-contract=off globally):
// a fused multiply-add rounds once where numpy rounds twice, and the
// golden scoring bytes (str(score)) must not move.
void score_dot(
    const double* theta, const double* p, int64_t k,
    const int32_t* ip_idx, const int32_t* w_idx, int64_t n,
    double* out) {
  for (int64_t i = 0; i < n; i++) {
    const double* a = theta + (int64_t)ip_idx[i] * k;
    const double* b = p + (int64_t)w_idx[i] * k;
    double s = 0.0;
    for (int64_t j = 0; j < k; j++) s += a[j] * b[j];
    out[i] = s;
  }
}

// model.dat (LDA-C corpus): "N w1:c1 ... wN:cN" per document from the
// CSR arrays (formats.write_model_dat layout, lda_pre.py:84-94).  The
// Python writer built ~9.4M "w:c" fragments through a list — 9 s of a
// 5M-event day's corpus stage.
char* model_emit(
    const int64_t* doc_ptr, int64_t n_docs,
    const int32_t* word_idx, const int64_t* counts,
    int64_t* out_len) {
  std::string out;
  out.reserve((size_t)(n_docs ? doc_ptr[n_docs] : 0) * 12 + n_docs * 8);
  for (int64_t d = 0; d < n_docs; d++) {
    int64_t lo = doc_ptr[d], hi = doc_ptr[d + 1];
    append_i64(out, hi - lo);
    for (int64_t j = lo; j < hi; j++) {
      out += ' ';
      append_i64(out, word_idx[j]);
      out += ':';
      append_i64(out, counts[j]);
    }
    out += '\n';
  }
  return to_heap(out, out_len);
}

// word_counts file ("ip,word,count" one line per aggregated pair,
// formats.write_word_counts layout): built as one buffer from the
// interned string tables + the featurizer's aggregated id arrays.
// stage_pre previously materialized ~1.5M Python (str,str,int) tuples
// and wrote one line at a time — half the pre stage's wall-clock on a
// 2M-event day.
char* wc_emit(
    const char* ip_blob, const int64_t* ip_off,
    const char* word_blob, const int64_t* word_off,
    const int32_t* wc_ip, const int32_t* wc_word, const int64_t* wc_count,
    int64_t n, int64_t* out_len) {
  std::string out;
  out.reserve((size_t)n * 48);
  for (int64_t i = 0; i < n; i++) {
    out.append(seg(ip_blob, ip_off, wc_ip[i]));
    out += ',';
    out.append(seg(word_blob, word_off, wc_word[i]));
    out += ',';
    append_i64(out, wc_count[i]);
    out += '\n';
  }
  return to_heap(out, out_len);
}

}  // extern "C"
