// Native corpus ingest — the C++ replacement for the reference's
// single-node Python corpus build (lda_pre.py:30-94, SURVEY.md §2.4),
// which is the pipeline's host-side scalability bottleneck: three
// sequential interpreter passes over doc_wc.dat with per-line dict
// lookups.  Here it is one buffered pass in C++ with first-seen-order id
// assignment (the reference's words.dat/doc.dat line-number contract) and
// CSR output ready for device batching.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  Semantics
// match oni_ml_tpu/io/formats.read_word_counts + Corpus.from_word_counts
// exactly: lines are "ip,word,count" split from the RIGHT (rsplit ',', 2),
// empty lines skipped, tokens grouped per document in first-seen doc
// order, duplicate (doc, word) pairs kept as separate tokens.

#include "common.h"

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

using oni::Interner;

struct Ingest {
  Interner words;
  Interner docs;
  std::vector<std::vector<std::pair<int32_t, int32_t>>> doc_tokens;
  int64_t nnz = 0;
  std::string error;
};

// Parse one line [b, e) as "ip,word,count" (rsplit from the right).
// Returns false (and sets err) on malformed input.
bool parse_line(const char* b, const char* e, Ingest& st, int64_t lineno) {
  const char* last = static_cast<const char*>(memrchr(b, ',', e - b));
  if (last == nullptr) {
    st.error = "line " + std::to_string(lineno) + ": expected ip,word,count";
    return false;
  }
  const char* mid = static_cast<const char*>(memrchr(b, ',', last - b));
  if (mid == nullptr) {
    st.error = "line " + std::to_string(lineno) + ": expected ip,word,count";
    return false;
  }
  // count: strict non-negative integer like Python int()
  int64_t count = 0;
  const char* p = last + 1;
  if (p == e) {
    st.error = "line " + std::to_string(lineno) + ": empty count";
    return false;
  }
  bool neg = false;
  if (*p == '-' || *p == '+') { neg = (*p == '-'); ++p; }
  if (p == e) {
    st.error = "line " + std::to_string(lineno) + ": bad count";
    return false;
  }
  for (; p != e; ++p) {
    if (*p < '0' || *p > '9') {
      st.error = "line " + std::to_string(lineno) + ": bad count";
      return false;
    }
    count = count * 10 + (*p - '0');
    if (count > INT32_MAX) {  // counts land in an int32 CSR array
      st.error = "line " + std::to_string(lineno) + ": count out of range";
      return false;
    }
  }
  if (neg) count = -count;

  int32_t w = st.words.intern(std::string_view(mid + 1, last - mid - 1));
  int32_t d = st.docs.intern(std::string_view(b, mid - b));
  // A fresh doc id always equals the previous doc count (first-seen ids).
  if ((size_t)d == st.doc_tokens.size()) st.doc_tokens.emplace_back();
  st.doc_tokens[d].emplace_back(w, (int32_t)count);
  ++st.nnz;
  return true;
}

}  // namespace

extern "C" {

void* oni_ingest_create() { return new Ingest(); }

void oni_ingest_destroy(void* h) { delete static_cast<Ingest*>(h); }

// Ingest one word_counts file; callable repeatedly (the reference `cat`s
// part-* files together, ml_ops.sh:61 — here concatenation is implicit).
// Returns number of triples ingested, or -1 on error (see oni_last_error).
int64_t oni_ingest_file(void* h, const char* path) {
  Ingest& st = *static_cast<Ingest*>(h);
  FILE* f = fopen(path, "rb");
  if (!f) {
    st.error = std::string("cannot open ") + path;
    return -1;
  }
  int64_t ingested = 0, lineno = 0;
  std::string carry;
  std::vector<char> buf(1 << 20);
  size_t n;
  bool skip_lf = false;  // pending LF of a CRLF split across chunks
  while ((n = fread(buf.data(), 1, buf.size(), f)) > 0) {
    const char* p = buf.data();
    const char* end = p + n;
    if (skip_lf) {
      if (*p == '\n') ++p;
      skip_lf = false;
    }
    // Universal newlines like Python text mode: LF, CRLF, or lone CR.
    // The CR probe is cached per chunk — recomputing it per line would
    // rescan the whole chunk for every line of a CR-free file.
    const char* cr = static_cast<const char*>(memchr(p, '\r', end - p));
    while (p < end) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      if (cr != nullptr && cr < p)
        cr = static_cast<const char*>(memchr(p, '\r', end - p));
      const char* term = (nl && cr) ? (nl < cr ? nl : cr) : (nl ? nl : cr);
      if (term == nullptr) {
        carry.append(p, end - p);
        break;
      }
      ++lineno;
      const char *b, *e;
      if (!carry.empty()) {
        carry.append(p, term - p);
        b = carry.data();
        e = b + carry.size();
      } else {
        b = p;
        e = term;
      }
      if (e > b) {  // skip empty lines like the Python reader
        if (!parse_line(b, e, st, lineno)) {
          fclose(f);
          return -1;
        }
        ++ingested;
      }
      carry.clear();
      p = term + 1;
      if (*term == '\r') {
        if (p < end) {
          if (*p == '\n') ++p;
        } else {
          skip_lf = true;
        }
      }
    }
  }
  bool read_err = ferror(f) != 0;
  fclose(f);
  if (read_err) {
    st.error = std::string("read error on ") + path;
    return -1;
  }
  if (!carry.empty()) {  // final line without trailing newline
    ++lineno;
    if (!parse_line(carry.data(), carry.data() + carry.size(), st, lineno))
      return -1;
    ++ingested;
  }
  return ingested;
}

const char* oni_last_error(void* h) {
  return static_cast<Ingest*>(h)->error.c_str();
}

int64_t oni_num_docs(void* h) {
  return (int64_t)static_cast<Ingest*>(h)->docs.arena.size();
}

int64_t oni_num_terms(void* h) {
  return (int64_t)static_cast<Ingest*>(h)->words.arena.size();
}

int64_t oni_nnz(void* h) { return static_cast<Ingest*>(h)->nnz; }

// Fill caller-allocated CSR arrays: doc_ptr [D+1] i64, word_idx [NNZ] i32,
// counts [NNZ] i32 — token order per doc = file first-seen order.
void oni_fill_csr(void* h, int64_t* doc_ptr, int32_t* word_idx,
                  int32_t* counts) {
  Ingest& st = *static_cast<Ingest*>(h);
  int64_t pos = 0;
  doc_ptr[0] = 0;
  for (size_t d = 0; d < st.doc_tokens.size(); ++d) {
    for (auto& [w, c] : st.doc_tokens[d]) {
      word_idx[pos] = w;
      counts[pos] = c;
      ++pos;
    }
    doc_ptr[d + 1] = pos;
  }
}

// Names are returned '\n'-joined (neither ips nor words may contain '\n'
// — they came from '\n'-terminated lines).  which: 0 = doc names, 1 = vocab.
int64_t oni_names_bytes(void* h, int32_t which) {
  Ingest& st = *static_cast<Ingest*>(h);
  auto& v = which == 0 ? st.docs.arena : st.words.arena;
  int64_t total = 0;
  for (auto& s : v) total += (int64_t)s.size() + 1;
  return total;
}

void oni_fill_names(void* h, int32_t which, char* buf) {
  Ingest& st = *static_cast<Ingest*>(h);
  auto& v = which == 0 ? st.docs.arena : st.words.arena;
  for (auto& s : v) {
    memcpy(buf, s.data(), s.size());
    buf += s.size();
    *buf++ = '\n';
  }
}

}  // extern "C"
