"""ctypes binding of the native emit and score library
(native_src/row_emit.cpp; port of oni_ml_tpu/native_emit.py).  It serves
three stages: pre's word_counts.dat buffer (`word_counts_emit`), corpus's
model.dat buffer (`model_emit`, through io.formats.write_model_dat), and
score's results-CSV assembly (`flow_emit`, `dns_emit`) and fused
gather-dot (`score_dot`).

Each builds its whole output in C++ from the tables, id arrays and CSR
arrays the callers hold, byte-identical to the Python loop it replaces
(tests/test_torch_native.py); a failed build or load raises.  The row
and word-count emitters serve the native feature containers
(features/native_flow.py, native_dns.py), which exist only where the
native featurizers ran; the model emitter and the gather-dot are chosen
under `native_build.enabled()` by their callers (io/formats.py,
scoring/score.py), which run their Python loops under
ONI_ML_TPU_NO_NATIVE=1.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .native_build import NativeLib, bytes_at

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def _configure(lib: ctypes.CDLL) -> None:
    lib.emit_free.argtypes = [ctypes.c_void_p]
    lib.score_dot.restype = None
    lib.score_dot.argtypes = [_F64P, _F64P, ctypes.c_int64,
                              _I32P, _I32P, ctypes.c_int64, _F64P]
    lib.model_emit.restype = ctypes.c_void_p
    lib.model_emit.argtypes = [_I64P, ctypes.c_int64, _I32P, _I64P, _I64P]
    lib.wc_emit.restype = ctypes.c_void_p
    lib.wc_emit.argtypes = ([ctypes.c_char_p, _I64P] * 2
                            + [_I32P, _I32P, _I64P, ctypes.c_int64, _I64P])
    lib.flow_emit.restype = ctypes.c_void_p
    lib.flow_emit.argtypes = ([ctypes.c_char_p, _I64P] * 3 + [_I32P] * 5
                              + [_F64P, _I64P, _I64P, _I64P, _F64P, _F64P]
                              + [_I64P, ctypes.c_int64, _I64P])
    lib.dns_emit.restype = ctypes.c_void_p
    lib.dns_emit.argtypes = ([ctypes.c_char_p, _I64P] * 4 + [_I32P] * 3
                             + [_I64P, _I64P, _F64P, _I64P, _F64P]
                             + [_I64P, ctypes.c_int64, _I64P])


_LIB = NativeLib("emit", _configure)


def _table_blob(strs: "list[str]") -> "tuple[bytes, np.ndarray]":
    """A decoded string table -> (blob, [n+1] offsets); tables hold
    unique strings only, so this is small beside the rows."""
    enc = [s.encode("utf-8", "surrogateescape") for s in strs]
    off = np.zeros(len(enc) + 1, np.int64)
    if enc:
        np.cumsum([len(e) for e in enc], out=off[1:])
    return b"".join(enc), off


def _p(a: np.ndarray, dtype, ptype):
    """(contiguous `dtype` copy or view, its ctypes pointer): the caller
    keeps the array alive across the call."""
    a = np.ascontiguousarray(a, dtype)
    return a, a.ctypes.data_as(ptype)


def _args(*specs):
    """[(array, dtype, pointer type)] -> (arrays held, pointers)."""
    held, ptrs = [], []
    for a, dtype, ptype in specs:
        arr, ptr = _p(a, dtype, ptype)
        held.append(arr)
        ptrs.append(ptr)
    return held, ptrs


def _collect(lib, ptr, out_len) -> bytes:
    try:
        return bytes_at(ptr, out_len.value)
    finally:
        lib.emit_free(ptr)


def _blob_arg(blob):
    """bytes pass through; an MmapBlob hands over its mapping's address."""
    return blob.as_c_char_p() if hasattr(blob, "as_c_char_p") else blob


def flow_emit(features, src_scores, dest_scores, order) -> "bytes":
    """flow_results.csv's bytes for a NativeFlowFeatures: the rows of
    `order`, each its featurized columns and both scores."""
    lib = _LIB.load()
    ip_blob, ip_off = _table_blob(features.ip_table)
    word_blob, word_off = _table_blob(features.word_table)
    i32, i64, f64 = ((np.int32, _I32P), (np.int64, _I64P),
                     (np.float64, _F64P))
    held, p = _args(
        (features.line_off, *i64), (ip_off, *i64), (word_off, *i64),
        (features.sip_id, *i32), (features.dip_id, *i32),
        (features.wp_id, *i32), (features.sw_id, *i32),
        (features.dw_id, *i32), (features.num_time, *f64),
        (features.ibyt_bin, *i64), (features.ipkt_bin, *i64),
        (features.time_bin, *i64), (src_scores, *f64), (dest_scores, *f64),
        (order, *i64))
    out_len = ctypes.c_int64(0)
    ptr = lib.flow_emit(
        _blob_arg(features.lines_blob), p[0], ip_blob, p[1], word_blob, p[2],
        *p[3:14], p[14], len(held[14]), ctypes.byref(out_len))
    return _collect(lib, ptr, out_len)


def dns_emit(features, scores, order) -> "bytes":
    """dns_results.csv's bytes for a NativeDnsFeatures: the rows of
    `order`, each its featurized columns and its score."""
    lib = _LIB.load()
    dom_blob, dom_off = _table_blob(features.domain_table)
    sub_blob, sub_off = _table_blob(features.subdomain_table)
    word_blob, word_off = _table_blob(features.word_table)
    i32, i64, f64 = ((np.int32, _I32P), (np.int64, _I64P),
                     (np.float64, _F64P))
    held, p = _args(
        (features.row_off, *i64), (dom_off, *i64), (sub_off, *i64),
        (word_off, *i64), (features.dom_id, *i32), (features.sub_id, *i32),
        (features.word_id, *i32), (features.subdomain_length, *i64),
        (features.num_periods, *i64), (features.subdomain_entropy, *f64),
        (features.top_domain, *i64), (scores, *f64), (order, *i64))
    out_len = ctypes.c_int64(0)
    ptr = lib.dns_emit(
        _blob_arg(features.rows_blob), p[0], dom_blob, p[1], sub_blob, p[2],
        word_blob, p[3], *p[4:12], p[12], len(held[12]),
        ctypes.byref(out_len))
    return _collect(lib, ptr, out_len)


def score_dot(theta, p, ip_idx, word_idx) -> "np.ndarray":
    """out[i] = <theta[ip_idx[i]], p[word_idx[i]]> in float64, summed in
    k order: bit-identical to the sequential k-order fold of the host
    scorer (np.einsum's SIMD partial sums would move the last ulp).
    Raises IndexError on an index out of the model's rows, ValueError on
    unequal index lengths or K."""
    lib = _LIB.load()
    theta = np.ascontiguousarray(theta, np.float64)
    p = np.ascontiguousarray(p, np.float64)
    if theta.shape[1] != p.shape[1]:
        raise ValueError(f"K mismatch: theta {theta.shape} vs p {p.shape}")
    ip_idx = np.asarray(ip_idx)
    word_idx = np.asarray(word_idx)
    if len(ip_idx) != len(word_idx):
        raise ValueError(f"index length mismatch: {len(ip_idx)} ips vs "
                         f"{len(word_idx)} words")
    # Checked before the int32 cast (an int64 id of 2**32 would wrap to
    # 0): the C loop would read whatever memory such an id points at.
    if len(ip_idx) and (
            int(ip_idx.min()) < 0 or int(ip_idx.max()) >= theta.shape[0]
            or int(word_idx.min()) < 0 or int(word_idx.max()) >= p.shape[0]):
        raise IndexError("model-row index out of range")
    ip_idx = np.ascontiguousarray(ip_idx, np.int32)
    word_idx = np.ascontiguousarray(word_idx, np.int32)
    out = np.empty(len(ip_idx), np.float64)
    lib.score_dot(theta.ctypes.data_as(_F64P), p.ctypes.data_as(_F64P),
                  theta.shape[1], ip_idx.ctypes.data_as(_I32P),
                  word_idx.ctypes.data_as(_I32P), len(ip_idx),
                  out.ctypes.data_as(_F64P))
    return out


def model_emit(doc_ptr, word_idx, counts) -> "bytes":
    """The LDA-C model.dat buffer ("N w:c ..." per doc) from CSR arrays,
    byte-identical to formats.write_model_dat's line loop."""
    lib = _LIB.load()
    held, p = _args((doc_ptr, np.int64, _I64P), (word_idx, np.int32, _I32P),
                    (counts, np.int64, _I64P))
    ptr_arr = held[0]
    n_docs = len(ptr_arr) - 1
    if n_docs <= 0:
        return b""
    # The C loop trusts doc_ptr as in-bounds offsets: check what numpy
    # indexing checked for the Python loop.
    if (len(held[1]) != len(held[2]) or ptr_arr[0] != 0
            or np.any(np.diff(ptr_arr) < 0)
            or int(ptr_arr[-1]) > len(held[1])):
        raise ValueError("CSR arrays inconsistent with doc_ptr")
    out_len = ctypes.c_int64(0)
    ptr = lib.model_emit(p[0], n_docs, p[1], p[2], ctypes.byref(out_len))
    return _collect(lib, ptr, out_len)


def word_counts_emit(features) -> "bytes":
    """word_counts.dat (`ip,word,count` lines) as one buffer, from a
    native container's interned tables and aggregated id arrays;
    byte-identical to formats.write_word_counts over .word_counts()."""
    lib = _LIB.load()
    ip_blob, ip_off = _table_blob(features.ip_table)
    word_blob, word_off = _table_blob(features.word_table)
    held, p = _args((ip_off, np.int64, _I64P), (word_off, np.int64, _I64P),
                    (features.wc_ip, np.int32, _I32P),
                    (features.wc_word, np.int32, _I32P),
                    (features.wc_count, np.int64, _I64P))
    out_len = ctypes.c_int64(0)
    ptr = lib.wc_emit(ip_blob, p[0], word_blob, p[1], p[2], p[3], p[4],
                      len(held[2]), ctypes.byref(out_len))
    return _collect(lib, ptr, out_len)
