"""ctypes binding of the native corpus ingest
(native_src/corpus_ingest.cpp; port of oni_ml_tpu/io/native.py).

One buffered C++ pass over word_counts files -> the CSR arrays and id
maps of `Corpus.from_word_counts` (first-seen ids, per-doc token
grouping): the resumed corpus stage's reader.  A build or load failure
raises; under ONI_ML_TPU_NO_NATIVE=1 `Corpus.from_word_counts_file`
reads in Python instead.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..native_build import NativeLib


def _configure(lib: ctypes.CDLL) -> None:
    lib.oni_ingest_create.restype = ctypes.c_void_p
    lib.oni_ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.oni_ingest_file.restype = ctypes.c_int64
    lib.oni_ingest_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.oni_last_error.restype = ctypes.c_char_p
    lib.oni_last_error.argtypes = [ctypes.c_void_p]
    for fn in ("oni_num_docs", "oni_num_terms", "oni_nnz"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.oni_fill_csr.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.oni_names_bytes.restype = ctypes.c_int64
    lib.oni_names_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.oni_fill_names.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_char_p]


_LIB = NativeLib("ingest", _configure)


def load_corpus(paths: "str | list[str]"):
    """Parse one or more word_counts files natively -> Corpus.  Several
    paths concatenate like the reference's `cat part-* > doc_wc.dat`.
    Raises ValueError on malformed input (non-UTF-8 bytes included, as
    the Python reader does)."""
    from .corpus import Corpus

    lib = _LIB.load()
    if isinstance(paths, str):
        paths = [paths]
    h = lib.oni_ingest_create()
    try:
        for p in paths:
            if lib.oni_ingest_file(h, os.fsencode(p)) < 0:
                err = lib.oni_last_error(h).decode("utf-8", "replace")
                raise ValueError(f"{p}: {err}")
        d = lib.oni_num_docs(h)
        nnz = lib.oni_nnz(h)
        doc_ptr = np.empty(d + 1, dtype=np.int64)
        word_idx = np.empty(nnz, dtype=np.int32)
        counts = np.empty(nnz, dtype=np.int32)
        lib.oni_fill_csr(h, doc_ptr, word_idx, counts)

        def names(which: int) -> "list[str]":
            nb = lib.oni_names_bytes(h, which)
            buf = ctypes.create_string_buffer(int(nb))
            lib.oni_fill_names(h, which, buf)
            # surrogateescape, as the Python reader: raw wire bytes in
            # IPs and words round-trip through words.dat / doc.dat.
            raw = buf.raw[:nb].decode("utf-8", "surrogateescape")
            return raw.split("\n")[:-1]  # trailing separator

        return Corpus(doc_names=names(0), vocab=names(1), doc_ptr=doc_ptr,
                      word_idx=word_idx, counts=counts)
    finally:
        lib.oni_ingest_destroy(ctypes.c_void_p(h))
