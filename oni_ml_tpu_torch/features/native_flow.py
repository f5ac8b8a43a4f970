"""ctypes binding of the native flow featurizer
(native_src/flow_featurize.cpp; port of
oni_ml_tpu/features/native_flow.py).

`featurize_flow_file` is the flow pre stage's entry point: the parse,
word-build and word-count passes run in C++, sharded over `workers`
std::threads with a deterministic first-seen merge, and the kept raw
lines stream to a spill file.  `ONI_ML_TPU_NO_NATIVE=1` runs the
pure-Python `features.flow.featurize_flow` instead; both give the same
words, word counts and scores (tests/test_torch_native.py).  A build or
load failure of the library raises: there is no silent fallback.

The ECDF cuts are computed here in Python from the native pass's
numeric arrays with quantiles.ecdf_cuts, once over the merged arrays
whatever the worker count: the quantile rule has one implementation.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Sequence

import numpy as np

from ..native_build import NativeLib, bytes_at, narrow_counts_i32
from .container import index_rows
from .flow import _jvm_double
from .lineio import expand_flow_paths
from .quantiles import DECILES, QUINTILES, ecdf_cuts

__all__ = ["InternedCounts", "NativeFlowFeatures", "expand_flow_paths",
           "featurize_flow_file"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def _configure(lib: ctypes.CDLL) -> None:
    lib.ffz_create.restype = ctypes.c_void_p
    lib.ffz_create.argtypes = [ctypes.c_int]
    lib.ffz_destroy.argtypes = [ctypes.c_void_p]
    lib.ffz_error.restype = ctypes.c_char_p
    lib.ffz_error.argtypes = [ctypes.c_void_p]
    lib.ffz_ingest_file.restype = ctypes.c_int64
    lib.ffz_ingest_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ffz_ingest_file_parallel.restype = ctypes.c_int64
    lib.ffz_ingest_file_parallel.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.ffz_merge_ns.restype = ctypes.c_int64
    lib.ffz_merge_ns.argtypes = [ctypes.c_void_p]
    lib.ffz_ingest_buffer.restype = ctypes.c_int64
    lib.ffz_ingest_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.ffz_mark_raw.argtypes = [ctypes.c_void_p]
    for fn in ("ffz_num_raw", "ffz_num_events", "ffz_lines_blob_len",
               "ffz_wc_len"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("ffz_num_time", "ffz_ibyt", "ffz_ipkt"):
        getattr(lib, fn).restype = _F64P
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    cuts = [_F64P, ctypes.c_int] * 3
    lib.ffz_finish.restype = ctypes.c_int
    lib.ffz_finish.argtypes = [ctypes.c_void_p, *cuts]
    lib.ffz_finish_mt.restype = ctypes.c_int
    lib.ffz_finish_mt.argtypes = [ctypes.c_void_p, *cuts, ctypes.c_int]
    for fn in ("ffz_bins", "ffz_ids"):
        getattr(lib, fn).restype = _I32P
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffz_table_count.restype = ctypes.c_int64
    lib.ffz_table_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffz_table_blob.restype = ctypes.c_void_p
    lib.ffz_table_blob.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffz_table_blob_len.restype = ctypes.c_int64
    lib.ffz_table_blob_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffz_table_offsets.restype = _I64P
    lib.ffz_table_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffz_lines_blob.restype = ctypes.c_void_p
    lib.ffz_lines_blob.argtypes = [ctypes.c_void_p]
    lib.ffz_set_spill.restype = ctypes.c_int
    lib.ffz_set_spill.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ffz_spill_flush.restype = ctypes.c_int64
    lib.ffz_spill_flush.argtypes = [ctypes.c_void_p]
    lib.ffz_line_offsets.restype = _I64P
    lib.ffz_line_offsets.argtypes = [ctypes.c_void_p]
    for fn, res in (("ffz_wc_ip", _I32P), ("ffz_wc_word", _I32P),
                    ("ffz_wc_count", _I64P)):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = [ctypes.c_void_p]


_LIB = NativeLib("flow", _configure)


def copy_array(ptr, n: int, dtype) -> np.ndarray:
    """A numpy copy of n elements at a native pointer, as `dtype`."""
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def string_table(blob: bytes, off: np.ndarray) -> "list[str]":
    """An interned string table from its bytes and [n+1] offsets."""
    return [blob[off[i]:off[i + 1]].decode("utf-8", "surrogateescape")
            for i in range(len(off) - 1)]


def _table(lib, h, which: int) -> "list[str]":
    cnt = lib.ffz_table_count(h, which)
    blob = bytes_at(lib.ffz_table_blob(h, which),
                    lib.ffz_table_blob_len(h, which))
    return string_table(blob, copy_array(lib.ffz_table_offsets(h, which),
                                         cnt + 1, np.int64))


class InternedCounts:
    """The stages' calls (features/container.py) over a native
    container's interned `ip_table` / `word_table` and its aggregated
    word counts `wc_ip` / `wc_word` / `wc_count`: word_counts.dat is
    emitted in C++ and the corpus built from the id arrays, with no
    word-count text in between."""

    def word_counts(self) -> "list[tuple[str, str, int]]":
        ips, words = self.ip_table, self.word_table
        return [(ips[i], words[w], int(c))
                for i, w, c in zip(self.wc_ip, self.wc_word, self.wc_count)]

    def write_word_counts(self, path: str) -> int:
        from ..native_emit import word_counts_emit

        blob = word_counts_emit(self)
        with open(path, "wb") as f:
            f.write(blob)
        return len(self.wc_ip)

    def to_corpus(self):
        from ..io.corpus import Corpus

        return Corpus.from_interned(self.ip_table, self.word_table,
                                    self.wc_ip, self.wc_word, self.wc_count)

    def word_count_columns(self):
        """The columnar hand-off (dataplane/columns.py) straight from the
        aggregated id arrays: no strings materialized; the streaming
        corpus builder's first-seen remap gives `to_corpus()`."""
        from ..dataplane.columns import make_word_count_columns

        return make_word_count_columns(self.wc_ip, self.wc_word,
                                       self.wc_count, self.ip_table,
                                       self.word_table)

    def _rows_of(self, ip_index: dict, word_index: dict):
        """(model row per ip_table entry, per word_table entry), int32:
        one dict lookup per unique IP and word, then the callers gather
        by event id."""
        return (index_rows(ip_index, self.ip_table, len(ip_index)),
                index_rows(word_index, self.word_table, len(word_index)))


class NativeFlowFeatures(InternedCounts):
    """FlowFeatures' surface over native arrays: raw rows are one blob
    (bytes, or an MmapBlob over the spill file) with offsets, split only
    for the rows the scorer emits; IPs and words are interned tables with
    per-event id arrays.  Pickles without the native library."""

    def __init__(self, *, lines_blob, line_off, ip_table, word_table,
                 sip_id, dip_id, wp_id, sw_id, dw_id, num_time, ibyt_bin,
                 ipkt_bin, time_bin, wc_ip, wc_word, wc_count,
                 num_raw_events, time_cuts, ibyt_cuts, ipkt_cuts):
        self.lines_blob = lines_blob
        self.line_off = line_off
        self.ip_table = ip_table
        self.word_table = word_table
        self.sip_id = sip_id
        self.dip_id = dip_id
        self.wp_id = wp_id
        self.sw_id = sw_id
        self.dw_id = dw_id
        self.num_time = num_time
        self.ibyt_bin = ibyt_bin
        self.ipkt_bin = ipkt_bin
        self.time_bin = time_bin
        self.wc_ip = wc_ip
        self.wc_word = wc_word
        self.wc_count = wc_count
        self.num_raw_events = num_raw_events
        self.time_cuts = time_cuts
        self.ibyt_cuts = ibyt_cuts
        self.ipkt_cuts = ipkt_cuts
        self._word_lists: "dict[str, list[str]]" = {}

    @property
    def num_events(self) -> int:
        return len(self.sip_id)

    def row(self, i: int) -> "list[str]":
        raw = self.lines_blob[self.line_off[i]:self.line_off[i + 1]]
        return raw.decode("utf-8", "surrogateescape").split(",")

    def sip(self, i: int) -> str:
        return self.ip_table[self.sip_id[i]]

    def dip(self, i: int) -> str:
        return self.ip_table[self.dip_id[i]]

    def _words(self, which: str) -> "list[str]":
        if which not in self._word_lists:
            ids = {"wp": self.wp_id, "src": self.sw_id,
                   "dst": self.dw_id}[which]
            t = self.word_table
            self._word_lists[which] = [t[j] for j in ids]
        return self._word_lists[which]

    @property
    def word_port(self) -> "list[str]":
        return self._words("wp")

    @property
    def src_word(self) -> "list[str]":
        return self._words("src")

    @property
    def dest_word(self) -> "list[str]":
        return self._words("dst")

    @property
    def ip_pair(self) -> "list[str]":
        # Derived: "min max" of the two endpoints (features/flow.py).
        out = []
        for s_id, d_id in zip(self.sip_id, self.dip_id):
            s, d = self.ip_table[s_id], self.ip_table[d_id]
            out.append(f"{s} {d}" if s < d else f"{d} {s}")
        return out

    @property
    def rows(self) -> "list[list[str]]":
        return [self.row(i) for i in range(self.num_events)]

    def featurized_row(self, i: int) -> "list[str]":
        s, d = self.sip(i), self.dip(i)
        pair = f"{s} {d}" if s < d else f"{d} {s}"
        return self.row(i) + [
            _jvm_double(self.num_time[i]),
            str(int(self.ibyt_bin[i])),
            str(int(self.ipkt_bin[i])),
            str(int(self.time_bin[i])),
            self.word_table[self.wp_id[i]],
            pair,
            self.word_table[self.sw_id[i]],
            self.word_table[self.dw_id[i]],
        ]

    def event_indices(self, ip_index: dict, word_index: dict):
        """FlowFeatures.event_indices, resolved once per unique IP and
        word (O(unique) dict lookups, not O(events))."""
        n = self.num_raw_events
        ip_map, word_map = self._rows_of(ip_index, word_index)
        return (ip_map[self.sip_id[:n]], word_map[self.sw_id[:n]],
                ip_map[self.dip_id[:n]], word_map[self.dw_id[:n]])

    def results_csv(self, src_scores, dest_scores, order) -> bytes:
        """FlowFeatures.results_csv's bytes, assembled in C++
        (native_emit.flow_emit)."""
        from ..native_emit import flow_emit

        return flow_emit(self, src_scores, dest_scores, order)

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_word_lists")
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._word_lists = {}


def _error(lib, h) -> str:
    return lib.ffz_error(h).decode("utf-8", "replace")


def _featurize_native(lib, paths: Sequence[str], feedback_rows,
                      precomputed_cuts=None, spill_path=None, workers=1,
                      timings=None) -> NativeFlowFeatures:
    h = lib.ffz_create(1)
    try:
        if spill_path is not None and lib.ffz_set_spill(
                h, os.fsencode(spill_path)) < 0:
            raise OSError(_error(lib, h))
        t0 = time.perf_counter()
        for path in paths:
            # Each file's pass A shards over `workers` threads with a
            # first-seen merge; workers=1 is the sequential pass.
            rc = (lib.ffz_ingest_file_parallel(h, os.fsencode(path), workers)
                  if workers > 1 else lib.ffz_ingest_file(h, os.fsencode(path)))
            if rc < 0:
                raise OSError(_error(lib, h))
        lib.ffz_mark_raw(h)
        if feedback_rows:
            blob = ("\n".join(feedback_rows) + "\n").encode(
                "utf-8", "surrogateescape")
            if lib.ffz_ingest_buffer(h, blob, len(blob)) < 0:
                raise OSError(_error(lib, h))
        t1 = time.perf_counter()
        n = lib.ffz_num_events(h)
        num_time = copy_array(lib.ffz_num_time(h), n, np.float64)
        ibyt = copy_array(lib.ffz_ibyt(h), n, np.float64)
        ipkt = copy_array(lib.ffz_ipkt(h), n, np.float64)
        if precomputed_cuts is not None:
            time_cuts, ibyt_cuts, ipkt_cuts = (
                np.ascontiguousarray(x, dtype=np.float64)
                for x in precomputed_cuts)
        else:
            time_cuts = ecdf_cuts(num_time, DECILES)
            ibyt_cuts = ecdf_cuts(ibyt, DECILES)
            ipkt_cuts = ecdf_cuts(ipkt, QUINTILES)
        t2 = time.perf_counter()

        def fp(a):
            return a.ctypes.data_as(_F64P)

        cut_args = (fp(time_cuts), len(time_cuts), fp(ibyt_cuts),
                    len(ibyt_cuts), fp(ipkt_cuts), len(ipkt_cuts))
        rc = (lib.ffz_finish_mt(h, *cut_args, workers) if workers > 1
              else lib.ffz_finish(h, *cut_args))
        if rc < 0:
            raise ValueError(_error(lib, h))
        if timings is not None:
            timings.update(parse_s=t1 - t0, cuts_s=t2 - t1,
                           word_build_s=time.perf_counter() - t2,
                           merge_s=lib.ffz_merge_ns(h) / 1e9)
        nwc = lib.ffz_wc_len(h)
        if spill_path is not None:
            from .blob import MmapBlob

            if lib.ffz_spill_flush(h) < 0:   # a short write: offsets
                raise OSError(_error(lib, h))  # would point past the end
            lines = MmapBlob(spill_path)
        else:
            lines = bytes_at(lib.ffz_lines_blob(h), lib.ffz_lines_blob_len(h))
        return NativeFlowFeatures(
            lines_blob=lines,
            line_off=copy_array(lib.ffz_line_offsets(h), n + 1, np.int64),
            ip_table=_table(lib, h, 0),
            word_table=_table(lib, h, 1),
            sip_id=copy_array(lib.ffz_ids(h, 0), n, np.int32),
            dip_id=copy_array(lib.ffz_ids(h, 1), n, np.int32),
            wp_id=copy_array(lib.ffz_ids(h, 2), n, np.int32),
            sw_id=copy_array(lib.ffz_ids(h, 3), n, np.int32),
            dw_id=copy_array(lib.ffz_ids(h, 4), n, np.int32),
            num_time=num_time,
            # Bins are 0-10: int16 storage (the emitters widen them).
            ibyt_bin=copy_array(lib.ffz_bins(h, 1), n, np.int16),
            ipkt_bin=copy_array(lib.ffz_bins(h, 2), n, np.int16),
            time_bin=copy_array(lib.ffz_bins(h, 0), n, np.int16),
            wc_ip=copy_array(lib.ffz_wc_ip(h), nwc, np.int32),
            wc_word=copy_array(lib.ffz_wc_word(h), nwc, np.int32),
            wc_count=narrow_counts_i32(
                copy_array(lib.ffz_wc_count(h), nwc, np.int64)),
            num_raw_events=int(lib.ffz_num_raw(h)),
            time_cuts=time_cuts,
            ibyt_cuts=ibyt_cuts,
            ipkt_cuts=ipkt_cuts,
        )
    finally:
        lib.ffz_destroy(ctypes.c_void_p(h))


def featurize_flow_file(path: str, feedback_rows: Sequence[str] = (),
                        precomputed_cuts=None, spill_path: "str | None" = None,
                        workers: int = 1, timings: "dict | None" = None):
    """Featurize raw netflow CSV input: a file, a comma-separated list, a
    directory or a glob (lineio.expand_flow_paths), cut over the union of
    its files.

    `spill_path` streams the kept raw rows to that file during ingest
    (features/blob.py): the container's pickle stores the path.
    `workers` (0 = auto, 1 = sequential, N) shards each file for the
    native pass (the Python path reads sequentially); every output byte
    is the same at any count.  `timings` (a dict) receives
    the pass walls parse_s, cuts_s, word_build_s and merge_s, and
    `pre_engine` ("native" or "python")."""
    from .shards import resolve_pre_workers

    workers = resolve_pre_workers(workers)
    paths = expand_flow_paths(path)
    if not paths:
        raise OSError(f"no flow input files match {path!r}")
    if timings is None:
        timings = {}
    lib = _LIB.load_enabled()
    if lib is not None:
        timings["pre_engine"] = "native"
        return _featurize_native(lib, paths, feedback_rows, precomputed_cuts,
                                 spill_path=spill_path, workers=workers,
                                 timings=timings)
    from itertools import chain

    from .flow import featurize_flow
    from .lineio import iter_raw_lines

    timings["pre_engine"] = "python"
    t0 = time.perf_counter()
    lines = chain.from_iterable(iter_raw_lines(p) for p in paths)
    feats = featurize_flow(lines, feedback_rows=feedback_rows,
                           precomputed_cuts=precomputed_cuts)
    timings["word_build_s"] = time.perf_counter() - t0
    return feats
