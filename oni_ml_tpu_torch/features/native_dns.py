"""ctypes binding of the native DNS featurizer
(native_src/dns_featurize.cpp; port of oni_ml_tpu/features/native_dns.py).

`featurize_dns_sources` is the DNS pre stage's entry point: CSV files
stream through C++ (sharded over `workers` threads with a deterministic
first-seen merge); parquet rows and feedback rows are projected to
8-column rows in Python and handed over as one \\x1f-separated blob.
`ONI_ML_TPU_NO_NATIVE=1` runs the pure-Python `features.dns.featurize_dns`
instead.  A build or load failure of the library raises.

One rule sends a day to the Python path with the library present: a
field that embeds a transport byte ('\\n', '\\r', the '\\x1f' separator)
or a lone surrogate cannot ride the native blob unchanged, so the whole
day takes the Python path, which gives the same output for every other
day; `timings` then says so, with the reason.

The ECDF cuts are computed in Python from the native pass's arrays
with quantiles.ecdf_cuts (the positive-subset quintiles for subdomain
length, entropy and period count), once over the merged arrays.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Sequence

import numpy as np

from ..native_build import NativeLib, bytes_at, narrow_counts_i32
from .native_flow import InternedCounts, copy_array, string_table
from .quantiles import DECILES, QUINTILES, ecdf_cuts

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_SEP = "\x1f"

# Why a day with the library present took the Python path.
ROWS_UNSAFE = ("a field embeds '\\n', '\\r' or the '\\x1f' separator, or a "
               "lone surrogate")
CSV_UNSAFE = "a CSV field embeds the '\\x1f' separator"


def _configure(lib: ctypes.CDLL) -> None:
    lib.dfz_create.restype = ctypes.c_void_p
    lib.dfz_destroy.argtypes = [ctypes.c_void_p]
    lib.dfz_error.restype = ctypes.c_char_p
    lib.dfz_error.argtypes = [ctypes.c_void_p]
    lib.dfz_ingest_csv_file.restype = ctypes.c_int64
    lib.dfz_ingest_csv_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.dfz_ingest_csv_file_parallel.restype = ctypes.c_int64
    lib.dfz_ingest_csv_file_parallel.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dfz_merge_ns.restype = ctypes.c_int64
    lib.dfz_merge_ns.argtypes = [ctypes.c_void_p]
    lib.dfz_ingest_rows.restype = ctypes.c_int64
    lib.dfz_ingest_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.dfz_mark_raw.argtypes = [ctypes.c_void_p]
    lib.dfz_unsafe.restype = ctypes.c_int
    lib.dfz_unsafe.argtypes = [ctypes.c_void_p]
    for fn in ("dfz_num_raw", "dfz_num_events", "dfz_rows_blob_len",
               "dfz_wc_len"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("dfz_tstamp", "dfz_frame_len", "dfz_entropy"):
        getattr(lib, fn).restype = _F64P
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("dfz_sublen", "dfz_nparts", "dfz_top"):
        getattr(lib, fn).restype = _I32P
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    cuts = [_F64P, ctypes.c_int] * 5 + [ctypes.c_char_p, ctypes.c_int64]
    lib.dfz_finish.restype = ctypes.c_int
    lib.dfz_finish.argtypes = [ctypes.c_void_p, *cuts]
    lib.dfz_finish_mt.restype = ctypes.c_int
    lib.dfz_finish_mt.argtypes = [ctypes.c_void_p, *cuts, ctypes.c_int]
    lib.dfz_ids.restype = _I32P
    lib.dfz_ids.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dfz_table_count.restype = ctypes.c_int64
    lib.dfz_table_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dfz_table_blob.restype = ctypes.c_void_p
    lib.dfz_table_blob.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dfz_table_blob_len.restype = ctypes.c_int64
    lib.dfz_table_blob_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dfz_table_offsets.restype = _I64P
    lib.dfz_table_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dfz_rows_blob.restype = ctypes.c_void_p
    lib.dfz_rows_blob.argtypes = [ctypes.c_void_p]
    lib.dfz_set_spill.restype = ctypes.c_int
    lib.dfz_set_spill.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dfz_spill_flush.restype = ctypes.c_int64
    lib.dfz_spill_flush.argtypes = [ctypes.c_void_p]
    lib.dfz_row_offsets.restype = _I64P
    lib.dfz_row_offsets.argtypes = [ctypes.c_void_p]
    for fn, res in (("dfz_wc_ip", _I32P), ("dfz_wc_word", _I32P),
                    ("dfz_wc_count", _I64P)):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = [ctypes.c_void_p]


_LIB = NativeLib("dns", _configure)


def _table(lib, h, which: int) -> "list[str]":
    cnt = lib.dfz_table_count(h, which)
    blob = bytes_at(lib.dfz_table_blob(h, which),
                    lib.dfz_table_blob_len(h, which))
    return string_table(blob, copy_array(lib.dfz_table_offsets(h, which),
                                         cnt + 1, np.int64))


class NativeDnsFeatures(InternedCounts):
    """DnsFeatures' surface over native arrays (see NativeFlowFeatures):
    the projected 8-column rows are one \\x1f-separated blob with offsets;
    client IPs, domains, subdomains and words are interned tables."""

    def __init__(self, *, rows_blob, row_off, ip_table, domain_table,
                 subdomain_table, word_table, ip_id, dom_id, sub_id, word_id,
                 subdomain_length, num_periods, subdomain_entropy, top_domain,
                 wc_ip, wc_word, wc_count, num_raw_events, time_cuts,
                 frame_length_cuts, subdomain_length_cuts, entropy_cuts,
                 numperiods_cuts):
        self.rows_blob = rows_blob
        self.row_off = row_off
        self.ip_table = ip_table
        self.domain_table = domain_table
        self.subdomain_table = subdomain_table
        self.word_table = word_table
        self.ip_id = ip_id
        self.dom_id = dom_id
        self.sub_id = sub_id
        self.word_id = word_id
        self.subdomain_length = subdomain_length
        self.num_periods = num_periods
        self.subdomain_entropy = subdomain_entropy
        self.top_domain = top_domain
        self.wc_ip = wc_ip
        self.wc_word = wc_word
        self.wc_count = wc_count
        self.num_raw_events = num_raw_events
        self.time_cuts = time_cuts
        self.frame_length_cuts = frame_length_cuts
        self.subdomain_length_cuts = subdomain_length_cuts
        self.entropy_cuts = entropy_cuts
        self.numperiods_cuts = numperiods_cuts
        self._lists: "dict[str, list[str]]" = {}

    @property
    def num_events(self) -> int:
        return len(self.ip_id)

    def row(self, i: int) -> "list[str]":
        raw = self.rows_blob[self.row_off[i]:self.row_off[i + 1]]
        return raw.decode("utf-8", "surrogateescape").split(_SEP)

    def client_ip(self, i: int) -> str:
        return self.ip_table[self.ip_id[i]]

    def _list(self, which: str) -> "list[str]":
        if which not in self._lists:
            table, ids = {
                "domain": (self.domain_table, self.dom_id),
                "subdomain": (self.subdomain_table, self.sub_id),
                "word": (self.word_table, self.word_id),
            }[which]
            self._lists[which] = [table[j] for j in ids]
        return self._lists[which]

    @property
    def domain(self) -> "list[str]":
        return self._list("domain")

    @property
    def subdomain(self) -> "list[str]":
        return self._list("subdomain")

    @property
    def word(self) -> "list[str]":
        return self._list("word")

    @property
    def rows(self) -> "list[list[str]]":
        return [self.row(i) for i in range(self.num_events)]

    def featurized_row(self, i: int) -> "list[str]":
        return self.row(i) + [
            self.domain_table[self.dom_id[i]],
            self.subdomain_table[self.sub_id[i]],
            str(int(self.subdomain_length[i])),
            str(int(self.num_periods[i])),
            str(self.subdomain_entropy[i]),
            str(int(self.top_domain[i])),
            self.word_table[self.word_id[i]],
        ]

    def event_indices(self, ip_index: dict, word_index: dict):
        """DnsFeatures.event_indices, resolved once per unique IP and
        word."""
        n = self.num_raw_events
        ip_map, word_map = self._rows_of(ip_index, word_index)
        return ip_map[self.ip_id[:n]], word_map[self.word_id[:n]]

    def results_csv(self, scores, order) -> bytes:
        """DnsFeatures.results_csv's bytes, assembled in C++
        (native_emit.dns_emit)."""
        from ..native_emit import dns_emit

        return dns_emit(self, scores, order)

    def results_rows(self, scores, order) -> "list[str]":
        # No field of a native container embeds '\n' (the transport-byte
        # rule), so the emitted lines are the rows.
        return self.results_csv(scores, order).decode(
            "utf-8", "surrogateescape").split("\n")[:-1]

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lists")
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lists = {}


def _rows_to_blob_checked(rows: Sequence[Sequence[str]]) -> "bytes | None":
    """Rows joined for native ingest, or None when a field embeds '\\n',
    '\\r' or the '\\x1f' separator (a field holding the separator shows
    as a separator-count mismatch) or a lone surrogate (not
    UTF-8-encodable): such a day takes the Python path."""
    if not rows:
        return b""
    parts = []
    sep = _SEP
    for r in rows:
        j = sep.join(r)
        if r and ("\n" in j or "\r" in j or j.count(sep) != len(r) - 1):
            return None
        parts.append(j)
    try:
        return ("\n".join(parts) + "\n").encode("utf-8")
    except UnicodeEncodeError:
        return None


def _error(lib, h) -> str:
    return lib.dfz_error(h).decode("utf-8", "replace")


def _featurize_native(lib, sources: Sequence, feedback_rows, top_domains,
                      spill_path=None, workers=1, timings=None):
    """The native pass -> (NativeDnsFeatures, None), or (None, reason)
    when a field embeds a transport byte: the caller then removes the
    partly written spill file and runs the whole day in Python."""
    h = lib.dfz_create()
    try:
        if spill_path is not None and lib.dfz_set_spill(
                h, os.fsencode(spill_path)) < 0:
            raise OSError(_error(lib, h))
        t0 = time.perf_counter()
        for src in sources:
            if isinstance(src, str):
                rc = (lib.dfz_ingest_csv_file_parallel(
                          h, os.fsencode(src), 0, workers)
                      if workers > 1
                      else lib.dfz_ingest_csv_file(h, os.fsencode(src), 0))
                if rc < 0:
                    raise OSError(_error(lib, h))
            elif src:
                # In-memory rows (parquet) stay sequential, one blob
                # alive at a time.
                blob = _rows_to_blob_checked(src)
                if blob is None:
                    return None, ROWS_UNSAFE
                if lib.dfz_ingest_rows(h, blob, len(blob)) < 0:
                    raise OSError(_error(lib, h))
                del blob
        if lib.dfz_unsafe(h):
            return None, CSV_UNSAFE
        lib.dfz_mark_raw(h)
        if feedback_rows:
            blob = _rows_to_blob_checked(feedback_rows)
            if blob is None:
                return None, ROWS_UNSAFE
            if lib.dfz_ingest_rows(h, blob, len(blob)) < 0:
                raise OSError(_error(lib, h))
            del blob
        t1 = time.perf_counter()
        n = lib.dfz_num_events(h)
        tstamp = copy_array(lib.dfz_tstamp(h), n, np.float64)
        frame_len = copy_array(lib.dfz_frame_len(h), n, np.float64)
        entropy = copy_array(lib.dfz_entropy(h), n, np.float64)
        # int32, the C featurizer's own storage (widened at emit time).
        sub_len = copy_array(lib.dfz_sublen(h), n, np.int32)
        n_parts = copy_array(lib.dfz_nparts(h), n, np.int32)
        time_cuts = ecdf_cuts(tstamp, DECILES)
        frame_length_cuts = ecdf_cuts(frame_len, DECILES)
        subdomain_length_cuts = ecdf_cuts(sub_len[sub_len > 0], QUINTILES)
        entropy_cuts = ecdf_cuts(entropy[entropy > 0], QUINTILES)
        numperiods_cuts = ecdf_cuts(n_parts[n_parts > 0], QUINTILES)
        top_blob = "\n".join(sorted(top_domains)).encode(
            "utf-8", "surrogateescape")

        def fp(a):
            return np.ascontiguousarray(a, np.float64).ctypes.data_as(_F64P)

        t2 = time.perf_counter()
        cut_args = []
        for c in (time_cuts, frame_length_cuts, subdomain_length_cuts,
                  entropy_cuts, numperiods_cuts):
            cut_args += [fp(c), len(c)]
        cut_args += [top_blob, len(top_blob)]
        rc = (lib.dfz_finish_mt(h, *cut_args, workers) if workers > 1
              else lib.dfz_finish(h, *cut_args))
        if rc < 0:
            raise ValueError(_error(lib, h))
        if timings is not None:
            timings.update(parse_s=t1 - t0, cuts_s=t2 - t1,
                           word_build_s=time.perf_counter() - t2,
                           merge_s=lib.dfz_merge_ns(h) / 1e9)
        nwc = lib.dfz_wc_len(h)
        if spill_path is not None:
            from .blob import MmapBlob

            if lib.dfz_spill_flush(h) < 0:
                raise OSError(_error(lib, h))
            rows_blob = MmapBlob(spill_path)
        else:
            rows_blob = bytes_at(lib.dfz_rows_blob(h),
                                 lib.dfz_rows_blob_len(h))
        return NativeDnsFeatures(
            rows_blob=rows_blob,
            row_off=copy_array(lib.dfz_row_offsets(h), n + 1, np.int64),
            ip_table=_table(lib, h, 0),
            domain_table=_table(lib, h, 1),
            subdomain_table=_table(lib, h, 2),
            word_table=_table(lib, h, 3),
            ip_id=copy_array(lib.dfz_ids(h, 0), n, np.int32),
            dom_id=copy_array(lib.dfz_ids(h, 1), n, np.int32),
            sub_id=copy_array(lib.dfz_ids(h, 2), n, np.int32),
            word_id=copy_array(lib.dfz_ids(h, 3), n, np.int32),
            subdomain_length=sub_len,
            num_periods=n_parts,
            subdomain_entropy=entropy,
            top_domain=copy_array(lib.dfz_top(h), n, np.int16),  # {0,1,2}
            wc_ip=copy_array(lib.dfz_wc_ip(h), nwc, np.int32),
            wc_word=copy_array(lib.dfz_wc_word(h), nwc, np.int32),
            wc_count=narrow_counts_i32(
                copy_array(lib.dfz_wc_count(h), nwc, np.int64)),
            num_raw_events=int(lib.dfz_num_raw(h)),
            time_cuts=time_cuts,
            frame_length_cuts=frame_length_cuts,
            subdomain_length_cuts=subdomain_length_cuts,
            entropy_cuts=entropy_cuts,
            numperiods_cuts=numperiods_cuts,
        ), None
    finally:
        lib.dfz_destroy(ctypes.c_void_p(h))


def featurize_dns_sources(sources: Sequence = (),
                          top_domains: frozenset = frozenset(),
                          feedback_rows: Sequence[Sequence[str]] = (),
                          spill_path: "str | None" = None, workers: int = 1,
                          timings: "dict | None" = None):
    """Featurize DNS events: `sources` is an ordered sequence of CSV paths
    (str) and pre-projected 8-column row lists (parquet); events enter
    in that order (the first-seen id contract).

    `spill_path` streams the stored rows to that file during ingest;
    `workers` (0 = auto, 1 = sequential, N) shards each CSV file for the
    native pass (the Python path reads sequentially), the bytes the same
    at any count.  `timings` (a dict) receives the pass
    walls parse_s, cuts_s, word_build_s and merge_s, `pre_engine`
    ("native" or "python") and, when a transport byte sent the day to
    the Python path with the library present, `python_reason`."""
    from .shards import resolve_pre_workers

    workers = resolve_pre_workers(workers)
    if timings is None:
        timings = {}
    lib = _LIB.load_enabled()
    if lib is not None:
        feats, reason = _featurize_native(
            lib, sources, feedback_rows, top_domains, spill_path=spill_path,
            workers=workers, timings=timings)
        if feats is not None:
            timings["pre_engine"] = "native"
            return feats
        timings["python_reason"] = reason
        if spill_path is not None and os.path.exists(spill_path):
            os.remove(spill_path)  # the native pass's partial spill
    from .dns import featurize_dns
    from .lineio import iter_raw_lines

    timings["pre_engine"] = "python"
    t0 = time.perf_counter()
    rows: "list[list[str]]" = []
    for src in sources:
        if isinstance(src, str):
            rows.extend(line.split(",") for line in iter_raw_lines(src)
                        if line)
        else:
            rows.extend(list(r) for r in src)
    t1 = time.perf_counter()
    feats = featurize_dns(rows, top_domains=top_domains,
                          feedback_rows=feedback_rows)
    timings.update(parse_s=t1 - t0, word_build_s=time.perf_counter() - t1)
    return feats
