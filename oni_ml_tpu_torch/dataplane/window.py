"""Ring-buffered CSR corpus window for continuous ingestion (port of
oni_ml_tpu/dataplane/window.py; host numpy, byte-identical CSR arrays).

A `CorpusWindow` consumes the columnar word-count chunks a slice's
featurization emits, each stamped with the event-time span it covers,
and keeps a sliding window over them:

* **first-seen vocabulary growth**: word ids are interned once,
  window-global, and never reassigned, so a word keeps its id across
  refreshes and day N's beta row v describes the same word day N-1's
  did (the warm-start contract).  Evicted words keep their ids; their
  counts go to zero.
* **O(evicted) retirement**: `advance(now)` pops expired chunks off the
  ring's head; nothing live is touched and no id is reassigned.
* **pow2 vocabulary capacity tiers**: `snapshot()` pads the vocabulary
  to a power-of-two capacity tier (floored at `vocab_floor`), so
  vocabulary growth inside a tier keeps the [K, V] beta shape and one
  WindowTrainer serves the tier.  Pad words never occur in a document
  and are sliced off every published model.
* **priced advances**: every `advance()` is journaled as a
  `{"kind": "window_advance"}` record and observed into the recorder's
  `dataplane.window.advance_s` histogram.

The snapshot is deterministic: documents are interned window-globally
by key (IP) but emitted in first-live-seen order over the live chunk
stream, duplicate (doc, word) pairs across chunks sum their counts, and
per-document token order is first-seen, the order `Corpus.from_features`
keeps.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..io import Corpus


def pow2_capacity(n: int, floor: int) -> int:
    """Smallest power-of-two capacity tier >= max(n, floor)."""
    cap = max(1, int(floor))
    # floor may not itself be a power of two; grow it first.
    while cap < max(n, 1):
        cap *= 2
    p = 1
    while p < cap:
        p *= 2
    return p


@dataclass
class _WindowChunk:
    """One ingested slice: (doc, word, count) rows in window-global id
    space, stamped with the event-time span it covers."""

    t0: float
    t1: float
    doc_ids: np.ndarray   # [n] int64, window-global
    word_ids: np.ndarray  # [n] int64, window-global
    counts: np.ndarray    # [n] int64

    @property
    def rows(self) -> int:
        return len(self.doc_ids)


@dataclass
class WindowSnapshot:
    """One training view of the window: a Corpus at a pow2 vocabulary
    capacity tier, plus the real (unpadded) extents a publish slices
    back to."""

    corpus: Corpus
    real_vocab: int       # live global vocabulary (pre-padding)
    vocab_capacity: int   # the pow2 tier the corpus is padded to
    t0: float             # oldest live chunk's span start
    t1: float             # newest live chunk's span end
    chunks: int
    rows: int


class _Interner:
    """Window-global string -> id map: first-seen, never reassigned."""

    def __init__(self) -> None:
        self.ids: dict = {}
        self.table: list = []

    def add_tabled(self, tabled_ids: np.ndarray, table) -> np.ndarray:
        """Map featurizer-table ids -> window-global ids.  Vectorized:
        only each chunk's unique table ids take the Python dict path."""
        tabled_ids = np.asarray(tabled_ids, np.int64)
        if len(tabled_ids) == 0:
            return tabled_ids
        uniq, first = np.unique(tabled_ids, return_index=True)
        # First-seen order within the chunk, like every other intern
        # pass in this package: the global id space is deterministic.
        appeared = uniq[np.argsort(first, kind="stable")]
        remap = np.empty(int(uniq.max()) + 1, np.int64)
        ids, tab = self.ids, self.table
        for t in appeared:
            s = table[int(t)]
            g = ids.get(s)
            if g is None:
                g = len(tab)
                ids[s] = g
                tab.append(s)
            remap[int(t)] = g
        return remap[tabled_ids]

    def __len__(self) -> int:
        return len(self.table)


class CorpusWindow:
    """Sliding event-time window of word-count chunks with first-seen
    vocabulary growth and O(evicted) retirement."""

    def __init__(
        self,
        span_s: float,
        *,
        vocab_floor: int = 4096,
        recorder=None,
        journal=None,
    ) -> None:
        if span_s <= 0:
            raise ValueError(f"window span must be > 0, got {span_s}")
        self.span_s = float(span_s)
        self.vocab_floor = int(vocab_floor)
        self._docs = _Interner()
        self._words = _Interner()
        self._chunks: deque = deque()
        self._reserved_capacity = 0
        self._recorder = recorder
        self._journal = journal
        self.ingested_chunks = 0
        self.evicted_chunks = 0
        self.evicted_rows = 0
        self.advances = 0

    # -- ingest ----------------------------------------------------------

    def ingest(self, wc, t0: float, t1: float) -> _WindowChunk:
        """Append one featurization slice's word counts.

        `wc` is a `WordCountColumns` (dataplane.columns
        word_count_columns over any feature container): table
        ids resolve to strings through its ip/word tables and intern
        into the window-global id space.  `t0`/`t1` are the slice's
        EVENT-time span in seconds; slices must arrive in
        nondecreasing t1 order (stream order)."""
        if t1 < t0:
            raise ValueError(f"slice span [{t0}, {t1}] is inverted")
        if self._chunks and t1 < self._chunks[-1].t1:
            raise ValueError(
                f"slice ending {t1} arrived after a slice ending "
                f"{self._chunks[-1].t1}: the window consumes stream "
                "order"
            )
        ids = wc.ids
        chunk = _WindowChunk(
            t0=float(t0),
            t1=float(t1),
            doc_ids=self._docs.add_tabled(ids["doc_id"], wc.ip_table),
            word_ids=self._words.add_tabled(ids["word_id"],
                                            wc.word_table),
            counts=np.asarray(ids["count"], np.int64),
        )
        self._chunks.append(chunk)
        self.ingested_chunks += 1
        return chunk

    def ingest_triples(self, triples, t0: float, t1: float) -> _WindowChunk:
        """(ip, word, count) triples instead of a columnar container."""
        rows = list(triples)
        ips = [ip for ip, _, _ in rows]
        words = [w for _, w, _ in rows]
        uniq_ip = {s: i for i, s in enumerate(dict.fromkeys(ips))}
        uniq_w = {s: i for i, s in enumerate(dict.fromkeys(words))}

        class _Cols:
            ip_table = list(uniq_ip)
            word_table = list(uniq_w)
            ids = {
                "doc_id": np.fromiter(
                    (uniq_ip[s] for s in ips), np.int64, len(rows)
                ),
                "word_id": np.fromiter(
                    (uniq_w[s] for s in words), np.int64, len(rows)
                ),
                "count": np.fromiter(
                    (c for _, _, c in rows), np.int64, len(rows)
                ),
            }

        return self.ingest(_Cols(), t0, t1)

    # -- retirement ------------------------------------------------------

    def advance(self, now_s: float) -> dict:
        """Retire chunks whose span ended before `now_s - span_s`.

        O(evicted): expired chunks pop off the ring's head and their
        arrays drop; nothing live is touched and no id is reassigned.
        Journaled as `{"kind": "window_advance"}` with the advance
        wall."""
        wall0 = time.perf_counter_ns()
        horizon = float(now_s) - self.span_s
        evicted = 0
        evicted_rows = 0
        while self._chunks and self._chunks[0].t1 <= horizon:
            old = self._chunks.popleft()
            evicted += 1
            evicted_rows += old.rows
        self.evicted_chunks += evicted
        self.evicted_rows += evicted_rows
        self.advances += 1
        wait_s = (time.perf_counter_ns() - wall0) / 1e9
        record = {
            "kind": "window_advance",
            "now_s": round(float(now_s), 3),
            "evicted_chunks": evicted,
            "evicted_rows": evicted_rows,
            "chunks": len(self._chunks),
            "rows": self.live_rows,
            "vocab": len(self._words),
            "advance_s": round(wait_s, 6),
        }
        if self._journal is not None:
            self._journal.append(record)
        rec = self._recorder
        if rec is not None:
            rec.gauge("dataplane.window.chunks", len(self._chunks))
            rec.gauge("dataplane.window.rows", self.live_rows)
            rec.histogram("dataplane.window.advance_s").observe(wait_s)
        return record

    # -- views -----------------------------------------------------------

    @property
    def live_rows(self) -> int:
        return sum(c.rows for c in self._chunks)

    @property
    def live_chunks(self) -> int:
        return len(self._chunks)

    @property
    def vocab_size(self) -> int:
        """Window-global vocabulary (never shrinks)."""
        return len(self._words)

    def vocab_capacity(self) -> int:
        return pow2_capacity(
            len(self._words),
            max(self.vocab_floor, self._reserved_capacity),
        )

    def reserve_capacity(self, capacity: int) -> int:
        """Raise the window's effective capacity floor to (at least)
        `capacity`, monotone, so the snapshot pads to that tier even
        while the vocabulary sits in a lower one (a distributed refresh
        reserves the ranks' agreed tier this way: parallel/tiers.py).
        Returns the resulting capacity."""
        cap = pow2_capacity(int(capacity), self.vocab_floor)
        self._reserved_capacity = max(self._reserved_capacity, cap)
        return self.vocab_capacity()

    def snapshot(self) -> WindowSnapshot:
        """Assemble the live window into a training Corpus.

        Documents are emitted in first-live-seen order over the live
        chunk stream; duplicate (doc, word) pairs across chunks sum
        their counts; per-doc token order is first-seen.  The
        vocabulary is the full window-global table padded to the pow2
        capacity tier: evicted-word columns carry zero counts, which
        keeps beta row alignment stable for warm starts."""
        vocab_cap = self.vocab_capacity()
        word_table = list(self._words.table)
        word_table += [
            f"__pad{i}" for i in range(vocab_cap - len(word_table))
        ]
        if not self._chunks:
            return WindowSnapshot(
                corpus=Corpus([], word_table, np.zeros(1, np.int64),
                              np.zeros(0, np.int32),
                              np.zeros(0, np.int32)),
                real_vocab=len(self._words),
                vocab_capacity=vocab_cap,
                t0=0.0, t1=0.0, chunks=0, rows=0,
            )
        d_all = np.concatenate([c.doc_ids for c in self._chunks])
        w_all = np.concatenate([c.word_ids for c in self._chunks])
        c_all = np.concatenate([c.counts for c in self._chunks])
        # Aggregate duplicate (doc, word) pairs across chunks: an IP
        # active in every slice is one document with summed counts, as
        # in the batch featurizer's day aggregation.
        key = d_all * np.int64(vocab_cap) + w_all
        uniq_key, first, inv = np.unique(
            key, return_index=True, return_inverse=True
        )
        agg_counts = np.zeros(len(uniq_key), np.int64)
        np.add.at(agg_counts, inv, c_all)
        # Stable first-appearance order of the aggregated pairs keeps
        # the snapshot's token order equal to the dedup'd stream order.
        order = np.argsort(first, kind="stable")
        d_arr = (uniq_key // vocab_cap)[order]
        w_arr = (uniq_key % vocab_cap)[order]
        cnt = agg_counts[order]
        # Live documents in first-live-seen order (global doc ids are
        # window-lifetime; the snapshot re-densifies over the live
        # subset so retired IPs do not ride along as empty docs).
        uniq_d, first_d = np.unique(d_arr, return_index=True)
        live_order = uniq_d[np.argsort(first_d, kind="stable")]
        remap = np.full(int(uniq_d.max()) + 1, -1, np.int64)
        remap[live_order] = np.arange(len(live_order))
        d_local = remap[d_arr]
        perm = np.argsort(d_local, kind="stable")
        ptr = np.zeros(len(live_order) + 1, np.int64)
        np.cumsum(np.bincount(d_local, minlength=len(live_order)),
                  out=ptr[1:])
        doc_table = self._docs.table
        corpus = Corpus(
            [doc_table[int(d)] for d in live_order],
            word_table,
            ptr,
            w_arr[perm].astype(np.int32, copy=False),
            cnt[perm].astype(np.int32, copy=False),
        )
        return WindowSnapshot(
            corpus=corpus,
            real_vocab=len(self._words),
            vocab_capacity=vocab_cap,
            t0=self._chunks[0].t0,
            t1=self._chunks[-1].t1,
            chunks=len(self._chunks),
            rows=int(len(d_all)),
        )
