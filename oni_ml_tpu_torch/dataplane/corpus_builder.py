"""Incremental corpus assembly over streamed word-count columns (port of
oni_ml_tpu/dataplane/corpus_builder.py).

`Corpus.from_features` (the container's `to_corpus`) is a batch operation: it sees the whole day's
aggregated (doc, word, count) id arrays at once and assigns corpus ids
in first-seen order.  The streaming dataplane instead hands the same
arrays to the corpus stage as bounded *chunks* through a Channel, and
`StreamingCorpusBuilder` assigns ids incrementally as chunks arrive —
first-seen order over a sequentially-consumed chunk stream is first-
seen order over the concatenation, so the finished corpus is
byte-identical (ids, CSR layout, tables) to the batch path and to
parsing the emitted word_counts.dat (pinned by
tests/test_torch_dataplane.py).

This is the structural piece that removes the pre→corpus full-day
barrier: the featurizer's output streams into interning/remapping work
while the pre stage's demoted checkpoint writes (features.pkl,
word_counts.dat) are still in flight — and it is the shape continuous
ingestion needs, where chunks arrive minutes apart instead of from an
in-memory slice.
"""

from __future__ import annotations

import numpy as np

from ..io import Corpus
from .columns import ColumnSet, WordCountColumns

# Rows per columnar chunk on the featurizer -> corpus edge.
CHUNK_ROWS = 1 << 18


class _FirstSeenRemap:
    """Growable old-table-id -> first-seen-corpus-id map."""

    def __init__(self) -> None:
        self._remap = np.full(0, -1, np.int64)
        self._order: list = []     # table ids in first-seen order

    def add(self, ids: np.ndarray) -> np.ndarray:
        """Assign corpus ids to any unseen table ids in `ids` (in order
        of first appearance within the chunk) and return the remapped
        chunk."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return ids
        hi = int(ids.max()) + 1
        if hi > len(self._remap):
            grown = np.full(hi, -1, np.int64)
            grown[: len(self._remap)] = self._remap
            self._remap = grown
        uniq, first = np.unique(ids, return_index=True)
        appeared = uniq[np.argsort(first, kind="stable")]
        fresh = appeared[self._remap[appeared] < 0]
        if len(fresh):
            base = len(self._order)
            self._remap[fresh] = np.arange(base, base + len(fresh))
            self._order.extend(int(t) for t in fresh)
        return self._remap[ids]

    @property
    def order(self) -> list:
        return self._order


class StreamingCorpusBuilder:
    """Consume word-count chunks in stream order; `finish()` yields the
    Corpus the batch path would have built."""

    def __init__(self) -> None:
        self._docs = _FirstSeenRemap()
        self._words = _FirstSeenRemap()
        self._d_chunks: list = []
        self._w_chunks: list = []
        self._c_chunks: list = []
        self.chunks = 0
        self.rows = 0

    def add(self, chunk: ColumnSet) -> None:
        self.add_arrays(chunk["doc_id"], chunk["word_id"], chunk["count"])

    def add_arrays(self, doc_ids, word_ids, counts) -> None:
        doc_ids = np.asarray(doc_ids)
        word_ids = np.asarray(word_ids)
        counts = np.asarray(counts)
        if not (len(doc_ids) == len(word_ids) == len(counts)):
            raise ValueError(
                f"ragged word-count chunk: {len(doc_ids)}/"
                f"{len(word_ids)}/{len(counts)} rows"
            )
        self._d_chunks.append(self._docs.add(doc_ids))
        self._w_chunks.append(self._words.add(word_ids))
        self._c_chunks.append(counts)
        self.chunks += 1
        self.rows += len(doc_ids)

    def finish(self, ip_table, word_table) -> Corpus:
        """CSR assembly, exactly `Corpus.from_interned`'s tail: stable
        argsort by doc groups tokens per document while preserving
        appearance order."""
        if self.rows == 0:
            return Corpus([], [], np.zeros(1, np.int64),
                          np.zeros(0, np.int32), np.zeros(0, np.int32))
        d_arr = np.concatenate(self._d_chunks)
        w_arr = np.concatenate(self._w_chunks)
        c_arr = np.concatenate(self._c_chunks)
        perm = np.argsort(d_arr, kind="stable")
        num_docs = len(self._docs.order)
        ptr = np.zeros(num_docs + 1, dtype=np.int64)
        np.cumsum(np.bincount(d_arr, minlength=num_docs), out=ptr[1:])
        return Corpus(
            [ip_table[t] for t in self._docs.order],
            [word_table[t] for t in self._words.order],
            ptr,
            w_arr[perm].astype(np.int32, copy=False),
            c_arr[perm].astype(np.int32, copy=False),
        )


def stream_word_counts(wc: WordCountColumns, channel,
                       chunk_rows: int = CHUNK_ROWS) -> int:
    """Producer half of the pre→corpus edge: push the columnar
    word-count hand-off through `channel` in bounded chunks, then
    close.  Failures poison the channel so the consumer unblocks with
    the producer's error instead of waiting forever."""
    n = 0
    try:
        for chunk in wc.ids.chunks(chunk_rows):
            channel.put(chunk)
            n += 1
    except BaseException as e:
        channel.fail(e)
        raise
    channel.close()
    return n


def consume_corpus(channel, ip_table, word_table) -> "tuple[Corpus, StreamingCorpusBuilder]":
    """Consumer half: drain the channel into a builder and finish.

    A consumer-side failure poisons the channel before propagating —
    otherwise a producer blocked in put() backpressure would wait
    forever and deadlock the plane's drain join (the dual of
    stream_word_counts' producer-side poisoning)."""
    builder = StreamingCorpusBuilder()
    try:
        for chunk in channel:
            builder.add(chunk)
        corpus = builder.finish(ip_table, word_table)
    except BaseException as e:
        channel.fail(e)
        raise
    return corpus, builder
