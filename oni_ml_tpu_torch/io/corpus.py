"""In-memory corpus (port of oni_ml_tpu/io/corpus.py): first-seen-order
vocab/doc ids + CSR token arrays + the bucketed layout the sparse
E-step trains over.

The reference builds its corpus in three sequential dict passes
(lda_pre.py:30-94): word ids assigned in first-seen order over
``doc_wc.dat``, doc ids 1-based in first-seen order.  That ordering is part
of the file contract (words.dat / doc.dat line numbers are the join keys
used by lda_post.py:57 linecache lookups), so ``from_word_counts``
reproduces it exactly.

Documents are power-law ragged, so they are bucketed by unique-word
count into power-of-two length buckets, each padded to a batch of at
most `batch_cap` docs.  The layout is the JAX package's exactly (the
tests pin the arrays equal), so both trainers see the same batches;
padding tokens carry count 0 and padding docs are masked, both
arithmetically inert in the E-step (phi * 0 = 0 contributions).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np

from . import formats


@dataclass
class Corpus:
    """Bag-of-words corpus in CSR layout.

    doc_names[d] is the document key (an IP address in the reference's
    pipelines); vocab[w] is the word string.  Token j of document d lives at
    word_idx[doc_ptr[d]:doc_ptr[d+1]] with multiplicity counts[...].
    """

    doc_names: list[str]
    vocab: list[str]
    doc_ptr: np.ndarray  # [D+1] int64
    word_idx: np.ndarray  # [NNZ] int32
    counts: np.ndarray  # [NNZ] int32

    @property
    def num_docs(self) -> int:
        return len(self.doc_ptr) - 1

    @property
    def num_terms(self) -> int:
        return len(self.vocab)

    @property
    def num_tokens(self) -> int:
        return int(self.counts.sum())

    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.doc_ptr)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_word_counts(cls, triples: Iterable[tuple[str, str, int]]) -> "Corpus":
        """Build from ``(ip, word, count)`` triples, assigning ids in
        first-seen order exactly like lda_pre.py:30-77.

        Interning stays a dict pass (it defines the id order), but the
        CSR fill is vectorized: flat (doc, word, count) arrays gathered
        in one ``np.fromiter`` pass each, then a stable argsort by doc
        groups tokens per document while preserving their appearance
        order — the former nested per-doc/per-token Python loop scaled
        with every token of the day."""
        word_ids: dict[str, int] = {}
        doc_ids: dict[str, int] = {}
        d_list: list[int] = []
        w_list: list[int] = []
        c_list: list[int] = []
        for ip, word, count in triples:
            w_list.append(word_ids.setdefault(word, len(word_ids)))
            d = doc_ids.get(ip)
            if d is None:
                d = len(doc_ids)
                doc_ids[ip] = d
            d_list.append(d)
            c_list.append(count)

        nnz = len(d_list)
        d_arr = np.fromiter(d_list, dtype=np.int64, count=nnz)
        widx = np.fromiter(w_list, dtype=np.int32, count=nnz)
        cnts = np.fromiter(c_list, dtype=np.int32, count=nnz)
        perm = np.argsort(d_arr, kind="stable")
        ptr = np.zeros(len(doc_ids) + 1, dtype=np.int64)
        np.cumsum(np.bincount(d_arr, minlength=len(doc_ids)), out=ptr[1:])
        return cls(
            list(doc_ids), list(word_ids), ptr, widx[perm], cnts[perm]
        )

    @classmethod
    def from_features(cls, features) -> "Corpus":
        """Direct featurizer->corpus hand-off: the corpus of the
        featurized day's word-count triples, identical to parsing the
        word_counts.dat the pre stage emits (first-seen ids)."""
        return cls.from_word_counts(features.word_counts())

    def bucket_shapes(
        self,
        min_len: int = 128,
        batch_cap: int = 4096,
        pad_multiple: int = 8,
    ) -> "list[tuple[int, int, int]]":
        """The padded (B, L, real_docs) batch shapes `bucketed_layout`
        with the same parameters would produce — derived from doc
        lengths alone, without the O(tokens) packing pass."""
        if min_len < 1:
            raise ValueError(f"min_len must be >= 1, got {min_len}")
        lengths = np.maximum(self.doc_lengths(), 1)
        buck = np.maximum(
            min_len, 2 ** np.ceil(np.log2(lengths)).astype(np.int64)
        )
        shapes: list[tuple[int, int, int]] = []
        for L in np.unique(buck):
            n = int((buck == L).sum())
            for start in range(0, n, batch_cap):
                c = min(batch_cap, n - start)
                shapes.append(
                    (-(-c // pad_multiple) * pad_multiple, int(L), c)
                )
        return shapes

    def bucketed_layout(
        self,
        min_len: int = 128,
        batch_cap: int = 4096,
        pad_multiple: int = 8,
    ) -> "BucketedLayout":
        """Pack the corpus into length-sorted power-of-two buckets of
        padded [B, L] word-id/count tiles — the sparse E-step's corpus
        layout (ops/sparse_estep.py).

        Documents are stable-sorted by token count and binned into
        power-of-two length buckets floored at `min_len`; each bucket
        splits into batches of at most `batch_cap` docs, the batch axis
        padded to a multiple of `pad_multiple` (so a power-of-two doc
        block divides it).  The whole pass is vectorized CSR
        gathers — no per-doc Python loop — and the result is cached on
        this Corpus, keyed by the three parameters.  The returned
        layout's perm/inv_perm restore document order bit-exactly.
        """
        key = (min_len, batch_cap, pad_multiple)
        cache = getattr(self, "_layout_cache", None)
        if cache is None:
            cache = {}
            # Corpus is a plain dataclass; the cache rides as an
            # instance attribute so dataclass equality/replace ignore it.
            object.__setattr__(self, "_layout_cache", cache)
        if key in cache:
            return cache[key]
        if min_len < 1:
            raise ValueError(f"min_len must be >= 1, got {min_len}")
        lengths = self.doc_lengths()
        d = self.num_docs
        # Stable sort by token count: ties keep first-seen doc order, so
        # the layout (and therefore every artifact downstream of a
        # pinned sparse run) is deterministic.
        order = np.argsort(lengths, kind="stable").astype(np.int64)
        # Power-of-two bucket length per doc, floored at min_len
        # (empty docs ride the smallest bucket; their zero counts are
        # arithmetically inert, same rule as make_batches).
        clamped = np.maximum(lengths, 1)
        buck = np.maximum(
            min_len,
            2 ** np.ceil(np.log2(clamped)).astype(np.int64),
        )
        batches: list[Batch] = []
        perm_parts: list[np.ndarray] = []
        for L in np.unique(buck[order]):
            docs = order[buck[order] == L]
            for start in range(0, len(docs), batch_cap):
                chunk = docs[start:start + batch_cap]
                n = len(chunk)
                b = -(-n // pad_multiple) * pad_multiple
                # Vectorized CSR gather: token j of packed row i lives
                # at word_idx[ptr[d_i] + j] while j < len(d_i), else
                # pad (id 0, count 0).
                col = np.arange(int(L), dtype=np.int64)[None, :]
                lens = lengths[chunk][:, None]
                src = np.minimum(
                    self.doc_ptr[chunk][:, None] + col,
                    len(self.word_idx) - 1 if len(self.word_idx) else 0,
                )
                live = col < lens
                widx = np.zeros((b, int(L)), np.int32)
                cnts = np.zeros((b, int(L)), np.float32)
                if len(self.word_idx):
                    widx[:n] = np.where(live, self.word_idx[src], 0)
                    cnts[:n] = np.where(live, self.counts[src], 0)
                didx = np.zeros((b,), np.int32)
                didx[:n] = chunk
                mask = np.zeros((b,), np.float32)
                mask[:n] = 1.0
                batches.append(Batch(widx, cnts, didx, mask))
                perm_parts.append(chunk)
        perm = (
            np.concatenate(perm_parts) if perm_parts
            else np.zeros(0, np.int64)
        )
        inv_perm = np.empty(d, np.int64)
        inv_perm[perm] = np.arange(d, dtype=np.int64)
        layout = BucketedLayout(
            batches=tuple(batches), perm=perm, inv_perm=inv_perm,
            min_len=min_len,
        )
        cache[key] = layout
        return layout

    # -- serialization (reference contracts) --------------------------------

    def save(self, directory: str) -> None:
        """Write words.dat / doc.dat / model.dat into ``directory``."""
        import os

        formats.write_words_dat(os.path.join(directory, "words.dat"), self.vocab)
        formats.write_doc_dat(os.path.join(directory, "doc.dat"), self.doc_names)
        formats.write_model_dat(
            os.path.join(directory, "model.dat"), self.doc_ptr, self.word_idx, self.counts
        )

@dataclass
class Batch:
    """One padded device batch of documents.

    word_idx[B, L] int32 (0 where padded), counts[B, L] f32 (0 where padded),
    doc_index[B] int32 global doc ids (0 where padded), doc_mask[B] f32.
    """

    word_idx: np.ndarray
    counts: np.ndarray
    doc_index: np.ndarray
    doc_mask: np.ndarray


@dataclass(frozen=True)
class BucketedLayout:
    """Length-sorted, power-of-two-bucketed packing of a corpus — the
    sparse E-step engine's device layout (ops/sparse_estep.py).

    `batches` are ordinary padded `Batch` tiles, built by ONE
    vectorized pass (a stable argsort by token count, then CSR
    gathers).

    `perm[j]` is the ORIGINAL doc id of the j-th real (unmasked) row in
    packed order; `inv_perm` inverts it, so `values[inv_perm]` restores
    document order bit-exactly from per-row results concatenated in
    layout order (`restore()`).  The layout is cached on the Corpus —
    building it is an O(tokens) host pass that must run once per
    (min_len, batch_cap, pad_multiple), not once per consumer.
    """

    batches: tuple          # tuple[Batch]
    perm: np.ndarray        # [D] int64: packed position -> original doc id
    inv_perm: np.ndarray    # [D] int64: original doc id -> packed position
    min_len: int

    def restore(self, packed_rows: np.ndarray) -> np.ndarray:
        """Per-doc values in packed (layout) order -> original document
        order.  Exact: a pure permutation gather, no arithmetic."""
        packed_rows = np.asarray(packed_rows)
        if packed_rows.shape[0] != len(self.perm):
            raise ValueError(
                f"{packed_rows.shape[0]} packed rows for "
                f"{len(self.perm)} documents"
            )
        return packed_rows[self.inv_perm]
