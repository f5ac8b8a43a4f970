"""What the pre, corpus and score stages ask of a feature container,
for the pure-Python ones (features/flow.FlowFeatures, dns.DnsFeatures,
sources/generic.GenericFeatures).  The native containers
(native_flow.NativeFlowFeatures, native_dns.NativeDnsFeatures) answer
the same calls over their interned id arrays, so the stages never ask
which kind of container a day produced:

- `write_word_counts(path)` -> rows written (word_counts.dat);
- `to_corpus()` -> the corpus of those word counts;
- `word_count_columns()` -> the same word counts as the dataplane's
  columnar hand-off (dataplane/columns.py), which its streaming corpus
  builder turns into that corpus;
- `event_indices(ip_index, word_index)` -> model-row index arrays;
- flow and DNS: `results_csv(...)` -> the results CSV's bytes.
"""

from __future__ import annotations

import numpy as np

from .pickling import PackedPickle


def index_rows(index: dict, queries, fallback_row: int) -> np.ndarray:
    """Model row per query, int32; misses get the fallback row."""
    get = index.get
    return np.fromiter(
        (get(s, fallback_row) for s in queries), np.int32, len(queries)
    )


def csv_blob(rows) -> bytes:
    """Row strings as newline-terminated CSV bytes."""
    return "".join(r + "\n" for r in rows).encode("utf-8", "surrogateescape")


class PythonContainer(PackedPickle):
    """word_counts.dat, the corpus and the columnar hand-off from the
    container's own `word_counts()` triples (its first-seen rule),
    computed once: kept for the to_corpus call that follows in the same
    process (which drops them), never pickled."""

    _MEMO = "_word_count_triples"

    def _triples(self) -> list:
        triples = self.__dict__.get(self._MEMO)
        if triples is None:
            triples = self.__dict__[self._MEMO] = self.word_counts()
        return triples

    def write_word_counts(self, path: str) -> int:
        from ..io import formats

        triples = self._triples()
        formats.write_word_counts(path, triples)
        return len(triples)

    def word_count_columns(self):
        """The triples interned in first-seen order
        (dataplane.intern_word_counts), so the streaming corpus builder
        assigns the file contract's ids."""
        from ..dataplane.columns import intern_word_counts

        return intern_word_counts(self._triples())

    def to_corpus(self):
        from ..io.corpus import Corpus

        triples = self.__dict__.pop(self._MEMO, None)
        return Corpus.from_word_counts(
            self.word_counts() if triples is None else triples)

    def __getstate__(self):
        state = super().__getstate__()
        state.pop(self._MEMO, None)
        return state
