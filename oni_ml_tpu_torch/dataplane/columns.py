"""Typed columnar handoff containers for the streaming dataplane (port
of oni_ml_tpu/dataplane/columns.py).

Every stage boundary the reference serialized through a file
(word_counts.dat, the LDA-C corpus triplet, the results CSVs) becomes
an in-memory hand-off of *columns*: named 1-D numpy arrays with an
explicit declared dtype, validated at construction so a producer
cannot silently hand a consumer float doc ids or object-dtype counts.
A :class:`ColumnSet` is sliceable into bounded row chunks — the unit
that flows through a :class:`~oni_ml_tpu_torch.dataplane.channel.Channel`
between overlapped stages — and the schema travels with the data, so
a chunk is self-describing wherever it lands.

The first concrete schema is the featurizer→corpus word-count
hand-off (:data:`WORD_COUNT_SCHEMA`): table-id triples referencing the
featurizer's interned string tables, carried next to those tables in a
:class:`WordCountColumns`.  ``word_count_columns(features)`` adapts
any feature container (features/container.py) — native containers
expose their aggregated id arrays directly; the pure-Python containers
intern their ``word_counts()`` triples in first-seen order, so the
downstream first-seen remap reproduces the file contract's ids
exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


@dataclass(frozen=True)
class Column:
    """One named, dtype-checked 1-D array."""

    name: str
    values: np.ndarray
    kind: str = "i"   # numpy dtype kind the values must carry

    def __post_init__(self):
        v = self.values
        if not isinstance(v, np.ndarray) or v.ndim != 1:
            raise TypeError(
                f"column {self.name!r} must be a 1-D numpy array, got "
                f"{type(v).__name__}"
            )
        if v.dtype.kind != self.kind:
            raise TypeError(
                f"column {self.name!r} declared dtype kind {self.kind!r} "
                f"but holds {v.dtype} (kind {v.dtype.kind!r})"
            )


class ColumnSet:
    """An ordered set of equal-length Columns — one streamable table.

    Immutable after construction; `chunk(rows)` yields row-window
    views (numpy slices share the parent buffer, so chunking a day's
    word counts allocates nothing).
    """

    def __init__(self, columns: Sequence[Column]) -> None:
        if not columns:
            raise ValueError("ColumnSet needs at least one column")
        n = len(columns[0].values)
        for c in columns:
            if len(c.values) != n:
                raise ValueError(
                    f"column {c.name!r} has {len(c.values)} rows; "
                    f"{columns[0].name!r} has {n}"
                )
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in {names}")
        self._columns = tuple(columns)
        self._by_name = {c.name: c for c in self._columns}
        self.num_rows = n

    @property
    def names(self) -> list:
        return [c.name for c in self._columns]

    def schema(self) -> dict:
        """{name: dtype string} — what a consumer validates against."""
        return {c.name: str(c.values.dtype) for c in self._columns}

    def __getitem__(self, name: str) -> np.ndarray:
        return self._by_name[name].values

    def slice(self, lo: int, hi: int) -> "ColumnSet":
        return ColumnSet([
            Column(c.name, c.values[lo:hi], c.kind) for c in self._columns
        ])

    def chunks(self, rows: int) -> Iterator["ColumnSet"]:
        """Row-windows of at most `rows` rows, in order.  An empty set
        yields nothing (the consumer's close() handles zero-row
        streams)."""
        if rows < 1:
            raise ValueError(f"chunk rows must be >= 1, got {rows}")
        for lo in range(0, self.num_rows, rows):
            yield self.slice(lo, min(lo + rows, self.num_rows))


# The featurizer→corpus hand-off schema: aggregated (doc, word, count)
# triples as ids into the featurizer's interned tables.  Integral kinds
# only — the widths stay whatever the producer aggregated in (int32
# from the native containers), the declared contract is "integers".
WORD_COUNT_SCHEMA = (("doc_id", "i"), ("word_id", "i"), ("count", "i"))


@dataclass(frozen=True)
class WordCountColumns:
    """The columnar word-count hand-off: id triples + the interned
    string tables they reference.  Streaming the `ids` chunks through
    a first-seen remap (corpus_builder.StreamingCorpusBuilder)
    reproduces `Corpus.from_word_counts` over the emitted file
    byte-for-byte."""

    ids: ColumnSet
    ip_table: list
    word_table: list

    def __post_init__(self):
        want = [n for n, _ in WORD_COUNT_SCHEMA]
        if self.ids.names != want:
            raise ValueError(
                f"word-count columns must be {want}, got {self.ids.names}"
            )


def make_word_count_columns(doc_ids, word_ids, counts, ip_table,
                            word_table) -> WordCountColumns:
    cols = ColumnSet([
        Column("doc_id", np.asarray(doc_ids), "i"),
        Column("word_id", np.asarray(word_ids), "i"),
        Column("count", np.asarray(counts), "i"),
    ])
    return WordCountColumns(cols, list(ip_table), list(word_table))


def word_count_columns(features) -> WordCountColumns:
    """Adapt any feature container to the columnar hand-off.

    Containers that declare their own adapter (`word_count_columns()`
    method: the native arrays, or the pure-Python first-seen interner)
    are preferred; anything else falls back to interning the generic
    `word_counts()` triples here, in first-seen order, so the ids the
    streaming corpus builder assigns match the file contract."""
    own = getattr(features, "word_count_columns", None)
    if own is not None:
        return own()
    return intern_word_counts(features.word_counts())


def intern_word_counts(triples) -> WordCountColumns:
    """(ip, word, count) string triples -> first-seen-interned columnar
    form.  Because the tables are built in first-seen order, the
    downstream first-seen remap is the identity and the resulting
    corpus ids equal `Corpus.from_word_counts(triples)` exactly."""
    ip_index: dict = {}
    word_index: dict = {}
    d_list: list = []
    w_list: list = []
    c_list: list = []
    for ip, word, count in triples:
        d = ip_index.setdefault(ip, len(ip_index))
        w = word_index.setdefault(word, len(word_index))
        d_list.append(d)
        w_list.append(w)
        c_list.append(count)
    n = len(d_list)
    return make_word_count_columns(
        np.fromiter(d_list, np.int32, n),
        np.fromiter(w_list, np.int32, n),
        np.fromiter(c_list, np.int64, n),
        list(ip_index),
        list(word_index),
    )
