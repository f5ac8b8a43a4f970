"""Declarative table sources: a SourceSpec built from data, not code
(port of oni_ml_tpu/sources/generic.py, the batch-day parts).

`TableSourceSpec` turns a field list, per-field quantile-cut strategies
and a word template into a batch-day source: featurization and scoring,
with no per-source Python beyond the declaration.  The spec round-trips
through `to_dict`/`from_dict`, so a new source can ship as JSON.

The proxy/HTTP log source (`ProxySource`) is the first one: 10-column
web-proxy events, the querying client as the document, and a word
binning method/status with duration, response bytes and host-name
entropy.

Field kinds:

  * ``number``  — float(column), NaN-defaulting like features/flow.py
  * ``hms``     — "HH:MM:SS" column -> seconds of day
  * ``entropy`` — Shannon entropy of the column string
                  (features/dns.py's compensated accumulation)
  * ``length``  — len(column)

Cut strategies are the reference's ECDF deciles/quintiles
(features/quantiles.py).  Serving featurizes a table source's
micro-batches through `GenericEventFeaturizer`, pinned to the trained
day's cuts.  Not ported yet (the continuous service calls it):
`event_time_s`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from ..features.container import PythonContainer, csv_blob, index_rows
from .spec import SourceSpec

_STRATEGIES = ("decile", "quintile")
_FIELD_KINDS = ("number", "hms", "entropy", "length")


@dataclass(frozen=True)
class FieldDef:
    """One derived value per event: `name` is the word-template key,
    `column` the source column it reads, `kind` the parse rule."""

    name: str
    column: str
    kind: str = "number"

    def __post_init__(self) -> None:
        if self.kind not in _FIELD_KINDS:
            raise ValueError(
                f"field {self.name!r}: kind must be one of "
                f"{_FIELD_KINDS}, got {self.kind!r}"
            )


@dataclass(frozen=True)
class CutDef:
    """Quantile-cut strategy for one field; binned fields render their
    bin (not their value) in the word template."""

    field: str
    strategy: str = "decile"
    positive_only: bool = False

    def __post_init__(self) -> None:
        if self.strategy not in _STRATEGIES:
            raise ValueError(
                f"cut on {self.field!r}: strategy must be one of "
                f"{_STRATEGIES}, got {self.strategy!r}"
            )


class GenericFeatures(PythonContainer):
    """Feature container for declaratively-featurized events — the
    TableSourceSpec analogue of FlowFeatures/DnsFeatures.  Rows past
    ``num_raw_events`` are feedback duplicates: they train the model
    but are never scored or emitted."""

    _PACKED = ("rows", "word")

    def __init__(self, source_name: str, doc_col: int,
                 rows: "list[list[str]]", word: "list[str]",
                 bins: "dict[str, np.ndarray]", cuts: tuple,
                 num_raw_events: int) -> None:
        self.source_name = source_name
        self.doc_col = doc_col
        self.rows = rows
        self.word = word
        self.bins = bins
        self.cuts = cuts
        self.num_raw_events = num_raw_events

    @property
    def num_events(self) -> int:
        return len(self.rows)

    def doc_key(self, i: int) -> str:
        return self.rows[i][self.doc_col]

    def word_counts(self) -> "list[tuple[str, str, int]]":
        """Per-document word counts in first-seen order — the same
        deterministic substitute for Spark's reduceByKey order the
        flow/dns containers pin."""
        agg: "dict[tuple[str, str], int]" = {}
        c = self.doc_col
        for i, row in enumerate(self.rows):
            k = (row[c], self.word[i])
            agg[k] = agg.get(k, 0) + 1
        return [(ip, w, n) for (ip, w), n in agg.items()]

    def event_indices(self, ip_index: dict, word_index: dict):
        """(document row, word row) per raw event, int32; misses get the
        fallback row (len of the index)."""
        n = self.num_raw_events
        c = self.doc_col
        return (index_rows(ip_index, [r[c] for r in self.rows[:n]],
                           len(ip_index)),
                index_rows(word_index, self.word[:n], len(word_index)))

    def featurized_row(self, i: int) -> "list[str]":
        """Original columns + per-field bins + the word — the pre-score
        row shape the results CSV emits."""
        return self.rows[i] + [
            str(int(self.bins[name][i])) for name in sorted(self.bins)
        ] + [self.word[i]]


class GenericEventFeaturizer:
    """Serving-side featurizer for a TableSourceSpec, pinned to the
    trained day's cuts (serving/events.py's rule: a micro-batch's own
    ECDF would unmap every word from the model vocabulary)."""

    def __init__(self, spec: "TableSourceSpec", cuts: tuple) -> None:
        self.spec = spec
        self.dsource = spec.name
        self.cuts = tuple(np.asarray(c, np.float64) for c in cuts)

    def validate(self, line: str) -> str:
        if len(line.strip().split(",")) != self.spec.num_columns:
            raise ValueError(
                f"{self.spec.name} event needs {self.spec.num_columns} "
                f"columns: {line!r}")
        return line

    def admit(self, line: str) -> "tuple[str, list[str]]":
        """Validate and keep the split row (the fleet's device
        featurizer consumes rows; the host featurizer the line)."""
        row = line.strip().split(",")
        if len(row) != self.spec.num_columns:
            raise ValueError(
                f"{self.spec.name} event needs {self.spec.num_columns} "
                f"columns: {line!r}")
        return line, row

    def __call__(self, lines: Sequence[str]) -> GenericFeatures:
        return self.spec.featurize(lines, skip_header=False,
                                   precomputed_cuts=self.cuts)


class TableSourceSpec(SourceSpec):
    """A source defined entirely by declaration: columns, fields, cut
    strategies, a word template and a document column."""

    def __init__(self, name: str, columns: Sequence[str],
                 doc_column: str, word_template: str,
                 fields: Sequence[FieldDef], cuts: Sequence[CutDef],
                 time_field: str, header_probe_col: int = 0,
                 default_fallback: float = 0.1) -> None:
        self.name = name
        self.columns = tuple(columns)
        self.num_columns = len(self.columns)
        self.doc_column = doc_column
        self.word_template = word_template
        self.fields = tuple(fields)
        self.cuts_spec = tuple(cuts)
        self.time_field = time_field
        self.header_probe_col = header_probe_col
        self.default_fallback = default_fallback
        self._col = {c: i for i, c in enumerate(self.columns)}
        if doc_column not in self._col:
            raise ValueError(
                f"source {name!r}: doc_column {doc_column!r} is not a "
                "declared column"
            )
        by_name = {f.name: f for f in self.fields}
        field_names = set(by_name)
        for cut in self.cuts_spec:
            if cut.field not in field_names:
                raise ValueError(
                    f"source {name!r}: cut on undeclared field "
                    f"{cut.field!r}"
                )
        if time_field not in field_names:
            raise ValueError(
                f"source {name!r}: time_field {time_field!r} is not a "
                "declared field"
            )
        self._time_field = by_name[time_field]

    # -- declaration round-trip -------------------------------------------

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "columns": list(self.columns),
            "doc_column": self.doc_column,
            "word_template": self.word_template,
            "fields": [
                {"name": f.name, "column": f.column, "kind": f.kind}
                for f in self.fields
            ],
            "cuts": [
                {"field": c.field, "strategy": c.strategy,
                 "positive_only": c.positive_only}
                for c in self.cuts_spec
            ],
            "time_field": self.time_field,
            "header_probe_col": self.header_probe_col,
            "default_fallback": self.default_fallback,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TableSourceSpec":
        return cls(
            name=d["name"], columns=d["columns"],
            doc_column=d["doc_column"],
            word_template=d["word_template"],
            fields=[FieldDef(**f) for f in d["fields"]],
            cuts=[CutDef(**c) for c in d["cuts"]],
            time_field=d["time_field"],
            header_probe_col=d.get("header_probe_col", 0),
            default_fallback=d.get("default_fallback", 0.1),
        )

    # -- field evaluation --------------------------------------------------

    def _eval_field(self, f: FieldDef, rows: "list[list[str]]"):
        col = self._col[f.column]
        if f.kind == "number":
            from ..features.flow import _to_double

            return np.array([_to_double(r[col]) for r in rows],
                            dtype=np.float64)
        if f.kind == "hms":
            return np.array([_hms_seconds(r[col]) for r in rows],
                            dtype=np.float64)
        if f.kind == "entropy":
            from ..features.dns import shannon_entropy

            return np.array([shannon_entropy(r[col]) for r in rows],
                            dtype=np.float64)
        return np.array([len(r[col]) for r in rows], dtype=np.float64)

    def featurize(self, events: Iterable, *, precomputed_cuts=None,
                  skip_header=False, feedback_rows=(),
                  top_domains=frozenset()) -> GenericFeatures:
        from ..features.quantiles import (DECILES, QUINTILES, bin_values,
                                          ecdf_cuts)

        rows: "list[list[str]]" = []
        first = True
        for e in events:
            row = e.strip().split(",") if isinstance(e, str) else list(e)
            if first and skip_header:
                first = False
                try:
                    float(row[self.header_probe_col])
                except (ValueError, IndexError):
                    continue
            first = False
            if len(row) == self.num_columns:
                rows.append(row)
        num_raw_events = len(rows)
        for e in feedback_rows:
            row = e.strip().split(",") if isinstance(e, str) else list(e)
            if len(row) == self.num_columns:
                rows.append(row)

        values = {f.name: self._eval_field(f, rows) for f in self.fields}
        cut_arrays: "list[np.ndarray]" = []
        bins: "dict[str, np.ndarray]" = {}
        for j, cut in enumerate(self.cuts_spec):
            v = values[cut.field]
            if precomputed_cuts is not None:
                c = np.asarray(precomputed_cuts[j], np.float64)
            else:
                probe = QUINTILES if cut.strategy == "quintile" else DECILES
                src = v[v > 0] if cut.positive_only else v
                c = ecdf_cuts(src[~np.isnan(src)], probe)
            cut_arrays.append(c)
            bins[cut.field] = bin_values(v, c)

        tmpl = self.word_template
        words: "list[str]" = []
        for i, row in enumerate(rows):
            parts: "dict[str, object]" = {
                c: row[k] for c, k in self._col.items()
            }
            for name, v in values.items():
                parts[name] = int(bins[name][i]) if name in bins \
                    else _word_number(v[i])
            words.append(tmpl.format(**parts))
        return GenericFeatures(
            self.name, self._col[self.doc_column], rows, words, bins,
            tuple(cut_arrays), num_raw_events,
        )

    def matches_features(self, features) -> bool:
        return getattr(features, "source_name", None) == self.name

    def cuts_of(self, features) -> tuple:
        return features.cuts

    def event_featurizer(self, cuts, top_domains=frozenset()):
        return GenericEventFeaturizer(self, cuts)

    def event_time_s(self, line: str) -> float:
        row = line.split(",")
        f = self._time_field
        col = self._col[f.column]
        if f.kind == "hms":
            return _hms_seconds_strict(row[col])
        return float(row[col])

    def event_pairs(self, feats):
        n = feats.num_raw_events
        c = feats.doc_col
        return [([r[c] for r in feats.rows[:n]], list(feats.word[:n]))]

    def score_csv(self, features, model, threshold, engine=None,
                  chunk=None, stats=None, device=None, prep=None,
                  mesh=None):
        """(results CSV bytes, ascending kept scores): one <theta_doc,
        p_word> per raw event, each kept row the source columns, the
        field bins, the word and the score; engine="device" runs the
        pipeline's filtered_scores (scoring.score.scored_events); `prep`
        is the dataplane's ScoringPrep (scoring.score.prep_indices)."""
        from ..scoring.score import prep_indices, scored_events

        ip_idx, word_idx = prep_indices(prep, features, model, self.name)
        order, (scores,), kept = scored_events(
            model, [(ip_idx, word_idx)], threshold, engine, chunk, stats,
            device, mesh)
        blob = csv_blob(
            ",".join(features.featurized_row(i) + [str(scores[i])])
            for i in order)
        return blob, kept

    def fallback(self, scoring_cfg) -> float:
        return getattr(scoring_cfg, f"{self.name}_fallback",
                       self.default_fallback)


def _hms_seconds(v: str) -> float:
    """'HH:MM:SS' -> seconds of day; NaN on garbage (the number-field
    rule: one malformed cell must not abort the day)."""
    try:
        return _hms_seconds_strict(v)
    except (ValueError, IndexError):
        return float("nan")


def _hms_seconds_strict(v: str) -> float:
    h, m, s = v.split(":")
    return float(h) * 3600.0 + float(m) * 60.0 + float(s)


def _word_number(v: float) -> str:
    """Unbinned numeric fields render compactly (ints stay ints) so
    templates can embed raw values without JVM-double noise."""
    return str(int(v)) if float(v).is_integer() else str(v)


# ---------------------------------------------------------------------------
# The proxy/HTTP source
# ---------------------------------------------------------------------------

PROXY_COLUMNS = (
    "p_date", "p_time", "clientip", "host", "reqmethod", "respcode",
    "duration", "scbytes", "csbytes", "useragent",
)


class ProxySource(TableSourceSpec):
    """Web-proxy / HTTP access logs as a declarative source.

    The word bins the request shape a C2 channel distorts: method and
    status raw, then decile duration, quintile response bytes, quintile
    host-name entropy (DGA/tunnel hosts score high).  Time-of-day stays
    a declared field — it orders continuous-mode slices — but is left
    OUT of the word: a polling implant's cadence is already visible in
    duration/bytes regularity, and a time bin would multiply the benign
    vocabulary tenfold for no signal.  The querying client is the
    document, like DNS."""

    def __init__(self) -> None:
        super().__init__(
            name="proxy",
            columns=PROXY_COLUMNS,
            doc_column="clientip",
            word_template=("{reqmethod}_{respcode}_{duration}"
                           "_{scbytes}_{host_entropy}"),
            fields=[
                FieldDef("time", "p_time", "hms"),
                FieldDef("duration", "duration", "number"),
                FieldDef("scbytes", "scbytes", "number"),
                FieldDef("host_entropy", "host", "entropy"),
            ],
            cuts=[
                CutDef("duration", "decile"),
                CutDef("scbytes", "quintile"),
                CutDef("host_entropy", "quintile"),
            ],
            time_field="time",
            header_probe_col=PROXY_COLUMNS.index("duration"),
            default_fallback=0.1,
        )

    def synth_benign(self, n_events: int, seed: int) -> "list[str]":
        """Office-hours browsing: a small host mix, mostly GET/200,
        human-shaped durations and response sizes."""
        rng = np.random.default_rng(seed)
        hosts = (
            "www.example.com", "cdn.example.net", "mail.corp.example",
            "docs.corp.example", "news.site.example", "api.partner.example",
        )
        methods = ("GET", "GET", "GET", "POST")
        codes = ("200", "200", "200", "304")
        dur_modes = (10, 50, 200)
        bytes_modes = (500, 20000, 200000)
        lines = []
        for _ in range(n_events):
            h = int(rng.integers(8, 18))
            m = int(rng.integers(0, 60))
            s = int(rng.integers(0, 60))
            mode = int(rng.integers(0, 3))
            lines.append(
                "2016-01-22,"
                f"{h:02d}:{m:02d}:{s:02d},"
                f"10.2.0.{int(rng.integers(0, 24))},"
                f"{hosts[int(rng.integers(0, len(hosts)))]},"
                f"{methods[int(rng.integers(0, len(methods)))]},"
                f"{codes[int(rng.integers(0, len(codes)))]},"
                f"{dur_modes[mode]},{bytes_modes[mode]},"
                f"{int(rng.integers(100, 2000))},"
                "Mozilla/5.0"
            )
        lines.sort(key=lambda line: _hms_seconds(line.split(",")[1]))
        return lines
