"""Event ingress of the serving path (port of oni_ml_tpu/serving/events.py):
raw CSV events -> featurized micro-batches -> (ip, word) model lookups,
through the same Python featurizers the day's pre stage is pinned to
(features/flow.py, features/dns.py).

The one thing serving must pin that the day job derives per day is the
quantile cuts: a micro-batch's own ECDF would bin values differently
from the trained day and unmap every word from the model's vocabulary.
So a serving featurizer always carries precomputed cuts, the trained
day's from its features.pkl (every container, native or Python, records
them: `SourceSpec.cuts_of`).

Events are validated at submit time (column count), so a featurized
micro-batch has exactly one row per submitted event; BatchScorer's
exactly-once accounting depends on that alignment.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..features.dns import NUM_DNS_COLUMNS, featurize_dns
from ..features.flow import NUM_FLOW_COLUMNS, featurize_flow
from ..scoring import ScoringModel, batched_scores


class FlowEventFeaturizer:
    """Raw 27-column netflow CSV lines -> FlowFeatures, with the trained
    day's (time, ibyt, ipkt) cuts."""

    dsource = "flow"

    def __init__(self, cuts: tuple) -> None:
        self.cuts = tuple(np.asarray(c, np.float64) for c in cuts)

    def validate(self, line: str) -> str:
        if len(line.strip().split(",")) != NUM_FLOW_COLUMNS:
            raise ValueError(
                f"flow event needs {NUM_FLOW_COLUMNS} columns: {line!r}")
        return line

    def admit(self, line: str) -> "tuple[str, list[str]]":
        """Validate and keep the split row, so a fleet flush never splits
        the line again (the device featurizer consumes rows; the host
        featurizer still takes the line)."""
        row = line.strip().split(",")
        if len(row) != NUM_FLOW_COLUMNS:
            raise ValueError(
                f"flow event needs {NUM_FLOW_COLUMNS} columns: {line!r}")
        return line, row

    def __call__(self, lines: Sequence[str]):
        return featurize_flow(lines, skip_header=False,
                              precomputed_cuts=self.cuts)


class DnsEventFeaturizer:
    """Raw 8-column DNS CSV lines (or pre-split rows) -> DnsFeatures,
    with the trained day's five cut vectors."""

    dsource = "dns"

    def __init__(self, cuts: tuple,
                 top_domains: frozenset = frozenset()) -> None:
        self.cuts = tuple(np.asarray(c, np.float64) for c in cuts)
        self.top_domains = top_domains

    def validate(self, event) -> "list[str]":
        row = (event.strip().split(",") if isinstance(event, str)
               else list(event))
        if len(row) != NUM_DNS_COLUMNS:
            raise ValueError(
                f"dns event needs {NUM_DNS_COLUMNS} columns: {event!r}")
        return row

    def admit(self, event) -> "tuple[list[str], list[str]]":
        """Validate to the split row, which is also the featurizer's
        payload: (row, row)."""
        row = self.validate(event)
        return row, row

    def __call__(self, rows: Sequence[Sequence[str]]):
        return featurize_dns(rows, top_domains=self.top_domains,
                             precomputed_cuts=self.cuts)


def featurizer_from_features(features, top_domains: frozenset = frozenset()):
    """The serving featurizer of a trained day's feature container
    (features.pkl, native or Python): the source registry maps the
    container to its spec, which reads the cuts off it."""
    from ..sources import spec_for_features

    spec = spec_for_features(features)
    return spec.event_featurizer(spec.cuts_of(features),
                                 top_domains=top_domains)


def score_features(model: ScoringModel, feats, dsource: str,
                   device_min=None, device=None) -> np.ndarray:
    """Per-event scores of one featurized micro-batch, float64: the min
    over the source's (document, word) lookup blocks (`event_pairs`:
    min(src, dest) for flow, the client's one dot for DNS and table
    sources), each block through the host-or-device scorer
    (scoring.batched_scores on `device`)."""
    from ..sources import get as get_source

    out = None
    for keys, words in get_source(dsource).event_pairs(feats):
        scores = batched_scores(model, model.ip_rows(keys),
                                model.word_rows(words), device_min, device)
        out = scores if out is None else np.minimum(out, scores)
    return out


def event_documents(feats, dsource: str) -> "tuple[list[str], list[str]]":
    """(ips, words) training pairs a micro-batch gives the online
    refresh: the corpus stage's document mapping (flow: both endpoints,
    DNS and table sources: the client)."""
    from ..sources import get as get_source

    return get_source(dsource).event_documents(feats)
