"""Scoring-stage preparation that overlaps EM training (port of
oni_ml_tpu/dataplane/scoreprep.py).

The scoring stage's host-side prolog — building the model-row indices
(`{ip: row}` / `{word: row}`) and resolving every raw event's
(ip, word) pair against them — depends only on the *corpus* (the
doc-name and vocab orderings that doc_results.csv / word_results.csv
will carry) and the featurized day, both of which exist the moment the
corpus stage finishes.  Nothing in it needs the trained model, so the
dataplane runs it on a background task while EM runs on the card:
when the model converges, scoring starts against the prepped index
arrays.  The task works on host arrays only (no tensor, no CUDA
stream).

Byte-identity: the index resolution is the container's own
`event_indices` (features/container.py), the call the scoring stage
makes inline, against the same orderings the results CSVs carry —
pinned by tests/test_torch_dataplane.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ScoringPrep:
    """Prepped per-event model-row indices for one day + dsource.

    `num_docs` / `num_words` record the index spaces the arrays were
    resolved against so a consumer can verify the eventual model
    matches (a mismatch means a bug — prep built against a different
    corpus than the model was trained on — and must fail loudly, not
    silently rescore)."""

    dsource: str
    num_docs: int
    num_words: int
    num_raw_events: int
    indices: tuple

    def check_model(self, model) -> None:
        if (self.num_docs != len(model.ip_index)
                or self.num_words != len(model.word_index)):
            raise ValueError(
                f"scoring prep was built against {self.num_docs} docs / "
                f"{self.num_words} words but the model carries "
                f"{len(model.ip_index)} / {len(model.word_index)} — "
                "prep and model came from different corpora"
            )


def build_scoring_prep(features, doc_names, vocab,
                       dsource: str) -> ScoringPrep:
    """Resolve every raw event's model rows against the corpus
    orderings (doc_names / vocab — exactly the row orders the results
    CSVs carry), through the container's `event_indices`."""
    ip_index = {ip: i for i, ip in enumerate(doc_names)}
    word_index = {w: i for i, w in enumerate(vocab)}
    idx = features.event_indices(ip_index, word_index)
    return ScoringPrep(
        dsource=dsource,
        num_docs=len(ip_index),
        num_words=len(word_index),
        num_raw_events=int(features.num_raw_events),
        indices=tuple(np.asarray(a) for a in idx),
    )
