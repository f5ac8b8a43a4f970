"""Detection-quality scoring over labeled injected days (port of
oni_ml_tpu/sources/quality.py).

The metric set the injection suite (sources/inject.py) feeds:

  * ``precision_at_k``: attacks among the k most suspicious events / k
  * ``recall_at_k``: attacks among the k most suspicious events / all
    attacks (k defaults to the attack count, so a perfect detector
    scores 1.0)
  * ``score_separation``: median log-score gap between benign and attack
    events, in nats (scores span hundreds of orders of magnitude, so
    raw-probability gaps mean nothing)

All three are higher-better.  "Most suspicious" means lowest score, the
pipeline's rule everywhere (threshold filter, ascending sort, flow's
min-combine).

`QualitySuite` is the pinned evaluation harness: one injected day,
featurized once with a fixed cut set (a candidate model must be judged
on the word space it will serve), scored per candidate model through
the serving path's `score_features` (the host float64 dot).
"""

from __future__ import annotations

import numpy as np

from . import inject, registry

_LOG_FLOOR = 1e-300


def detection_metrics(scores: np.ndarray, attack_mask: np.ndarray,
                      k: int = 0) -> dict:
    """Rank metrics for one scored day.  `k` <= 0 means k = #attacks."""
    scores = np.asarray(scores, np.float64)
    attack_mask = np.asarray(attack_mask, bool)
    n_attacks = int(attack_mask.sum())
    if k <= 0:
        k = n_attacks
    k = min(k, len(scores))
    order = np.argsort(scores, kind="stable")
    hits = int(attack_mask[order[:k]].sum()) if k else 0
    benign = scores[~attack_mask]
    attack = scores[attack_mask]
    if len(benign) and len(attack):
        sep = float(
            np.median(np.log(np.maximum(benign, _LOG_FLOOR)))
            - np.median(np.log(np.maximum(attack, _LOG_FLOOR)))
        )
    else:
        sep = 0.0
    return {
        "k": k,
        "attacks": n_attacks,
        "precision_at_k": round(hits / k, 6) if k else 0.0,
        "recall_at_k": round(hits / n_attacks, 6) if n_attacks else 0.0,
        "score_separation": round(sep, 6),
    }


def scenario_metrics(scores: np.ndarray, labels: "list[dict | None]",
                     k: int = 0) -> "dict[str, dict]":
    """Per-scenario recall breakdown: each scenario's events judged
    against the same global bottom-k (an analyst triages one ranked
    list, not one per scenario)."""
    scores = np.asarray(scores, np.float64)
    names = sorted({lb["scenario"] for lb in labels if lb is not None})
    total_attacks = sum(lb is not None for lb in labels)
    if k <= 0:
        k = total_attacks
    k = min(k, len(scores))
    order = np.argsort(scores, kind="stable")
    in_topk = np.zeros(len(scores), bool)
    in_topk[order[:k]] = True
    out: "dict[str, dict]" = {}
    for name in names:
        mask = np.array(
            [lb is not None and lb["scenario"] == name for lb in labels],
            bool,
        )
        n = int(mask.sum())
        hits = int((mask & in_topk).sum())
        out[name] = {
            "events": n,
            "hits_at_k": hits,
            "recall_at_k": round(hits / n, 6) if n else 0.0,
        }
    return out


class QualitySuite:
    """A pinned injected day + featurization, evaluated per candidate
    model.  Built once (cuts pinned at construction), evaluated many
    times: the publish gate's judge (models/drift.QualityGate)."""

    def __init__(self, source: str, cuts: tuple, *, n_events: int = 600,
                 seed: int = 7, attack_events: int = 24, k: int = 0,
                 scenarios: "tuple[str, ...] | None" = None,
                 top_domains: frozenset = frozenset()) -> None:
        self.source = source
        self.k = k
        spec = registry.get(source)
        self.day = inject.inject_scenarios(
            source, n_events=n_events, seed=seed, scenarios=scenarios,
            attack_events=attack_events,
        )
        self.feats = spec.featurize(
            self.day.lines, skip_header=False, precomputed_cuts=cuts,
            top_domains=top_domains,
        )
        if self.feats.num_raw_events != len(self.day.lines):
            raise ValueError(
                f"injection suite for {source!r}: "
                f"{len(self.day.lines)} lines featurized to "
                f"{self.feats.num_raw_events} events: labels would "
                "misalign"
            )

    @property
    def manifest(self) -> dict:
        return self.day.manifest

    def evaluate(self, model) -> dict:
        """Score the suite under `model` (the serving score path) and
        report the metric set + per-scenario breakdown."""
        from ..serving.events import score_features

        scores = score_features(model, self.feats, self.source)
        out = detection_metrics(scores, self.day.attack_mask, self.k)
        out["per_scenario"] = scenario_metrics(
            scores, self.day.labels, self.k
        )
        return out
