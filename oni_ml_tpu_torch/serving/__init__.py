"""Streaming scoring service on one card (port of oni_ml_tpu/serving,
the single-model part): a day job's artifacts served as a long-running,
continuously refreshed scorer.

    day artifacts (doc_results.csv / word_results.csv / features.pkl)
        -> ModelRegistry      validated snapshots, atomic hot-swap
        -> BatchScorer        micro-batch queue (max_batch / max_wait_ms),
                              featurize with the day's cuts, host-or-device
                              scoring by the measured break-even,
                              JSON-line metrics
        -> RefreshLoop        scored batches fold into online-LDA steps
                              on the card; the refreshed theta/p
                              republish through the registry

`python -m oni_ml_tpu_torch.runner.ml_ops serve` is the CLI
(runner/serve.py); config.ServingConfig holds the knobs.  The JAX
package's multi-tenant fleet, tiered residency, replicas, router, wire
and autoscaler wait for their slice.
"""

from .batcher import BatchScorer, ScoreFuture
from .events import (
    DnsEventFeaturizer,
    FlowEventFeaturizer,
    event_documents,
    featurizer_from_features,
    score_features,
)
from .metrics import MetricsEmitter
from .refresh import RefreshLoop, topic_probs_from_log_beta
from .registry import ModelRegistry, ModelSnapshot, validate_model

__all__ = [
    "BatchScorer",
    "DnsEventFeaturizer",
    "FlowEventFeaturizer",
    "MetricsEmitter",
    "ModelRegistry",
    "ModelSnapshot",
    "RefreshLoop",
    "ScoreFuture",
    "event_documents",
    "featurizer_from_features",
    "score_features",
    "topic_probs_from_log_beta",
    "validate_model",
]
