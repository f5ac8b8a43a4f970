"""Streaming scoring service on one card (port of oni_ml_tpu/serving,
the single-model service and the fleet): a day job's artifacts served
as a long-running, continuously refreshed scorer.

    day artifacts (doc_results.csv / word_results.csv / features.pkl)
        -> ModelRegistry      validated snapshots, atomic hot-swap
        -> BatchScorer        micro-batch queue (max_batch / max_wait_ms),
                              featurize with the day's cuts, host-or-device
                              scoring by the measured break-even,
                              JSON-line metrics
        -> RefreshLoop        scored batches fold into online-LDA steps
                              on the card; the refreshed theta/p
                              republish through the registry

The multi-tenant fleet scales it to N tenants on one card:

        -> FleetRegistry      per-tenant registries + one stacked
                              snapshot per topic count K
        -> FleetScorer        cross-tenant micro-batches, bounded
                              per-tenant admission, demux to per-tenant
                              futures, serve.<tenant>.* metrics, the
                              featurize plane (sources/device.py)
        -> ResidencyManager   hot (stacked on the card) / warm (host) /
                              cold (checkpoint) paging, LRU or LFU

`python -m oni_ml_tpu_torch.runner.ml_ops serve [--fleet MANIFEST]` is
the CLI (runner/serve.py); config.ServingConfig holds the knobs.  The
continuous service (runner/continuous.py) scores through a FleetScorer
and arbitrates its refresh fits against scoring with the CoScheduler.
The JAX package's replicas, router, wire and autoscaler wait for their
slice.
"""

from .batcher import BatchScorer, ScoreFuture
from .coscheduler import CoScheduler
from .events import (
    DnsEventFeaturizer,
    FlowEventFeaturizer,
    event_documents,
    featurizer_from_features,
    score_features,
)
from .fleet import (
    FleetRegistry,
    FleetScorer,
    StackedSnapshot,
    demux_scores,
    tenant_pairs,
)
from .metrics import MetricsEmitter
from .refresh import RefreshLoop, topic_probs_from_log_beta
from .registry import ModelRegistry, ModelSnapshot, validate_model
from .residency import (
    TIER_COLD,
    TIER_HOT,
    TIER_WARM,
    ResidencyManager,
    load_spill,
    resolve_hot_capacity,
    spill_model,
)
from .tenants import (
    AdmissionRejected,
    TenantLane,
    TenantSpec,
    load_manifest,
    parse_manifest,
)

__all__ = [
    "TIER_COLD",
    "TIER_HOT",
    "TIER_WARM",
    "AdmissionRejected",
    "BatchScorer",
    "CoScheduler",
    "DnsEventFeaturizer",
    "FleetRegistry",
    "FleetScorer",
    "FlowEventFeaturizer",
    "MetricsEmitter",
    "ModelRegistry",
    "ModelSnapshot",
    "RefreshLoop",
    "ResidencyManager",
    "ScoreFuture",
    "StackedSnapshot",
    "TenantLane",
    "TenantSpec",
    "demux_scores",
    "event_documents",
    "featurizer_from_features",
    "load_manifest",
    "load_spill",
    "parse_manifest",
    "resolve_hot_capacity",
    "score_features",
    "spill_model",
    "tenant_pairs",
    "topic_probs_from_log_beta",
    "validate_model",
]
