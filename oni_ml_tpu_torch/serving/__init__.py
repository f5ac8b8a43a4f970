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

The replicated fleet runs N such stacks as replica processes behind a
router (runner/route.py, `ml_ops replica` / `ml_ops route`):

        -> ReplicaServer      a dynamic FleetScorer behind the framed
                              socket protocol, with KV heartbeats
                              (parallel/membership.py)
        -> FleetRouter        consistent-hash placement (primary +
                              warm shadow per tenant), scatter/gather,
                              shadow-promotion failover, rolling drain
        -> wire               the columnar frame codec (no pickle) and
                              the same-host shared-memory rings
        -> AutoScaler         joins and drains replicas to hold the
                              admission windows' occupancy in a band

`python -m oni_ml_tpu_torch.runner.ml_ops serve [--fleet MANIFEST]` is
the CLI (runner/serve.py); config.ServingConfig holds the knobs.  The
continuous service (runner/continuous.py) scores through a FleetScorer,
or through the router with `replicated`, and arbitrates its refresh
fits against scoring with the CoScheduler.
"""

from .autoscale import AutoScaler
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
from .placement import (
    Placement,
    load_by_replica,
    moved_primaries,
    place,
    shadow_for,
)
from .refresh import RefreshLoop, topic_probs_from_log_beta
from .registry import ModelRegistry, ModelSnapshot, validate_model
from .replica import ReplicaServer, featurizer_for
from .residency import (
    TIER_COLD,
    TIER_HOT,
    TIER_WARM,
    ResidencyManager,
    load_spill,
    resolve_hot_capacity,
    spill_model,
)
from .router import FleetRouter, ReplicaLink
from .tenants import (
    AdmissionRejected,
    TenantLane,
    TenantSpec,
    load_manifest,
    parse_manifest,
)
from .wire import ShmRing, decode_payload, encode_payload

__all__ = [
    "AdmissionRejected",
    "AutoScaler",
    "BatchScorer",
    "CoScheduler",
    "DnsEventFeaturizer",
    "FleetRegistry",
    "FleetRouter",
    "FleetScorer",
    "FlowEventFeaturizer",
    "MetricsEmitter",
    "ModelRegistry",
    "ModelSnapshot",
    "Placement",
    "RefreshLoop",
    "ReplicaLink",
    "ReplicaServer",
    "ResidencyManager",
    "ScoreFuture",
    "ShmRing",
    "StackedSnapshot",
    "TIER_COLD",
    "TIER_HOT",
    "TIER_WARM",
    "TenantLane",
    "TenantSpec",
    "decode_payload",
    "demux_scores",
    "encode_payload",
    "event_documents",
    "featurizer_for",
    "featurizer_from_features",
    "load_by_replica",
    "load_manifest",
    "load_spill",
    "moved_primaries",
    "parse_manifest",
    "place",
    "resolve_hot_capacity",
    "score_features",
    "shadow_for",
    "spill_model",
    "tenant_pairs",
    "topic_probs_from_log_beta",
    "validate_model",
]
