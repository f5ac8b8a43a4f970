"""Tenant identity, admission and demux types of the serving fleet
(port of oni_ml_tpu/serving/tenants.py).

A tenant is one independently owned scoring stream: its own trained day
(model and quantile cuts), admission queue, metrics namespace
(``serve.<tenant>.*``) and hot-swap cadence.  What tenants share is the
card: the stacked model weights and the dispatches they ride.  So the
types here carry no model state: `FleetRegistry` (serving/fleet.py)
owns the models; this module owns identity, admission and the per-event
bookkeeping that demuxes a packed cross-tenant micro-batch back into
per-tenant futures.

Admission isolates tenants on the way in: each tenant gets a bounded
queue, so one tenant's runaway producer fills its own queue (blocking
or rejecting, per policy) instead of every tenant's latency budget.
Stalls are priced like the dataplane's channel stalls (a ``{"kind":
"dataplane"}`` journal record and the ``serve.<tenant>.
admission_stall_s`` histogram); rejects are ``{"kind":
"admission_reject"}`` records and ``serve.<tenant>.admission_rejects``
counters.
"""

from __future__ import annotations

import json
import re
from collections import deque
from dataclasses import dataclass, field

from .batcher import ScoreFuture

# Tenant ids become metric-name components (`serve.<tenant>.latency_ms`
# -> OpenMetrics `serve_<tenant>_latency_ms`): restrict to characters
# the exporter's non-alphanumeric -> `_` rewrite maps INJECTIVELY, so
# two tenants can never collide onto one exposition series.  `-` is
# deliberately excluded: it rewrites to `_`, so "acme-eu" and "acme_eu"
# would silently merge their histograms.
_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_]*$")

ADMISSION_POLICIES = ("block", "reject")


class AdmissionRejected(RuntimeError):
    """submit() on a full tenant queue under admission="reject": the
    event was NOT enqueued (no future exists for it) — the caller sheds
    load instead of waiting.  Carries the tenant and the queue bound so
    an ingest shim can surface a per-tenant 429."""

    def __init__(self, tenant: str, depth: int, capacity: int) -> None:
        super().__init__(
            f"tenant {tenant!r} admission queue full "
            f"({depth}/{capacity} pending)"
        )
        self.tenant = tenant
        self.depth = depth
        self.capacity = capacity


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's declaration — the fleet-manifest unit.

    `day_dir` names the completed day directory the tenant's model and
    featurizer load from ("" for programmatic tenants published through
    `FleetRegistry.publish` directly).  `queue_max` / `admission` /
    `threshold` of 0/""/None inherit the fleet-wide ServingConfig
    values, so a manifest only states what differs per tenant.
    `weight` is the tenant's declared load share — the load generator's
    mixing weight and an operator hint, not a scheduler input (the
    scorer drains globally oldest-first, which is what keeps one
    tenant's burst from inverting another's latency)."""

    tenant: str
    day_dir: str = ""
    dsource: str = "flow"
    queue_max: int = 0
    admission: str = ""
    threshold: "float | None" = None
    weight: float = 1.0
    refresh_every: int = 0

    def __post_init__(self) -> None:
        if not _TENANT_ID_RE.match(self.tenant):
            raise ValueError(
                f"tenant id {self.tenant!r} must match "
                f"{_TENANT_ID_RE.pattern} — ids become OpenMetrics "
                "name components"
            )
        from ..sources import names as source_names

        if self.dsource not in source_names():
            raise ValueError(
                f"tenant {self.tenant!r}: dsource must be one of "
                f"{'|'.join(source_names())}, got {self.dsource!r}"
            )
        if self.admission and self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"tenant {self.tenant!r}: admission must be one of "
                f"{ADMISSION_POLICIES}, got {self.admission!r}"
            )
        if self.queue_max < 0:
            raise ValueError(
                f"tenant {self.tenant!r}: queue_max must be >= 0 "
                "(0 = fleet default)"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.tenant!r}: weight must be > 0"
            )


def load_manifest(path: str) -> list[TenantSpec]:
    """Parse a fleet manifest file: ``{"tenants": [{"tenant": "a",
    "day_dir": "...", "dsource": "flow", ...}, ...]}``.  Unknown keys
    fail loudly (a typo'd knob must not silently become the default),
    and duplicate tenant ids fail (two queues demuxing onto one metric
    namespace would corrupt both)."""
    with open(path) as f:
        data = json.load(f)
    return parse_manifest(data, origin=path)


def parse_manifest(data, origin: str = "<manifest>") -> list[TenantSpec]:
    if not isinstance(data, dict) or not isinstance(
            data.get("tenants"), list):
        raise ValueError(
            f"{origin}: manifest must be an object with a 'tenants' list"
        )
    allowed = set(TenantSpec.__dataclass_fields__)
    specs: list[TenantSpec] = []
    seen: set[str] = set()
    for i, entry in enumerate(data["tenants"]):
        if not isinstance(entry, dict):
            raise ValueError(f"{origin}: tenants[{i}] is not an object")
        unknown = set(entry) - allowed
        if unknown:
            raise ValueError(
                f"{origin}: tenants[{i}] has unknown keys "
                f"{sorted(unknown)} (allowed: {sorted(allowed)})"
            )
        spec = TenantSpec(**entry)
        if spec.tenant in seen:
            raise ValueError(
                f"{origin}: duplicate tenant id {spec.tenant!r}"
            )
        seen.add(spec.tenant)
        specs.append(spec)
    if not specs:
        raise ValueError(f"{origin}: manifest declares zero tenants")
    return specs


class _PendingEvent:
    """One admitted event awaiting its packed flush: the demux unit.
    `future` resolves with (score, tenant model version) exactly once.
    `row` is the edge columnar parse — the split column list produced
    at admission by featurizers exposing `admit()` — so the flush path
    never re-splits the raw line (None for validate-only featurizers,
    which shed the device path and featurize from `raw`)."""

    __slots__ = ("raw", "t_enqueue", "future", "row")

    def __init__(self, raw, t_enqueue: float, row=None) -> None:
        self.raw = raw
        self.t_enqueue = t_enqueue
        self.future = ScoreFuture()
        self.row = row


@dataclass
class TenantLane:
    """Per-tenant admission queue + counters.

    NOT self-locking: every method and every field access runs under
    the owning FleetScorer's condition variable (caller holds the
    scorer's _cond) — one lock orders admissions, flush takes, and
    counter reads across all lanes, which is what makes the global
    oldest-first drain and the per-tenant backpressure bounds
    mutually consistent."""

    spec: TenantSpec
    featurizer: object
    queue_max: int
    admission: str
    threshold: float
    pending: deque = field(default_factory=deque)
    submitted: int = 0
    scored: int = 0
    rejected: int = 0
    flagged: int = 0
    admission_stall_ns: int = 0

    def full_locked(self) -> bool:
        return len(self.pending) >= self.queue_max

    def stats_locked(self) -> dict:
        return {
            "tenant": self.spec.tenant,
            "dsource": self.spec.dsource,
            "queue_max": self.queue_max,
            "admission": self.admission,
            "pending": len(self.pending),
            "submitted": self.submitted,
            "scored": self.scored,
            "rejected": self.rejected,
            "flagged": self.flagged,
            "admission_stall_s": round(self.admission_stall_ns / 1e9, 6),
        }
