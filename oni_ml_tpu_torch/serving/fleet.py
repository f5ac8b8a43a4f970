"""The multi-tenant serving fleet on one card: shared residency of the
stacked models, cross-tenant micro-batches, per-tenant isolation (port
of oni_ml_tpu/serving/fleet.py).

`FleetRegistry`
    One serving/registry.py `ModelRegistry` per tenant (validation,
    double-buffered publish, monotonic versions), plus a *stacked
    snapshot* per topic count K: every member tenant's [D_t+1, K] theta
    and [V_t+1, K] p concatenated row-wise at per-tenant base offsets.
    The stack is double-buffered too: a publish rebuilds it outside the
    registry lock and swaps one reference, so one tenant's refresh never
    stalls another's scoring, and since a tenant's row counts survive
    its hot-swaps, so does the stacked shape.

`FleetScorer`
    Cross-tenant micro-batches: events drain from every tenant's
    admission queue globally oldest-first into one batch; each tenant's
    segment featurizes with its own day's cuts (on the host, or through
    the compiled tables of sources/device.py), maps onto its own slice
    of the stack as `tenant base offset + local row`, and every segment
    of a K-group scores in ONE `batched_scores` call (host float64 or
    the card, by the measured dispatch rule).  Tenants of another K form
    their own group, so a mixed fleet takes more dispatches, never
    wrong scores.  Results demux back to per-tenant `ScoreFuture`s
    (journaled as `{"kind": "demux"}`), with `serve.<tenant>.*` metrics
    and bounded per-tenant admission (serving/tenants.py).  A tenant
    that misses the stack (paged out by serving/residency.py) scores
    alone on its own model; a single-tenant K-group under the "fused"
    engine takes one fused call on the card (ops/featurize_kernel.py).
    A failure (a featurizer, a dispatch, a fused call) fails that
    tenant's futures only, is emitted as an error record and counted
    (`counts["failures"]`).

Invariant, pinned by tests/test_torch_fleet.py: a packed cross-tenant
flush gives each tenant the scores of its events scored alone through
`score_features` bit for bit: packing changes which dispatch a row
rides, never its arithmetic.
"""

from __future__ import annotations

import contextlib
import heapq
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..config import ServingConfig
from ..scoring import ScoringModel
from ..scoring.score import batched_scores, use_device_path
from ..sources.device import (DeviceBatch, device_batch, resolve_break_even,
                              resolve_engine)
from .metrics import MetricsEmitter
from .registry import ModelRegistry, ModelSnapshot
from .tenants import AdmissionRejected, TenantLane, TenantSpec, _PendingEvent

STACK_PRECISIONS = ("f32", "bf16")


@dataclass(frozen=True)
class StackedSnapshot:
    """One K-group's shared view: every member tenant's theta/p
    concatenated row-wise (each slice with its own fallback row, so a
    tenant's misses still land on its own fallback).  Readers treat it
    as immutable; a publish installs a new instance (so the device copy
    `scoring.score._device_model` caches on its model uploads the new
    weights once, while a flush in flight finishes on the instance it
    took)."""

    k: int
    tenants: "tuple[str, ...]"
    model: ScoringModel            # [sum(D_t+1), K] / [sum(V_t+1), K]
    members: dict                  # tenant -> ModelSnapshot stacked
    ip_base: dict                  # tenant -> row offset into theta
    word_base: dict                # tenant -> row offset into p
    stack_version: int             # per K-group build counter
    capacity: int = 0              # tenant-slot capacity tier (0 = exact)
    precision: str = "f32"         # device storage dtype of the model

    def version_of(self, tenant: str) -> int:
        return self.members[tenant].version


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _build_stack(k: int, tenants: "list[str]", snaps: dict,
                 stack_version: int, *, tier: "dict | None" = None,
                 precision: str = "f32") -> StackedSnapshot:
    """Concatenate the member models into one stacked ScoringModel; a
    pure function of the member snapshots, run outside any lock.

    `tier` (tiered residency) pads the matrices with zero rows to
    ``capacity * slot_rows``: `capacity` is the power-of-two tenant-slot
    count and the slot row budgets cover the largest tenant the K-group
    has seen, so the stacked shape follows the capacity tier alone, not
    which tenants are resident.  The pad rows are never indexed (base
    offsets cover real members only), so padding changes no score.

    `precision="bf16"` marks the stacked model for bfloat16 storage on
    the card (scoring.score._device_model reads the marker): half the
    device bytes, float32 accumulation in the gather-dot.  The host
    matrices stay float64."""
    thetas, ps = [], []
    ip_base: dict = {}
    word_base: dict = {}
    ip_off = word_off = 0
    for t in tenants:
        m = snaps[t].model
        ip_base[t] = ip_off
        word_base[t] = word_off
        thetas.append(np.asarray(m.theta, np.float64))
        ps.append(np.asarray(m.p, np.float64))
        ip_off += m.theta.shape[0]
        word_off += m.p.shape[0]
    capacity = 0
    if tier is not None:
        capacity = int(tier["capacity"])
        pad_ip = capacity * int(tier["ip_slot"]) - ip_off
        pad_word = capacity * int(tier["word_slot"]) - word_off
        if pad_ip < 0 or pad_word < 0:
            raise RuntimeError(
                f"capacity tier {tier} cannot hold {len(tenants)} "
                f"members ({ip_off}/{word_off} rows)")
        if pad_ip:
            thetas.append(np.zeros((pad_ip, k)))
        if pad_word:
            ps.append(np.zeros((pad_word, k)))
    stacked = ScoringModel(ip_index={}, theta=np.concatenate(thetas),
                           word_index={}, p=np.concatenate(ps))
    if precision == "bf16":
        stacked._device_dtype = "bfloat16"
    return StackedSnapshot(
        k=k, tenants=tuple(tenants), model=stacked, members=dict(snaps),
        ip_base=ip_base, word_base=word_base, stack_version=stack_version,
        capacity=capacity, precision=precision)


class _TenantRegistryView:
    """A ModelRegistry facade over one tenant of a FleetRegistry: what a
    per-tenant RefreshLoop binds to, so its publishes go through the
    fleet's stack rebuild."""

    def __init__(self, fleet: "FleetRegistry", tenant: str) -> None:
        self._fleet = fleet
        self._tenant = tenant

    def publish(self, model: ScoringModel, source: str) -> ModelSnapshot:
        return self._fleet.publish(self._tenant, model, source)

    def active(self) -> ModelSnapshot:
        return self._fleet.active(self._tenant)

    def previous(self) -> "ModelSnapshot | None":
        return self._fleet.previous(self._tenant)

    @property
    def version(self) -> int:
        return self._fleet.version(self._tenant)


class FleetRegistry:
    """Per-tenant ModelRegistries and per-K stacked snapshots with
    double-buffered installs.  With a `journal`, every publish writes a
    `{"kind": "fleet_publish"}` record; with a `recorder`, it bumps
    `serve.<tenant>.publishes`."""

    def __init__(self, journal=None, recorder=None, *,
                 capacity_tiers: bool = False,
                 stack_precision: str = "f32") -> None:
        if stack_precision not in STACK_PRECISIONS:
            raise ValueError(
                f"stack_precision must be f32|bf16, got {stack_precision!r}")
        self._lock = threading.Lock()
        self._registries: "dict[str, ModelRegistry]" = {}
        self._specs: "dict[str, TenantSpec]" = {}
        self._order: "list[str]" = []
        self._tenant_k: "dict[str, int]" = {}
        self._stacks: "dict[int, StackedSnapshot]" = {}
        self._stack_builds: "dict[int, int]" = {}
        # Tiered residency state (serving/residency.py drives it): _hot
        # is stack membership per tenant (a fleet without residency
        # never flips it); _tenant_rows keeps each tenant's (theta, p)
        # row counts across cold unloads so the tier's slot budgets
        # survive paging; _tiers the per-K high-water {capacity,
        # ip_slot, word_slot}, which never shrinks.
        self._hot: "dict[str, bool]" = {}
        self._tenant_rows: "dict[str, tuple]" = {}
        self._tiers: "dict[int, dict]" = {}
        self._capacity_tiers = capacity_tiers
        self._stack_precision = stack_precision
        self._journal = getattr(journal, "journal", journal)
        self._recorder = recorder

    @property
    def capacity_tiers(self) -> bool:
        return self._capacity_tiers

    @property
    def stack_precision(self) -> str:
        return self._stack_precision

    # -- tenant membership --------------------------------------------------

    def add_tenant(self, spec: TenantSpec, *, hot: bool = True) -> None:
        """Register one tenant.  `hot=False` (tiered residency's start)
        keeps it out of the stack until a promotion admits it."""
        with self._lock:
            if spec.tenant in self._registries:
                raise ValueError(f"tenant {spec.tenant!r} already added")
            self._registries[spec.tenant] = ModelRegistry()
            self._specs[spec.tenant] = spec
            self._order.append(spec.tenant)
            self._hot[spec.tenant] = hot

    def tenants(self) -> "list[str]":
        with self._lock:
            return list(self._order)

    def spec(self, tenant: str) -> TenantSpec:
        with self._lock:
            return self._specs[tenant]

    def view(self, tenant: str) -> _TenantRegistryView:
        self._registry(tenant)          # raise early on an unknown tenant
        return _TenantRegistryView(self, tenant)

    def _registry(self, tenant: str) -> ModelRegistry:
        with self._lock:
            reg = self._registries.get(tenant)
        if reg is None:
            raise KeyError(
                f"unknown tenant {tenant!r} (known: {self.tenants()})")
        return reg

    # -- publish / read -----------------------------------------------------

    def publish(self, tenant: str, model: ScoringModel,
                source: str) -> ModelSnapshot:
        """Validate and promote `model` for one tenant (registry.py
        semantics: a model that fails validation leaves the active one
        in place), then install a rebuilt stack for its K-group, built
        outside the lock."""
        reg = self._registry(tenant)
        snap = reg.publish(model, source)
        k = model.theta.shape[1]
        with self._lock:
            old_k = self._tenant_k.get(tenant)
            self._tenant_k[tenant] = k
            self._tenant_rows[tenant] = (model.theta.shape[0],
                                         model.p.shape[0])
            stale = old_k if old_k is not None and old_k != k else None
            hot = self._hot.get(tenant, True)
        if stale is not None:
            self._refresh_stack(stale)
        if hot:
            self._refresh_stack(k)
        if self._journal is not None:
            self._journal.append({
                "kind": "fleet_publish", "tenant": tenant,
                "version": snap.version, "source": source, "k": k,
                "ip_rows": model.theta.shape[0],
                "word_rows": model.p.shape[0],
            })
        if self._recorder is not None:
            self._recorder.counter(f"serve.{tenant}.publishes").add(1)
        return snap

    def load_day(self, tenant: str, day_dir: str,
                 fallback: float) -> ModelSnapshot:
        """Load a day directory's model through a registry's loader and
        publish it through the fleet, so the stack rebuilds."""
        snap = ModelRegistry().load_day(day_dir, fallback)
        return self.publish(tenant, snap.model, source=day_dir)

    def active(self, tenant: str) -> ModelSnapshot:
        return self._registry(tenant).active()

    def previous(self, tenant: str) -> "ModelSnapshot | None":
        return self._registry(tenant).previous()

    def version(self, tenant: str) -> int:
        return self._registry(tenant).version

    # -- stacked snapshots --------------------------------------------------

    def tenant_k(self, tenant: str) -> int:
        with self._lock:
            k = self._tenant_k.get(tenant)
        if k is None:
            raise RuntimeError(f"tenant {tenant!r} has no published model yet")
        return k

    def stack(self, k: int) -> StackedSnapshot:
        with self._lock:
            snap = self._stacks.get(k)
        if snap is None:
            raise RuntimeError(f"no stacked snapshot for K={k}")
        return snap

    def stack_for(self, tenant: str) -> StackedSnapshot:
        return self.stack(self.tenant_k(tenant))

    def _tier_locked(self, k: int, census: int) -> "dict | None":
        """Caller holds self._lock.  The K-group's capacity tier: a
        power-of-two slot count covering the hot census's high-water,
        slot row budgets covering the largest tenant of the group (hot,
        warm or cold: a warm tenant must fit its slot the day it is
        promoted).  Monotone: a shrinking census never shrinks it."""
        if not self._capacity_tiers:
            return None
        ip_slot = word_slot = 1
        for t in self._order:
            if self._tenant_k.get(t) != k:
                continue
            rows = self._tenant_rows.get(t)
            if rows is not None:
                ip_slot = max(ip_slot, _pow2(rows[0]))
                word_slot = max(word_slot, _pow2(rows[1]))
        prev = self._tiers.get(k, {})
        tier = {
            "capacity": max(_pow2(census), prev.get("capacity", 1)),
            "ip_slot": max(ip_slot, prev.get("ip_slot", 1)),
            "word_slot": max(word_slot, prev.get("word_slot", 1)),
        }
        self._tiers[k] = tier
        return tier

    def tier(self, k: int) -> "dict | None":
        """The K-group's capacity tier (None without capacity tiers)."""
        with self._lock:
            t = self._tiers.get(k)
            return dict(t) if t is not None else None

    def _refresh_stack(self, k: int) -> None:
        """Rebuild the K-group's stack from its hot members' current
        snapshots and install it: the concatenation runs outside the
        lock, and the install checks that no member published (or
        paged) meanwhile, else builds again, so concurrent publishes
        converge on a stack holding both."""
        while True:
            with self._lock:
                members = [t for t in self._order
                           if self._tenant_k.get(t) == k
                           and self._hot.get(t, True)]
                regs = {t: self._registries[t] for t in members}
                tier = self._tier_locked(k, len(members))
            try:
                snaps = {t: regs[t].active() for t in members}
            except RuntimeError:
                # A member counted hot was paged out (its registry
                # unloaded) while no lock was held; its membership flip
                # queued its own rebuild: build again on the new census.
                continue
            if not snaps:
                with self._lock:
                    self._stacks.pop(k, None)
                return
            with self._lock:
                self._stack_builds[k] = self._stack_builds.get(k, 0) + 1
                build = self._stack_builds[k]
            built = _build_stack(k, members, snaps, build, tier=tier,
                                 precision=self._stack_precision)
            with self._lock:
                live = {t: self._registries[t].version for t in members
                        if self._tenant_k.get(t) == k
                        and self._hot.get(t, True)}
                if live == {t: s.version for t, s in snaps.items()}:
                    cur = self._stacks.get(k)
                    if cur is None or cur.stack_version < build:
                        self._stacks[k] = built
                    return

    # -- tiered residency hooks (serving/residency.py) ---------------------

    def is_hot(self, tenant: str) -> bool:
        with self._lock:
            return self._hot.get(tenant, True)

    def hot_census(self, k: int) -> "list[str]":
        """Hot members of the K-group, in registration order."""
        with self._lock:
            return [t for t in self._order
                    if self._tenant_k.get(t) == k
                    and self._hot.get(t, True)]

    def set_hot(self, tenant: str, hot: bool) -> None:
        """Flip one tenant's stack membership and rebuild its group's
        stack (outside the lock, as a publish does)."""
        self.set_hot_many({tenant: hot})

    def set_hot_many(self, changes: "dict[str, bool]") -> None:
        """Flip several memberships with one rebuild per affected
        K-group: a promotion with its eviction costs one concatenation."""
        for tenant in changes:
            self._registry(tenant)
        ks: set = set()
        with self._lock:
            for tenant, hot in changes.items():
                if self._hot.get(tenant, True) == hot:
                    continue
                self._hot[tenant] = hot
                k = self._tenant_k.get(tenant)
                if k is not None:
                    ks.add(k)
        for k in sorted(ks):
            self._refresh_stack(k)

    def unload_tenant(self, tenant: str) -> "ModelSnapshot | None":
        """Drop a non-hot tenant's snapshot from host memory, keeping its
        version (warm -> cold).  Returns the snapshot that was active,
        for the caller to checkpoint."""
        if self.is_hot(tenant):
            raise RuntimeError(
                f"tenant {tenant!r} is stack-resident — evict to warm "
                "before unloading to cold")
        return self._registry(tenant).unload()

    def restore_tenant(self, tenant: str, model: ScoringModel,
                       source: str, version: int) -> ModelSnapshot:
        """Reinstall a cold tenant's checkpointed model at its version
        (cold -> warm); the stack is untouched until set_hot."""
        return self._registry(tenant).restore(model, source, version)

    def loaded(self, tenant: str) -> bool:
        return self._registry(tenant).loaded


def tenant_pairs(feats, dsource: str, model: ScoringModel,
                 ip_base: int, word_base: int):
    """One tenant segment's (ip_rows, word_rows) in stacked coordinates
    and its pairs per event: flow events give two (endpoint, word) pairs
    each, the src block then the dst block, min-combined at demux; DNS
    and table sources one (the source's `event_pairs`).  Rows come from
    the tenant's own index maps (misses: the tenant's fallback row),
    shifted by its base offsets into the stacked matrices."""
    from ..sources import get as get_source

    pairs = get_source(dsource).event_pairs(feats)
    ip = np.concatenate([model.ip_rows(keys) for keys, _ in pairs]) \
        + np.int32(ip_base)
    w = np.concatenate([model.word_rows(words) for _, words in pairs]) \
        + np.int32(word_base)
    return ip.astype(np.int32), w.astype(np.int32), len(pairs)


def demux_scores(scores_seg: np.ndarray, mult: int) -> np.ndarray:
    """Per-event scores of a tenant's pair-score segment: multi-pair
    sources (flow's src/dst blocks) min-combine block-wise."""
    if mult == 2:
        n = scores_seg.shape[0] // 2
        return np.minimum(scores_seg[:n], scores_seg[n:])
    if mult > 2:
        n = scores_seg.shape[0] // mult
        return scores_seg.reshape(mult, n).min(axis=0)
    return scores_seg


class FleetScorer:
    """Cross-tenant micro-batching over a FleetRegistry.

    `featurizers` maps tenant -> serving featurizer (serving/events.py).
    `on_batch(tenant, snapshot, feats, scores)` runs per tenant segment
    after each flush (the refresh loops and flagged-event output hang
    off it).  `device` is where device-path dispatches and fused calls
    run (None: the card).  The flush triggers (host-scoped) and the
    featurize block resolve through the plan cache (a ServingConfig
    value that differs from the default, else a plan entry, else the
    default; a plan max_batch above the lanes' total capacity falls back
    to the default, re-checked as add_tenant grows it); the featurize
    engine and break-even through sources/device.resolve_engine and
    resolve_break_even (env, config, this device's plan entry,
    default).

    `dynamic=True` (a replica of the replicated fleet, serving/
    replica.py) starts with however many tenants the registry knows,
    possibly none, and grows lanes at run time through add_tenant() as
    the router places tenants on the replica; the worker parks on "no
    drainable lane" until the first lane appears."""

    def __init__(self, fleet: FleetRegistry, featurizers: dict,
                 config: "ServingConfig | None" = None,
                 metrics: "MetricsEmitter | None" = None,
                 on_batch=None, journal=None, residency=None,
                 device=None, dynamic: bool = False) -> None:
        from ..device import resolve_device
        from ..plans import NullStore, current_store
        from ..telemetry.spans import current_recorder

        self.fleet = fleet
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        # Tiered residency (serving/residency.py): the worker drains only
        # hot tenants' lanes; a non-hot tenant's admission asks for a
        # promotion and its events wait in their own bounded lane, so a
        # promotion shows as that tenant's latency only.
        self._residency = residency
        self.metrics = metrics
        self.on_batch = on_batch
        self._journal = (getattr(journal, "journal", journal)
                         if journal is not None
                         else (metrics._journal if metrics is not None
                               else None))
        self._dynamic = dynamic
        self._lanes: "dict[str, TenantLane]" = {}
        for tenant in fleet.tenants():
            fz = featurizers.get(tenant)
            if fz is None:
                raise ValueError(f"no featurizer for tenant {tenant!r}")
            self._lanes[tenant] = self._make_lane(fleet.spec(tenant), fz)
        if not self._lanes and not dynamic:
            raise ValueError("FleetScorer needs at least one tenant")
        cfg = self.config
        from ..plans import resolve

        mb, mb_src = resolve("fleet_max_batch", cfg.fleet_max_batch)
        mw, mw_src = resolve("fleet_max_wait_ms", cfg.fleet_max_wait_ms)
        # Remembered so add_tenant can re-apply the guard below as the
        # capacity grows.
        self._plan_max_batch, self._plan_max_batch_src = int(mb), mb_src
        total = sum(lane.queue_max for lane in self._lanes.values())
        if self._lanes and mb_src == "plan" and int(mb) > total:
            # As in BatchScorer: a plan flush size above the fleet's
            # total admission capacity would make the max_batch trigger
            # unreachable (every flush the timer's): the default.
            mb, mb_src = cfg.fleet_max_batch, "default"
        self.max_batch = int(mb)
        self.max_wait_ms = float(mw)
        eng, eng_src = resolve_engine(cfg.featurize_engine,
                                      device=self.device)
        self._featurize_engine = eng
        fb, fb_src = resolve("featurize_block", cfg.featurize_block,
                             device=self.device)
        self._featurize_block = int(fb)
        # Below the break-even a segment featurizes on the host even
        # under the device engines.
        if eng == "host":
            be, be_src = 1, "engine"
        else:
            be, be_src = resolve_break_even(cfg.featurize_break_even,
                                            device=self.device)
        self._featurize_break_even = int(be)
        self.plan = {
            "max_batch": {"value": self.max_batch, "source": mb_src},
            "max_wait_ms": {"value": self.max_wait_ms, "source": mw_src},
            "featurize_engine": {"value": eng, "source": eng_src},
            "featurize_block": {"value": self._featurize_block,
                                "source": fb_src},
            "featurize_break_even": {"value": self._featurize_break_even,
                                     "source": be_src},
        }
        if self.max_batch < 1:
            raise ValueError(
                f"fleet_max_batch ({self.max_batch}) must be >= 1")
        if self.max_wait_ms <= 0:
            raise ValueError(
                f"fleet_max_wait_ms must be > 0, got {self.max_wait_ms}")
        if cfg.device_score_min in (0, "auto"):
            # The calibration runs here, never inside a flush whose
            # latency max_wait_ms bounds.
            from ..scoring import dispatch_calibration

            dispatch_calibration(device=self.device)
        # What the flushes did, for the records and the smoke: segments
        # featurized on the device tables or the host (and their
        # walls), models the device tables could not lower, residency
        # misses, fused calls, tenant failures.
        self.counts = {"featurize_device": 0, "featurize_host": 0,
                       "featurize_device_events": 0,
                       "featurize_host_events": 0,
                       "featurize_device_s": 0.0, "featurize_host_s": 0.0,
                       "unlowered": 0, "residency_misses": 0,
                       "fused_dispatches": 0, "failures": 0}
        self._cond = threading.Condition()
        self._closed = False
        self._force_flush = False
        self._batch_seq = 0
        self._events_scored = 0
        if self._residency is not None:
            # A promotion must wake a worker parked on "no drainable
            # lane"; the waker takes the condvar only.
            self._residency.add_waker(self._wake)
        # Context variables do not cross a thread start: the plan store
        # (a NullStore where plans are off) and the active Recorder go
        # to the worker explicitly.
        self._plan_store = current_store() or NullStore()
        self._recorder = current_recorder()
        self._worker = threading.Thread(target=self._run,
                                        name="oni-fleet-scorer", daemon=True)
        self._worker.start()

    def _make_lane(self, spec: TenantSpec, fz) -> TenantLane:
        if getattr(fz, "dsource", None) != spec.dsource:
            raise ValueError(
                f"tenant {spec.tenant!r} declares dsource "
                f"{spec.dsource!r} but its featurizer is "
                f"{getattr(fz, 'dsource', None)!r}")
        lane = TenantLane(
            spec=spec, featurizer=fz,
            queue_max=spec.queue_max or self.config.tenant_queue_max,
            admission=spec.admission or self.config.admission,
            threshold=(spec.threshold if spec.threshold is not None
                       else self.config.threshold))
        if lane.queue_max < 1:
            raise ValueError(
                f"tenant {lane.spec.tenant!r} queue_max must be >= 1")
        return lane

    def add_tenant(self, spec: TenantSpec, featurizer) -> None:
        """Grow one admission lane at run time (dynamic fleets only: the
        router places tenants on a running replica).  The tenant must
        already be registered and published in the FleetRegistry; the
        new lane is drainable on the next take."""
        if not self._dynamic:
            raise RuntimeError(
                "add_tenant on a static FleetScorer — construct with "
                "dynamic=True")
        self.fleet.spec(spec.tenant)    # raise early on unknown tenant
        lane = self._make_lane(spec, featurizer)
        with self._cond:
            if self._closed:
                raise RuntimeError("FleetScorer is closed")
            if spec.tenant in self._lanes:
                raise ValueError(
                    f"tenant {spec.tenant!r} already has a lane")
            self._lanes[spec.tenant] = lane
            # The plan-flush guard again at the grown capacity: once it
            # covers a plan max_batch, the measured value takes effect.
            if self._plan_max_batch_src == "plan":
                total = sum(lane.queue_max for lane in self._lanes.values())
                if self._plan_max_batch > total:
                    self.max_batch, src = self.config.fleet_max_batch, \
                        "default"
                else:
                    self.max_batch, src = self._plan_max_batch, "plan"
                self.plan["max_batch"] = {"value": self.max_batch,
                                          "source": src}
            self._cond.notify_all()

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    # -- producer side ------------------------------------------------------

    def submit(self, tenant: str, raw):
        """Enqueue one raw event for `tenant`.  Raises ValueError on a
        malformed event (never enqueued), KeyError on an unknown tenant,
        RuntimeError after close().  A full tenant queue blocks
        (admission "block": the stall priced into
        `serve.<tenant>.admission_stall_s` and journaled like a
        dataplane edge) or raises AdmissionRejected (admission "reject",
        journaled as `{"kind": "admission_reject"}`)."""
        lane = self._lanes.get(tenant)
        if lane is None:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(known: {sorted(self._lanes)})")
        admit = getattr(lane.featurizer, "admit", None)
        if admit is not None:
            # The line splits once, here; a device-featurized flush
            # consumes the row, the host featurizer the raw event.
            validated, row = admit(raw)
        else:
            validated = lane.featurizer.validate(raw)
            row = None
        reject_info = None
        wait_ns = 0
        with self._cond:
            if self._closed:
                raise RuntimeError("FleetScorer is closed")
            if lane.full_locked() and lane.admission == "reject":
                lane.rejected += 1
                reject_info = (len(lane.pending), lane.queue_max)
            else:
                t0 = None
                while not self._closed and lane.full_locked():
                    if t0 is None:
                        t0 = time.perf_counter_ns()
                    self._cond.wait()
                if t0 is not None:
                    wait_ns = time.perf_counter_ns() - t0
                    lane.admission_stall_ns += wait_ns
                if self._closed:
                    raise RuntimeError("FleetScorer is closed")
                p = _PendingEvent(validated, time.perf_counter(), row)
                lane.pending.append(p)
                lane.submitted += 1
                depth = len(lane.pending)
                self._cond.notify_all()
        if reject_info is not None:
            depth, capacity = reject_info
            self._journal_safe({"kind": "admission_reject",
                                "tenant": tenant, "depth": depth,
                                "capacity": capacity})
            if self.metrics is not None:
                self.metrics.recorder.counter(
                    f"serve.{tenant}.admission_rejects").add(1)
            raise AdmissionRejected(tenant, depth, capacity)
        if wait_ns:
            if self.metrics is not None:
                self.metrics.recorder.histogram(
                    f"serve.{tenant}.admission_stall_s").observe(
                        wait_ns / 1e9)
            self._journal_safe({
                "kind": "dataplane", "event": "depth",
                "edge": f"admit.{tenant}", "side": "put",
                "depth": depth, "wait_s": round(wait_ns / 1e9, 6)})
        if self._residency is not None:
            # Outside _cond: the residency manager has its own lock, and
            # nesting it under the condvar would deadlock against the
            # promotion waker.  The touch is the LRU/LFU signal; a
            # non-hot tenant's touch queues a promotion.
            self._residency.note_admission(tenant)
        return p.future

    def flush(self) -> None:
        """Flush what is queued without waiting for a trigger (a no-op on
        an empty fleet queue)."""
        with self._cond:
            if any(lane.pending for lane in self._lanes.values()):
                self._force_flush = True
                self._cond.notify_all()

    def close(self, timeout: "float | None" = None) -> bool:
        """Drain every tenant queue, then stop the worker.  A drain that
        outlives a finite timeout fails the still-queued futures and
        returns False."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout)
        if not self._worker.is_alive():
            return True
        undrained: list = []
        with self._cond:
            for lane in self._lanes.values():
                undrained.extend(lane.pending)
                lane.pending.clear()
        err = RuntimeError(
            f"FleetScorer.close timed out after {timeout}s with "
            f"{len(undrained)} events undrained")
        for p in undrained:
            p.future._fail(err)
        return False

    @property
    def events_scored(self) -> int:
        with self._cond:
            return self._events_scored

    @property
    def batches_flushed(self) -> int:
        with self._cond:
            return self._batch_seq

    def tenant_stats(self) -> "list[dict]":
        with self._cond:
            return [self._lanes[t].stats_locked()
                    for t in sorted(self._lanes)]

    def tenant_threshold(self, tenant: str) -> float:
        """A tenant's resolved threshold (its spec's, else the
        config's): the one resolution the lane's `flagged` count uses."""
        return self._lanes[tenant].threshold

    def pending(self, tenant: str) -> int:
        """Events queued for `tenant` now (a heuristic read, no lock:
        the residency manager's eviction probe)."""
        return len(self._lanes[tenant].pending)

    # -- worker side --------------------------------------------------------

    def _request_stranded_locked(self) -> None:
        """Caller holds self._cond.  An event admitted while its tenant
        was hot strands if the tenant is evicted before the drain:
        re-request promotion for every pending lane that is not
        drainable.  The manager never takes this condvar under its own
        lock, so the order is safe."""
        if self._residency is None:
            return
        ready = self._residency.drainable
        stranded = [l.spec.tenant for l in self._lanes.values()
                    if l.pending and l.spec.tenant not in ready]
        if stranded:
            self._residency.request_promotions(stranded)

    def _drainable_locked(self) -> "list[TenantLane]":
        """Caller holds self._cond.  Lanes the worker may drain now:
        pending events of hot tenants (or residency off, or a tenant the
        manager does not manage).  After close() every lane drains: a
        tenant still paging scores alone rather than wedging shutdown."""
        lanes = self._lanes.values()
        if self._residency is None or self._closed:
            return [l for l in lanes if l.pending]
        ready = self._residency.drainable
        return [l for l in lanes
                if l.pending and (l.spec.tenant in ready
                                  or not self._residency.is_managed(
                                      l.spec.tenant))]

    def _take_batch(self):
        """Block until a trigger fires -> (batch, trigger, depth after):
        [(tenant, _PendingEvent)] drained globally oldest-first across
        the drainable queues, so a bursty tenant fills its own queue but
        cannot delay another tenant's older event.  An empty batch means
        shutdown."""
        max_wait_s = self.max_wait_ms / 1e3
        lanes = self._lanes
        with self._cond:
            while not self._closed and not self._drainable_locked():
                self._request_stranded_locked()
                self._cond.wait()
            if not self._drainable_locked():
                return [], "shutdown", 0
            trigger = "close" if self._closed else None
            while trigger is None:
                ready = self._drainable_locked()
                if not ready:
                    # A promotion reversal took every drainable lane
                    # mid-wait: park again.
                    self._request_stranded_locked()
                    self._cond.wait()
                    if self._closed:
                        trigger = "close"
                    continue
                if self._force_flush:
                    trigger = "flush"
                    break
                if sum(len(l.pending) for l in ready) >= self.max_batch:
                    trigger = "max_batch"
                    break
                oldest = min(l.pending[0].t_enqueue for l in ready)
                waited = time.perf_counter() - oldest
                if waited >= max_wait_s:
                    trigger = "max_wait"
                    break
                self._cond.wait(max_wait_s - waited)
                if self._closed:
                    trigger = "close"
            self._force_flush = False
            # K-way merge on enqueue time through a heap of lane heads:
            # O(batch log tenants) under the lock every submitter shares.
            heads = [(lane.pending[0].t_enqueue, lane.spec.tenant)
                     for lane in self._drainable_locked()]
            heapq.heapify(heads)
            batch: list = []
            while heads and len(batch) < self.max_batch:
                _, t = heapq.heappop(heads)
                lane = lanes[t]
                batch.append((t, lane.pending.popleft()))
                if lane.pending:
                    heapq.heappush(heads, (lane.pending[0].t_enqueue, t))
            depth = sum(len(l.pending) for l in lanes.values())
            self._cond.notify_all()   # release blocked submitters
            return batch, trigger, depth

    def _run(self) -> None:
        from ..plans import use_store
        from ..telemetry.spans import use_recorder

        with use_store(self._plan_store), (
                use_recorder(self._recorder) if self._recorder is not None
                else contextlib.nullcontext()):
            while True:
                batch, trigger, depth = self._take_batch()
                if not batch:
                    return
                try:
                    self._score_batch(batch, trigger, depth)
                except Exception as e:
                    # The worker survives anything a flush throws:
                    # resolved futures keep their scores, the rest fail
                    # with the cause.
                    self._count("failures")
                    for _, p in batch:
                        p.future._fail(e)

    def _count(self, key: str, n=1) -> None:
        with self._cond:
            self.counts[key] += n

    def _lane_features(self, lane, items, model):
        """Featurize one tenant segment: through the compiled tables
        when the engine asks for them, the segment reaches the
        break-even, the tenant's stacked model is known and every event
        carried its admission row; else through the host featurizer
        (the oracle).  A model the tables cannot lower keeps the host
        featurizer by design: `device_batch` returns None after one
        `featurize_compile` record, which is journaled and counted."""
        t0 = time.perf_counter()
        if (model is not None and self._featurize_engine != "host"
                and len(items) >= self._featurize_break_even):
            rows = [p.row for p in items]
            if all(r is not None for r in rows):
                batch, info = device_batch(lane.featurizer, rows,
                                           [p.raw for p in items], model)
                if info is not None:
                    self._journal_safe(info)
                    if not info.get("lowered", True):
                        self._count("unlowered")
                        if self._recorder is not None:
                            self._recorder.counter(
                                "serve.featurize_unlowered").add(1)
                if batch is not None:
                    # The codes (fused) or word rows are built here,
                    # inside the timed wall.
                    if self._featurize_engine == "fused":
                        batch.codes()
                    else:
                        batch.word_rows_local()
                    self._note_featurize("device", len(items), t0)
                    return batch
        feats = lane.featurizer([p.raw for p in items])
        self._note_featurize("host", len(items), t0)
        return feats

    def _note_featurize(self, path: str, events: int, t0: float) -> None:
        wall = time.perf_counter() - t0
        with self._cond:
            self.counts[f"featurize_{path}"] += 1
            self.counts[f"featurize_{path}_events"] += events
            self.counts[f"featurize_{path}_s"] += wall

    @staticmethod
    def _pair_rows(feats, dsource: str, model: ScoringModel,
                   ip_base: int, word_base: int):
        """tenant_pairs through the device featurizer's table gather when
        the segment was device-featurized against this very model (a
        republish between featurize and score takes the host oracle
        rather than stale rows)."""
        if isinstance(feats, DeviceBatch) and feats.model is model:
            return feats.pair_rows(ip_base, word_base)
        return tenant_pairs(feats, dsource, model, ip_base, word_base)

    def _observe_device(self, t0: float, events: int) -> None:
        if self.metrics is not None:
            rec = self.metrics.recorder
            rec.histogram("serve.device_score_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            rec.counter("serve.device_events").add(events)

    def _fused_group(self, tenant, stack, feats_by_tenant, tenant_scores,
                     tenant_snaps, tenant_device, failures) -> bool:
        """The fused flush (ops/featurize_kernel.py: table gather + row
        gathers + dot in one call on the card) for a single-tenant
        K-group whose segment was device-featurized against the stacked
        member's model.  False when that does not hold (the caller takes
        the packed path); True once the call ran, or failed, which fails
        the tenant's futures like any group failure."""
        feats = feats_by_tenant[tenant]
        member = stack.members[tenant]
        if not (isinstance(feats, DeviceBatch)
                and feats.model is member.model):
            return False
        try:
            from ..scoring.pipeline import fused_featurize_scores

            dev, codes, ip = feats.fused_operands(stack.ip_base[tenant])
            t_g0 = time.perf_counter()
            pair_scores = fused_featurize_scores(
                stack.model, dev, codes, ip,
                word_base=stack.word_base[tenant],
                block=self._featurize_block, device=self.device)
            self._observe_device(t_g0, feats.num_raw_events)
            self._count("fused_dispatches")
            tenant_scores[tenant] = demux_scores(pair_scores,
                                                 dev.pairs_per_event)
            tenant_snaps[tenant] = member
            tenant_device[tenant] = True
        except Exception as e:
            failures.setdefault(tenant, e)
        return True

    def _score_batch(self, batch, trigger: str, depth: int) -> None:
        cfg = self.config
        t0 = time.perf_counter()
        # Segment per tenant (submit order kept inside a segment), then
        # group tenants by K: one stacked snapshot, one dispatch, per
        # group.
        segments: "dict[str, list]" = {}
        for tenant, p in batch:
            segments.setdefault(tenant, []).append(p)
        stacks: dict = {}
        tenant_scores: "dict[str, np.ndarray]" = {}
        tenant_snaps: dict = {}
        failures: "dict[str, Exception]" = {}
        groups: "dict[int, list]" = {}
        solo: list = []
        feats_by_tenant: dict = {}
        # Each tenant's K is read once, here: a publish that changes a
        # tenant's K mid-flush must not send a later read to a stack
        # this flush never took.
        tenant_ks: "dict[str, int]" = {}
        for tenant, items in segments.items():
            lane = self._lanes[tenant]
            try:
                k = self.fleet.tenant_k(tenant)
                tenant_ks[tenant] = k
                if k not in stacks:
                    try:
                        stacks[k] = self.fleet.stack(k)
                    except RuntimeError:
                        # No hot member in the K-group at all: the group
                        # scores alone, tenant by tenant.
                        stacks[k] = None
                stack = stacks[k]
                member = (stack.members.get(tenant)
                          if stack is not None else None)
                feats = self._lane_features(
                    lane, items, member.model if member is not None else None)
                if feats.num_raw_events != len(items):
                    raise RuntimeError(
                        f"tenant {tenant!r} featurizer returned "
                        f"{feats.num_raw_events} rows for "
                        f"{len(items)} events")
                feats_by_tenant[tenant] = feats
                if member is not None:
                    groups.setdefault(k, []).append(tenant)
                else:
                    # A residency miss at scoring time (evicted between
                    # take and score, or a close-time drain of a paging
                    # lane): the tenant scores on its own registry
                    # snapshot.  The gather-dot is per row, so on an f32
                    # stack these scores equal the packed ones; under
                    # bf16 the solo path scores at float32 storage, so
                    # it agrees within bf16's bound, not bit for bit.
                    solo.append(tenant)
            except Exception as e:
                # Tenant-scoped failure: its futures only.
                failures[tenant] = e
        dispatches = 0
        device_dispatches = 0
        tenant_device: "dict[str, bool]" = {}
        for k, group in sorted(groups.items()):
            stack = stacks[k]
            if (self._featurize_engine == "fused" and len(group) == 1
                    and self._fused_group(group[0], stack, feats_by_tenant,
                                          tenant_scores, tenant_snaps,
                                          tenant_device, failures)):
                dispatches += 1
                device_dispatches += 1
                continue
            try:
                parts = []
                mults = {}
                for tenant in group:
                    ip, w, mult = self._pair_rows(
                        feats_by_tenant[tenant],
                        self._lanes[tenant].spec.dsource,
                        stack.members[tenant].model,
                        stack.ip_base[tenant], stack.word_base[tenant])
                    parts.append((tenant, ip, w))
                    mults[tenant] = mult
                ip_all = np.concatenate([ip for _, ip, _ in parts])
                w_all = np.concatenate([w for _, _, w in parts])
                # One dispatch for the whole K-group, decided on its
                # packed pair count (flow events pack two pairs each).
                # Device dispatches feed the serve roofline's histograms
                # per group, with the group's own wall and events.
                is_device = use_device_path(len(ip_all),
                                            cfg.device_score_min,
                                            self.device)
                t_g0 = time.perf_counter()
                pair_scores = batched_scores(stack.model, ip_all, w_all,
                                             cfg.device_score_min,
                                             self.device)
                dispatches += 1
                if is_device:
                    device_dispatches += 1
                    self._observe_device(t_g0, sum(
                        feats_by_tenant[t].num_raw_events for t in group))
                off = 0
                for tenant, ip, _ in parts:
                    seg = pair_scores[off:off + len(ip)]
                    off += len(ip)
                    tenant_scores[tenant] = demux_scores(seg, mults[tenant])
                    tenant_snaps[tenant] = stack.members[tenant]
                    tenant_device[tenant] = is_device
            except Exception as e:
                for tenant in group:
                    failures.setdefault(tenant, e)
        # One dispatch per residency miss, on the tenant's own model.
        for tenant in solo:
            self._count("residency_misses")
            try:
                try:
                    snap = self.fleet.active(tenant)
                except RuntimeError:
                    if self._residency is None:
                        raise
                    # A cold tenant drained now (close-time drain, or a
                    # demotion racing this flush): read its checkpoint
                    # through, at its version, without a tier change.
                    snap = self._residency.read_through(tenant)
                ip, w, mult = tenant_pairs(
                    feats_by_tenant[tenant],
                    self._lanes[tenant].spec.dsource, snap.model, 0, 0)
                is_device = use_device_path(len(ip), cfg.device_score_min,
                                            self.device)
                t_g0 = time.perf_counter()
                pair_scores = batched_scores(snap.model, ip, w,
                                             cfg.device_score_min,
                                             self.device)
                dispatches += 1
                if is_device:
                    device_dispatches += 1
                    self._observe_device(
                        t_g0, feats_by_tenant[tenant].num_raw_events)
                tenant_scores[tenant] = demux_scores(pair_scores, mult)
                tenant_snaps[tenant] = snap
                tenant_device[tenant] = is_device
            except Exception as e:
                failures.setdefault(tenant, e)
        t1 = time.perf_counter()
        # Demux: resolve each tenant's futures against the snapshot its
        # segment scored on (tenant B's futures carry B's version while
        # A hot-swaps or pages).
        flagged: "dict[str, int]" = {}
        for tenant, items in segments.items():
            if tenant in failures:
                for p in items:
                    p.future._fail(failures[tenant])
                continue
            scores = tenant_scores[tenant]
            version = tenant_snaps[tenant].version
            for p, s in zip(items, scores):
                p.future._resolve(float(s), version)
            flagged[tenant] = int(np.sum(
                scores < self._lanes[tenant].threshold))
        t2 = time.perf_counter()
        scored_n = sum(len(items) for t, items in segments.items()
                       if t not in failures)
        with self._cond:
            seq = self._batch_seq
            self._batch_seq += 1
            self._events_scored += scored_n
            self.counts["failures"] += len(failures)
            for tenant, items in segments.items():
                if tenant in failures:
                    continue
                self._lanes[tenant].scored += len(items)
                self._lanes[tenant].flagged += flagged[tenant]
        self._journal_safe({
            "kind": "demux", "batch": seq, "events": len(batch),
            "tenants": len(segments), "segments": dispatches,
            "residency_misses": len(solo),
            "featurize": self._featurize_engine,
            "featurize_device_tenants": sum(
                isinstance(f, DeviceBatch) for f in feats_by_tenant.values()),
            "score_ms": round((t1 - t0) * 1e3, 3),
            "demux_ms": round((t2 - t1) * 1e3, 3),
        })
        # Per-tenant consumers and records, then the flush's aggregate.
        # The aggregate's scorer is "device" when at least one group's
        # dispatch took the card.
        score_s = t1 - t0
        n = len(batch)
        for tenant, items in sorted(segments.items()):
            if tenant in failures:
                self._emit_safe({
                    "stage": "serve", "tenant": tenant, "batch": seq,
                    "events": len(items), "error": repr(failures[tenant]),
                    "trigger": trigger})
                continue
            k = tenant_ks[tenant]
            snap = tenant_snaps[tenant]
            if self.on_batch is not None:
                try:
                    self.on_batch(tenant, snap, feats_by_tenant[tenant],
                                  tenant_scores[tenant])
                except Exception as e:
                    # A consumer's failure never takes scoring down.
                    self._emit_safe({"stage": "serve", "tenant": tenant,
                                     "batch": seq,
                                     "on_batch_error": repr(e)})
            oldest = items[0].t_enqueue
            stack = stacks.get(k)
            self._emit_safe({
                "stage": "serve", "tenant": tenant, "batch": seq,
                "events": len(items), "trigger": trigger,
                "model_version": snap.version,
                # None: a solo (residency-miss) dispatch.
                "stack_version": (stack.stack_version
                                  if stack is not None
                                  and tenant in stack.members else None),
                # The tenant's own segment's dispatch: in a mixed-K flush
                # a host-scored tenant is not labelled by another
                # group's device dispatch.
                "scorer": "device" if tenant_device.get(tenant) else "host",
                "latency_ms": round((t1 - oldest) * 1e3, 3),
                "queue_wait_ms": round((t0 - oldest) * 1e3, 3),
                "score_ms": round(score_s * 1e3, 3),
                "demux_ms": round((t2 - t1) * 1e3, 3),
                "flagged": flagged[tenant],
            })
        oldest_all = batch[0][1].t_enqueue
        self._emit_safe({
            "stage": "serve", "batch": seq, "events": n,
            "tenants": len(segments), "segments": dispatches,
            "segments_device": device_dispatches,
            "trigger": trigger,
            "scorer": "device" if device_dispatches else "host",
            "latency_ms": round((t1 - oldest_all) * 1e3, 3),
            "queue_wait_ms": round((t0 - oldest_all) * 1e3, 3),
            "score_ms": round(score_s * 1e3, 3),
            "demux_ms": round((t2 - t1) * 1e3, 3),
            "events_per_sec": round(n / score_s, 1) if score_s else None,
            "queue_depth": depth,
            "flagged": sum(flagged.values()),
        })

    # -- telemetry sinks ----------------------------------------------------

    def _emit_safe(self, record: dict) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.emit(record)
        except Exception as e:
            print(f"fleet metrics emit failed: {e!r}", file=sys.stderr)

    def _journal_safe(self, record: dict) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(record)
        except Exception as e:
            print(f"fleet journal append failed: {e!r}", file=sys.stderr)
