"""Tiered model residency for the serving fleet: hot on the card, warm
in host RAM, cold in checkpoints (port of oni_ml_tpu/serving/residency.py).

A FleetRegistry without residency stacks every tenant's theta/p on the
card, so device memory grows with tenants x documents x K.  This module
makes the card a managed cache over host RAM and checkpoints:

hot
    Members of the K-group's StackedSnapshot (serving/fleet.py), scored
    in packed cross-tenant dispatches.  At most
    ``ServingConfig.fleet_hot_tenants`` per K-group (plan knob
    ``fleet_hot_tenants`` where the config leaves it at 0).
warm
    The tenant's validated snapshot stays in its registry (host numpy)
    but out of the stack: no device bytes.  Promotion is one stack
    rebuild, the outside-the-lock path a publish takes, so resident
    tenants never stall while another pages, and under capacity tiers
    (fleet.py `_build_stack`) the stacked shape stays put.
cold
    The model leaves host memory too.  A tenant loaded from a day
    directory reloads from its doc_results.csv / word_results.csv; any
    other spills to an atomic npz (io/formats.atomic_write) under
    the spill dir.  float64 round-trips bit-exactly either way, and the
    registry keeps the version across the unload: a tenant paged cold
    and back serves the same (model, version).

The policy is driven by admissions: every `FleetScorer.submit` touches
its tenant (`note_admission`), a touch of a non-hot tenant queues a
promotion on the pager thread, and eviction victims are picked LRU
(least recently admitted) or LFU (fewest admissions), never a tenant
with events queued while a quiet one is hot.  Every move is journaled
(``residency_promote`` / ``residency_evict``) with its priced stall,
and the tier counts ride the metrics plane as ``residency.hot|warm|cold``
gauges.  The pager thread gets the plan store and Recorder of its
creator explicitly (context variables do not cross a thread start).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..scoring import ScoringModel

TIER_HOT = "hot"
TIER_WARM = "warm"
TIER_COLD = "cold"
POLICIES = ("lru", "lfu")

# Pager-queue sentinel: run a warm-capacity enforcement sweep instead
# of a promotion.
_ENFORCE = "\x00enforce"


def resolve_hot_capacity(config, device=None) -> "tuple[int, str]":
    """The hot capacity per K-group and its source: a positive
    ``ServingConfig.fleet_hot_tenants`` ("config"), else this device's
    plan entry (knob ``fleet_hot_tenants``, "plan"), else 0, unbounded
    ("default").  The config's 0 maps to the knob's None default, so
    the plan layer's override test holds unchanged."""
    from ..plans import resolve

    cfg_value = (config.fleet_hot_tenants if config.fleet_hot_tenants > 0
                 else None)
    value, source = resolve("fleet_hot_tenants", cfg_value, device=device)
    return (int(value) if value else 0, source)


def spill_model(path: str, model: ScoringModel) -> int:
    """Checkpoint one model to an atomic npz (theta/p float64 plus the
    index key arrays in row order) — bit-exact round trip through
    `load_spill`.  Returns the byte size of the published file."""
    from ..io.formats import atomic_write

    ips = sorted(model.ip_index, key=model.ip_index.get)
    words = sorted(model.word_index, key=model.word_index.get)

    def _write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            np.savez(
                f,
                theta=np.asarray(model.theta, np.float64),
                p=np.asarray(model.p, np.float64),
                ips=np.asarray(ips, dtype=object),
                words=np.asarray(words, dtype=object),
            )

    atomic_write(path, _write)
    return os.path.getsize(path)


def load_spill(path: str) -> ScoringModel:
    # allow_pickle: the key arrays are object-dtype strings of a spill
    # this process wrote itself.
    with np.load(path, allow_pickle=True) as z:
        ips = [str(s) for s in z["ips"]]
        words = [str(s) for s in z["words"]]
        return ScoringModel(
            ip_index={s: i for i, s in enumerate(ips)},
            theta=z["theta"],
            word_index={s: i for i, s in enumerate(words)},
            p=z["p"],
        )


@dataclass
class _TenantState:
    """Per-tenant residency bookkeeping.  NOT self-locking: every
    access runs under the owning ResidencyManager's lock."""

    tenant: str
    tier: str
    touch_ns: int = 0            # last admission (monotonic)
    touches: int = 0             # lifetime admissions (the LFU signal)
    promotions: int = 0
    evictions: int = 0
    day_source: "tuple | None" = None   # (day_dir, fallback) cold reload
    day_version: int = 0         # registry version the day artifacts ARE
    spill_path: "str | None" = None
    cold_spilled: bool = False   # this cold period reloads from the spill
    cold_version: int = 0
    cold_source: str = ""
    error: "str | None" = None
    # Promotion-in-flight accounting for the priced stall.
    requested_ns: "int | None" = None
    waiters: int = 0


@dataclass
class _Stats:
    promotions: int = 0
    evictions: int = 0
    cold_loads: int = 0
    spills: int = 0
    promotion_stall_ns: int = 0
    failures: int = 0
    rebuild_ns: int = 0
    read_throughs: int = 0


class ResidencyManager:
    """The three-tier pager.  Owns a daemon pager thread that performs
    promotions (and the evictions they force) OFF the scoring worker:
    the scorer only reads the lock-free `drainable` set and calls
    `note_admission` — a resident tenant's flush path never blocks on
    another tenant's disk read or stack rebuild.

    `hot_capacity` bounds stack membership per K-group (0 = unbounded:
    the manager degrades to pure bookkeeping and every registered
    tenant is immediately promoted); `warm_capacity` bounds how many
    non-hot tenants keep host-resident models (0 = unbounded, cold
    tier unused)."""

    def __init__(self, fleet, *, hot_capacity: int = 0,
                 warm_capacity: int = 0, policy: str = "lru",
                 spill_dir: str = "", journal=None, recorder=None,
                 capacity_source: str = "config") -> None:
        from ..plans import NullStore, current_store
        if policy not in POLICIES:
            raise ValueError(
                f"residency policy must be one of {POLICIES}, "
                f"got {policy!r}"
            )
        if hot_capacity < 0 or warm_capacity < 0:
            raise ValueError("residency capacities must be >= 0")
        self.fleet = fleet
        self.hot_capacity = int(hot_capacity)
        self.warm_capacity = int(warm_capacity)
        self.policy = policy
        self.plan = {"hot_tenants": {"value": self.hot_capacity,
                                     "source": capacity_source}}
        self._spill_dir = spill_dir
        self._journal = getattr(journal, "journal", journal)
        self._recorder = recorder
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._state: dict[str, _TenantState] = {}
        self._queue: deque = deque()
        self._queued: set = set()
        self._drainable: frozenset = frozenset()
        self._wakers: list = []
        self._pending_probe = None
        self._stop = False
        self.stats = _Stats()
        # The pager runs under its creator's plan store and Recorder,
        # handed over explicitly.
        self._plan_store = current_store() or NullStore()
        self._pager = threading.Thread(
            target=self._pager_main, name="oni-residency-pager",
            daemon=True,
        )
        self._pager.start()

    # -- wiring -------------------------------------------------------------

    def add_waker(self, fn) -> None:
        """Register a callback fired (with NO residency lock held) after
        every promotion/eviction — the FleetScorer parks its worker on
        "no drainable lane" and needs the nudge."""
        with self._lock:
            self._wakers.append(fn)

    def set_pending_probe(self, fn) -> None:
        """`fn(tenant) -> bool` — does the tenant have events queued
        right now?  Admission-aware eviction consults it so a tenant
        with an in-flight burst is not evicted while a quiescent
        candidate exists.  Heuristic read (no scorer lock taken)."""
        with self._lock:
            self._pending_probe = fn

    def register(self, tenant: str, *,
                 day_source: "tuple | None" = None) -> None:
        """Admit one published tenant to residency management.  The
        tenant starts in whatever tier the fleet has it (hot if it is
        stack-resident, else warm); with a hot capacity of 0 a warm
        registrant is promoted immediately (legacy all-hot residency).
        `day_source=(day_dir, fallback)` marks the tenant cold-eligible
        via day-directory reload; without it, cold demotion spills an
        npz checkpoint.  A warm census past capacity is demoted by the
        pager in the background — a thousand-tenant startup never
        blocks registration on spill IO."""
        hot = self.fleet.is_hot(tenant)
        # The day artifacts represent the version published FROM them:
        # a later refresh publish makes them stale, and cold demotion
        # must then spill the live model instead of trusting the dir.
        day_version = (self.fleet.version(tenant)
                       if day_source is not None else 0)
        over_warm = False
        with self._lock:
            if tenant in self._state:
                raise ValueError(f"tenant {tenant!r} already registered")
            self._state[tenant] = _TenantState(
                tenant=tenant,
                tier=TIER_HOT if hot else TIER_WARM,
                day_source=day_source,
                day_version=day_version,
            )
            self._refresh_drainable_locked()
            if self.warm_capacity > 0 and not hot:
                warm = sum(1 for st in self._state.values()
                           if st.tier == TIER_WARM)
                over_warm = warm > self.warm_capacity
        if not hot and self.hot_capacity == 0:
            # Unbounded hot tier: residency degrades to bookkeeping.
            self._request_locked_free(tenant)
        elif over_warm:
            self._post_enforce()
        self._emit_gauges()

    def _post_enforce(self) -> None:
        """Queue a warm-capacity sweep on the pager (None sentinel)."""
        with self._lock:
            if _ENFORCE not in self._queued:
                self._queued.add(_ENFORCE)
                self._queue.append(_ENFORCE)
                self._work.notify_all()

    # -- the admission signal ----------------------------------------------

    def note_admission(self, tenant: str) -> bool:
        """Touch the tenant (the LRU/LFU signal) and, when it is not
        HBM-hot, enqueue an async promotion (idempotent).  Returns
        whether the tenant is drainable right now."""
        now = time.monotonic_ns()
        with self._lock:
            st = self._state.get(tenant)
            if st is None:
                return True          # unmanaged tenant: legacy behavior
            st.touch_ns = now
            st.touches += 1
            if st.tier == TIER_HOT:
                return True
            st.waiters += 1
            if st.requested_ns is None:
                st.requested_ns = now
            if tenant not in self._queued:
                self._queued.add(tenant)
                self._queue.append(tenant)
                self._work.notify_all()
            return tenant in self._drainable

    def _request_locked_free(self, tenant: str) -> None:
        with self._lock:
            st = self._state[tenant]
            if st.requested_ns is None:
                st.requested_ns = time.monotonic_ns()
            if tenant not in self._queued:
                self._queued.add(tenant)
                self._queue.append(tenant)
                self._work.notify_all()

    def read_through(self, tenant: str):
        """A checkpoint-cold tenant's model WITHOUT a tier change: load
        the checkpoint and hand back a snapshot at the tenant's
        preserved version.  The scorer's solo fallback uses this when
        it must drain a cold tenant's lane NOW (close-time drain, or a
        demotion racing a flush) — the events score correctly against
        the exact unloaded model instead of failing, at the price of
        one checkpoint read."""
        from .registry import ModelSnapshot

        model, version, source, origin, load_ns = \
            self._read_checkpoint(tenant)
        with self._lock:
            self.stats.read_throughs += 1
        self._journal_safe({
            "kind": "residency_promote", "tenant": tenant, "ok": True,
            "tier_from": TIER_COLD, "tier_to": "read_through",
            "load_s": round(load_ns / 1e9, 6),
            "source": origin,
        })
        # Not a publish and not registered anywhere: published_at 0.0
        # marks it as a transient read-through snapshot.
        return ModelSnapshot(model=model, version=version,
                             source=source, published_at=0.0)

    def request_promotions(self, tenants) -> None:
        """Re-request promotion for tenants with STRANDED events: an
        event admitted while its tenant was hot orphans if the tenant
        is evicted before the drain — no later admission exists to
        re-trigger paging.  The scorer calls this for any pending,
        non-drainable lane before parking its worker.  Idempotent; does
        not count as an admission touch (a stranded retry must not
        make the victim look recently used)."""
        now = time.monotonic_ns()
        with self._lock:
            for tenant in tenants:
                st = self._state.get(tenant)
                if st is None or st.tier == TIER_HOT:
                    continue
                if st.requested_ns is None:
                    st.requested_ns = now
                if tenant not in self._queued:
                    self._queued.add(tenant)
                    self._queue.append(tenant)
                    self._work.notify_all()

    def ensure_hot(self, tenant: str, timeout: float = 30.0) -> None:
        """Synchronous promotion: request and wait until the tenant is
        HBM-hot (tests, warmup).  Raises on promotion failure or
        timeout."""
        deadline = time.monotonic() + timeout
        self._request_locked_free(tenant)
        with self._lock:
            while True:
                st = self._state[tenant]
                if st.tier == TIER_HOT:
                    return
                if st.error is not None:
                    raise RuntimeError(
                        f"promotion of {tenant!r} failed: {st.error}"
                    )
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"promotion of {tenant!r} did not complete in "
                        f"{timeout}s"
                    )
                self._work.wait(min(left, 0.25))

    @property
    def drainable(self) -> frozenset:
        """Tenants the scorer may flush right now: the HBM-hot set plus
        any tenant whose promotion FAILED (its lane drains through the
        solo fallback, failing tenant-scoped instead of wedging the
        queue).  Lock-free read of an immutable snapshot."""
        return self._drainable

    def is_managed(self, tenant: str) -> bool:
        """Whether this tenant is under residency management.  An
        unmanaged tenant keeps full legacy behavior — the scorer
        drains it unconditionally (dict-membership read, no lock: the
        GIL makes it atomic and registration is monotonic)."""
        return tenant in self._state

    def tier_of(self, tenant: str) -> str:
        with self._lock:
            return self._state[tenant].tier

    def tiers(self) -> dict:
        with self._lock:
            out = {TIER_HOT: 0, TIER_WARM: 0, TIER_COLD: 0}
            for st in self._state.values():
                out[st.tier] += 1
            return out

    def stats_snapshot(self) -> dict:
        with self._lock:
            s = self.stats
            tiers = {TIER_HOT: 0, TIER_WARM: 0, TIER_COLD: 0}
            for st in self._state.values():
                tiers[st.tier] += 1
            return {
                "policy": self.policy,
                "hot_capacity": self.hot_capacity,
                "warm_capacity": self.warm_capacity,
                "tiers": tiers,
                "promotions": s.promotions,
                "evictions": s.evictions,
                "cold_loads": s.cold_loads,
                "spills": s.spills,
                "read_throughs": s.read_throughs,
                "failures": s.failures,
                "promotion_stall_s": round(
                    s.promotion_stall_ns / 1e9, 6),
                "rebuild_s": round(s.rebuild_ns / 1e9, 6),
                "plan": dict(self.plan),
            }

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._stop = True
            self._work.notify_all()
        self._pager.join(timeout)

    # -- the pager ----------------------------------------------------------

    def _pager_main(self) -> None:
        import contextlib

        from ..plans import use_store
        from ..telemetry.spans import use_recorder

        with use_store(self._plan_store), (
                use_recorder(self._recorder) if self._recorder is not None
                else contextlib.nullcontext()):
            self._pager_loop()

    def _pager_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stop:
                    self._work.wait()
                if not self._queue:
                    return           # stop requested, queue drained
                tenant = self._queue.popleft()
            if tenant == _ENFORCE:
                with self._lock:
                    self._queued.discard(_ENFORCE)
                try:
                    self._enforce_warm_capacity()
                    self._emit_gauges()
                except Exception as e:
                    self._journal_safe({
                        "kind": "residency_evict", "tenant": None,
                        "ok": False, "error": repr(e)[:300],
                    })
                continue
            try:
                self._promote(tenant)
            except Exception as e:
                with self._lock:
                    st = self._state.get(tenant)
                    if st is not None:
                        st.error = repr(e)[:300]
                        st.requested_ns = None
                        st.waiters = 0
                    self._queued.discard(tenant)
                    self.stats.failures += 1
                    self._refresh_drainable_locked()
                    self._work.notify_all()
                self._journal_safe({
                    "kind": "residency_promote", "tenant": tenant,
                    "ok": False, "error": repr(e)[:300],
                })
            self._fire_wakers()

    def _promote(self, tenant: str) -> None:
        """One promotion, pager-thread only.  Cold tenants reload their
        checkpoint first (cold→warm), then the hot admission evicts a
        policy victim if the K-group is at capacity and flips both
        memberships in ONE stack rebuild — outside every lock the
        scoring path takes."""
        with self._lock:
            st = self._state[tenant]
            tier_from = st.tier
            self._queued.discard(tenant)
            if st.tier == TIER_HOT:
                st.requested_ns = None
                st.waiters = 0
                return
        if tier_from == TIER_COLD:
            self._load_cold(tenant)
        k = self.fleet.tenant_k(tenant)
        changes = {tenant: True}
        victims = []
        if self.hot_capacity > 0:
            census = [t for t in self.fleet.hot_census(k) if t != tenant]
            while len(census) + 1 > self.hot_capacity:
                victim = self._pick_victim(census)
                census.remove(victim)
                victims.append(victim)
                changes[victim] = False
        t0 = time.monotonic_ns()
        self.fleet.set_hot_many(changes)
        rebuild_ns = time.monotonic_ns() - t0
        now = time.monotonic_ns()
        with self._lock:
            st = self._state[tenant]
            stall_ns = (now - st.requested_ns) \
                if st.requested_ns is not None else 0
            waiters = st.waiters
            st.tier = TIER_HOT
            st.promotions += 1
            st.requested_ns = None
            st.waiters = 0
            st.error = None
            for v in victims:
                vs = self._state.get(v)
                if vs is not None:
                    vs.tier = TIER_WARM
                    vs.evictions += 1
            self.stats.promotions += 1
            self.stats.evictions += len(victims)
            self.stats.promotion_stall_ns += stall_ns
            self.stats.rebuild_ns += rebuild_ns
            self._refresh_drainable_locked()
            self._work.notify_all()
        tier = self.fleet.tier(k) or {}
        self._journal_safe({
            "kind": "residency_promote", "tenant": tenant, "ok": True,
            "tier_from": tier_from, "k": k,
            "stall_s": round(stall_ns / 1e9, 6),
            "rebuild_s": round(rebuild_ns / 1e9, 6),
            "waiters": waiters,
            "census": len(self.fleet.hot_census(k)),
            "capacity": tier.get("capacity"),
            "evicted": victims,
        })
        if self._recorder is not None:
            rec = self._recorder
            rec.counter("residency.promotions").add(1)
            rec.histogram("residency.promotion_stall_s").observe(
                stall_ns / 1e9)
            rec.histogram("residency.rebuild_s").observe(rebuild_ns / 1e9)
        for v in victims:
            self._journal_safe({
                "kind": "residency_evict", "tenant": v,
                "tier_to": TIER_WARM, "k": k, "policy": self.policy,
                "for_tenant": tenant,
            })
            if self._recorder is not None:
                self._recorder.counter("residency.evictions").add(1)
        self._enforce_warm_capacity()
        self._emit_gauges()

    def _pick_victim(self, census: "list[str]") -> str:
        """Admission-aware LRU/LFU: among the K-group's hot members,
        prefer tenants with NO events currently queued; order the
        preferred pool least-recently-admitted (lru) or
        least-admitted-overall with recency tiebreak (lfu).  Unmanaged
        tenants (registered with the fleet but not with residency) are
        never evicted."""
        with self._lock:
            probe = self._pending_probe
            managed = [t for t in census if t in self._state]
            if not managed:
                raise RuntimeError(
                    "hot K-group is at capacity but holds no "
                    "residency-managed tenant to evict"
                )
            quiescent = managed
            if probe is not None:
                idle = [t for t in managed if not probe(t)]
                if idle:
                    quiescent = idle

            def key(t):
                st = self._state[t]
                if self.policy == "lfu":
                    return (st.touches, st.touch_ns)
                return (st.touch_ns,)

            return min(quiescent, key=key)

    # -- cold tier ----------------------------------------------------------

    def _read_checkpoint(self, tenant: str):
        """THE cold-tier read, shared by the pager's cold→warm leg and
        the scorer's read-through: returns (model, version, source,
        origin, load_ns).  Reloads from the day dir only when this cold
        period did NOT spill (a refresh publish makes the day artifacts
        stale — `_demote_cold` then spills the live model and marks
        `cold_spilled`, and the reload must honor that)."""
        with self._lock:
            st = self._state[tenant]
            day_source = st.day_source
            spill_path = st.spill_path
            use_spill = st.cold_spilled or day_source is None
            version, source = st.cold_version, st.cold_source
        t0 = time.monotonic_ns()
        if not use_spill and day_source is not None:
            day_dir, fallback = day_source
            model = ScoringModel.from_files(
                os.path.join(day_dir, "doc_results.csv"),
                os.path.join(day_dir, "word_results.csv"),
                fallback,
            )
            origin = "day_dir"
        elif spill_path is not None:
            model = load_spill(spill_path)
            origin = "spill"
        else:
            raise RuntimeError(
                f"tenant {tenant!r} is cold with no checkpoint source"
            )
        return model, version, source, origin, time.monotonic_ns() - t0

    def _load_cold(self, tenant: str) -> None:
        """cold→warm: reload the checkpoint and reinstall it at the
        ORIGINAL version (registry restore, not publish).  If a publish
        raced the cold period (a RefreshLoop firing off a read-through
        drain), the registry already holds a NEWER model — adopt it
        instead of restoring over it."""
        if self.fleet.loaded(tenant):
            with self._lock:
                st = self._state[tenant]
                st.tier = TIER_WARM
            self._journal_safe({
                "kind": "residency_promote", "tenant": tenant,
                "ok": True, "tier_from": TIER_COLD,
                "tier_to": TIER_WARM, "source": "published",
            })
            return
        model, version, source, origin, load_ns = \
            self._read_checkpoint(tenant)
        self.fleet.restore_tenant(tenant, model, source, version)
        with self._lock:
            st = self._state[tenant]
            st.tier = TIER_WARM
            self.stats.cold_loads += 1
        self._journal_safe({
            "kind": "residency_promote", "tenant": tenant, "ok": True,
            "tier_from": TIER_COLD, "tier_to": TIER_WARM,
            "load_s": round(load_ns / 1e9, 6),
            "source": origin,
        })
        if self._recorder is not None:
            self._recorder.histogram("residency.cold_load_s").observe(
                load_ns / 1e9)

    def _enforce_warm_capacity(self) -> None:
        """Demote the policy-coldest warm tenants to checkpoint-cold
        until the warm census fits.  Pager-thread only."""
        if self.warm_capacity <= 0:
            return
        while True:
            with self._lock:
                warm_names = [st.tenant for st in self._state.values()
                              if st.tier == TIER_WARM]
            # Eligibility check OUTSIDE the manager lock (fleet.loaded
            # takes registry locks): a registered-but-never-published
            # tenant has nothing to unload and must not be re-picked
            # forever.
            eligible = [t for t in warm_names if self.fleet.loaded(t)]
            with self._lock:
                warm = [self._state[t] for t in eligible
                        if self._state[t].tier == TIER_WARM]
                over = len([st for st in self._state.values()
                            if st.tier == TIER_WARM]) \
                    - self.warm_capacity
                if over <= 0 or not warm:
                    return

                def key(st):
                    if self.policy == "lfu":
                        return (st.touches, st.touch_ns)
                    return (st.touch_ns,)

                victim = min(warm, key=key).tenant
            self._demote_cold(victim)

    def _demote_cold(self, tenant: str) -> None:
        snap = self.fleet.unload_tenant(tenant)
        if snap is None:
            return
        with self._lock:
            st = self._state[tenant]
            st.cold_version = snap.version
            st.cold_source = snap.source
            # The day artifacts ARE the model only at the version they
            # published; after a refresh the live snapshot must spill,
            # or a cold reload would silently resurrect the
            # pre-refresh model under the post-refresh version.
            spill = st.day_source is None \
                or snap.version != st.day_version
            st.cold_spilled = spill
        spill_bytes = None
        if spill:
            path = os.path.join(self._spill_root(), f"{tenant}.npz")
            spill_bytes = spill_model(path, snap.model)
            with self._lock:
                self._state[tenant].spill_path = path
                self.stats.spills += 1
        with self._lock:
            self._state[tenant].tier = TIER_COLD
            self.stats.evictions += 1
        self._journal_safe({
            "kind": "residency_evict", "tenant": tenant,
            "tier_to": TIER_COLD, "policy": self.policy,
            "version": snap.version,
            "spill_bytes": spill_bytes,
        })
        if self._recorder is not None:
            self._recorder.counter("residency.evictions").add(1)
        self._emit_gauges()

    def _spill_root(self) -> str:
        with self._lock:
            if not self._spill_dir:
                self._spill_dir = tempfile.mkdtemp(
                    prefix="oni_residency_")
            os.makedirs(self._spill_dir, exist_ok=True)
            return self._spill_dir

    # -- internals ----------------------------------------------------------

    def _refresh_drainable_locked(self) -> None:
        """Caller holds self._lock."""
        self._drainable = frozenset(
            t for t, st in self._state.items()
            if st.tier == TIER_HOT or st.error is not None
        )

    def _fire_wakers(self) -> None:
        with self._lock:
            wakers = list(self._wakers)
        for fn in wakers:
            try:
                fn()
            except Exception as e:
                import sys

                print(f"residency waker failed: {e!r}", file=sys.stderr)

    def _emit_gauges(self) -> None:
        if self._recorder is None:
            return
        with self._lock:
            tiers = {TIER_HOT: 0, TIER_WARM: 0, TIER_COLD: 0}
            for st in self._state.values():
                tiers[st.tier] += 1
        for tier, n in tiers.items():
            self._recorder.gauge(f"residency.{tier}", n)

    def _journal_safe(self, record: dict) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(record)
        except Exception as e:
            import sys

            print(f"residency journal append failed: {e!r}",
                  file=sys.stderr)
