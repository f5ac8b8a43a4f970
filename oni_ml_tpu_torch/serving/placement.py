"""Consistent-hash tenant placement for the replicated serving fleet
(port of oni_ml_tpu/serving/placement.py; the same function, so the
port and the JAX package place every census identically).

One serve process is one blast radius: the replicated fleet runs N
replicas behind a router, which needs a placement function answering
"which replica owns tenant t?" with four properties the router (and the
chaos tests) lean on:

1. **Deterministic across processes.**  Placement is a pure function of
   (tenant set, replica set) built on ``hashlib.blake2b`` — never
   Python's per-process-salted ``hash()`` — so the router, every
   replica, and a postmortem debugger all compute the identical ring
   from the membership snapshot, with no coordination round.

2. **Balanced by construction.**  Highest-random-weight (rendezvous)
   preference alone leaves multinomial fluctuation (a 256-tenant /
   4-replica census routinely puts ~72 tenants on the worst replica
   against a 64 mean).  Placement therefore walks each tenant's HRW
   preference order under a hard capacity ``ceil(T / N)`` — no replica
   ever owns more than its fair ceiling, which is also what turns the
   failover bound ("a dead replica's tenants all move") into the
   minimal-movement bound below.

3. **Minimal movement on ring change.**  A tenant considers replicas
   in a preference order keyed by ``hash(tenant, replica)`` — adding or
   removing a replica perturbs only the positions where that replica
   appears, so a membership change moves about ``T/N`` tenants instead
   of rehashing the world.  Assignment is two-phase to keep the
   balancing pass from amplifying that: every tenant first lands on
   its HRW argmax, then only the *overflow* beyond each replica's
   ``ceil(T/N)`` ceiling rebalances (weakest-preference members bump
   first, in canonical order) — a join perturbs one argmax set plus
   the shrunken overflow, not the whole capacity tiling.  The property
   tests pin ``<= ceil(T/N)`` moved primaries across join/leave in the
   fleet regime (tenants-per-replica >= ~16, such as 256-tenant
   censuses), and zero movement on a no-op recompute.

4. **Primary != shadow.**  Every tenant gets a shadow replica — the
   warm standby that promotes on BackendLost — chosen further down the
   same preference order, never equal to the primary (requires >= 2
   replicas; with one replica the shadow is None and failover is
   impossible, which the router surfaces rather than hides).

The router treats this module as the *initial* and *join-time*
assignment; on failover it deliberately does NOT recompute from
scratch — the shadow promotes in place (zero model movement at the
worst possible moment) and only the vacated shadow slots are refilled
through ``shadow_for``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


def stable_hash(*parts: str) -> int:
    """64-bit digest of the joined parts — deterministic across
    processes and Python versions (unlike builtin ``hash``, which is
    salted per process and would scatter every replica's view of the
    ring)."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(p.encode("utf-8"))
        h.update(b"\x1f")
    return int.from_bytes(h.digest(), "big")


@dataclass(frozen=True)
class Placement:
    """One tenant's assignment: the replica that scores its traffic and
    the warm standby that promotes when the primary is lost."""

    primary: str
    shadow: "str | None"


def preference(tenant: str, replicas: "list[str]") -> "list[str]":
    """The tenant's full HRW preference order over ``replicas``:
    descending ``stable_hash(tenant, replica)``, ties broken by replica
    id.  A replica joining or leaving inserts/deletes one element and
    leaves the relative order of all others unchanged — the property
    minimal movement rides on."""
    return sorted(
        replicas,
        key=lambda r: (-stable_hash("place", tenant, r), r),
    )


def _cap(n_tenants: int, n_replicas: int) -> int:
    return -(-n_tenants // n_replicas) if n_replicas else 0


def place(tenants, replicas, *, shadows: bool = True
          ) -> "dict[str, Placement]":
    """Assign every tenant a primary (and shadow) replica.

    Pure function of the two sets.  Phase 1 puts every tenant on its
    HRW argmax replica.  Phase 2 enforces the ``ceil(T/N)`` ceiling:
    each over-full replica keeps the ``cap`` tenants that score it
    highest and releases the rest, and the released tenants — in a
    canonical hash-derived order (NOT sorted-id order: adjacent ids
    must not get adjacent capacity decisions) — walk their preference
    to the first replica with room.  Shadows then walk the same
    preference past the primary under their own ``ceil(T/N)`` bound
    (falling back to the least-loaded non-primary when every preferred
    one is full, so a shadow always exists when N >= 2)."""
    tenants = list(tenants)
    replicas = sorted(set(replicas))
    if not replicas:
        raise ValueError("placement needs at least one replica")
    if len(set(tenants)) != len(tenants):
        raise ValueError("duplicate tenant ids in placement census")
    cap = _cap(len(tenants), len(replicas))
    prefs = {t: preference(t, replicas) for t in tenants}
    groups: "dict[str, list]" = {r: [] for r in replicas}
    for t in tenants:
        groups[prefs[t][0]].append(t)
    primary: "dict[str, str]" = {}
    primary_load = {r: 0 for r in replicas}
    overflow: "list[str]" = []
    for r in replicas:
        g = sorted(groups[r],
                   key=lambda t: (-stable_hash("place", t, r), t))
        for t in g[:cap]:
            primary[t] = r
        overflow.extend(g[cap:])
        primary_load[r] = min(len(g), cap)
    overflow.sort(key=lambda t: (stable_hash("order", t), t))
    for t in overflow:
        r = next(r for r in prefs[t] if primary_load[r] < cap)
        primary[t] = r
        primary_load[r] += 1
    shadow_load = {r: 0 for r in replicas}
    out: "dict[str, Placement]" = {}
    order = sorted(tenants, key=lambda t: (stable_hash("order", t), t))
    for t in order:
        shadow = None
        if shadows and len(replicas) > 1:
            shadow = next(
                (r for r in prefs[t]
                 if r != primary[t] and shadow_load[r] < cap),
                None,
            )
            if shadow is None:
                shadow = min(
                    (r for r in replicas if r != primary[t]),
                    key=lambda r: (shadow_load[r], r),
                )
            shadow_load[shadow] += 1
        out[t] = Placement(primary=primary[t], shadow=shadow)
    return {t: out[t] for t in tenants}


def shadow_for(tenant: str, replicas, *, exclude=()) -> "str | None":
    """The replacement-shadow pick after a failover or drain vacated a
    tenant's standby slot: the tenant's most-preferred surviving
    replica outside ``exclude`` (its promoted primary, the dead
    replica).  Stateless and deterministic, so the router and any
    observer agree on the refill without a placement-wide recompute —
    failover must not shuffle tenants that never touched the dead
    replica."""
    pref = preference(tenant, sorted(set(replicas)))
    for r in pref:
        if r not in exclude:
            return r
    return None


def moved_primaries(old: "dict[str, Placement]",
                    new: "dict[str, Placement]") -> "list[str]":
    """Tenants whose primary changed between two placements — the
    movement metric the minimal-movement property tests bound."""
    return sorted(
        t for t in old
        if t in new and old[t].primary != new[t].primary
    )


def load_by_replica(placement: "dict[str, Placement]"
                    ) -> "dict[str, int]":
    """Primary tenant count per replica (balance assertions)."""
    out: "dict[str, int]" = {}
    for p in placement.values():
        out[p.primary] = out.get(p.primary, 0) + 1
    return out
