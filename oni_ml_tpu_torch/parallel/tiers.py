"""Rank-synchronized vocabulary capacity tiers for distributed window
training (port of oni_ml_tpu/parallel/tiers.py).

The continuous window (dataplane/window.py) pads its vocabulary to
power-of-two capacity tiers.  In a distributed refresh each rank grows
its vocabulary from the slices it ingested, so two ranks could sit in
different tiers, while the EM driver's allreduce ships [V, K]
sufficient statistics whose layout every rank must share and the
parity check wants bit-identical models.  A rank-divergent tier is a
correctness failure, not a speed one.

`sync_capacity_tier` closes it: every rank contributes its local
requirement, the maximum wins, and every rank reserves that tier in its
window (`CorpusWindow.reserve_capacity`) before the snapshot.  Tiers
only grow while a service runs, so a slow rank can only pull the others
up a tier, never bounce them.
"""

from __future__ import annotations


def sync_capacity_tier(collective, local_vocab: int, floor: int, *,
                       tag: str, journal=None) -> int:
    """Agree on one pow2 vocabulary capacity tier across all ranks.

    Returns the agreed capacity (the local one in a single process).
    Journals `{"kind": "tier_sync"}` when the sync raised this rank's
    tier."""
    from ..dataplane.window import pow2_capacity

    local = pow2_capacity(int(local_vocab), int(floor))
    if collective is None or collective.num_processes == 1:
        return local
    tiers = collective.allgather_obj(local, tag)
    agreed = max(int(t) for t in tiers)
    if agreed != local and journal is not None:
        journal = getattr(journal, "journal", journal)
        try:
            journal.append({
                "kind": "tier_sync", "tag": tag, "local": local,
                "agreed": agreed, "rank": collective.rank,
                "nprocs": collective.num_processes,
            })
        except Exception:
            pass     # telemetry must never take down the service
    return agreed
