"""Deterministic document shard plans for distributed EM (port of
oni_ml_tpu/parallel/shard_plan.py: the same plans, pinned to it by
tests/test_torch_allreduce.py).

The reference's entire reason for MPI was splitting the corpus across
nodes (README.md:121: 20 ranks, one contiguous document block each).
This module is that split made explicit and *rank-count invariant*: a
plan is derived from the corpus alone — a fixed number of contiguous
document shards (power of two, default 8) that does NOT change with the
process count — and processes own contiguous, aligned runs of shards.

Why the shard count is corpus-derived rather than ``num_shards ==
num_procs``: the cross-shard sufficient-statistics reduction
(parallel/allreduce.py ``tree_combine``) is a fixed pairwise tree over
the *shard* axis.  Because the shards and the tree are identical no
matter how many processes execute them, a 2-rank run reduces the exact
same f32 partials in the exact same association order as a 1-rank run —
which is what makes the coordinator's artifacts byte-identical across
rank counts (tests/test_torch_multihost.py).  Per-shard E-step results
are themselves bitwise reproducible: each shard is bucketed and batched
independently, so its kernel launches and inputs do not depend on which
rank runs it.

Alignment: when ``num_procs`` divides ``num_shards`` and both are powers
of two, every rank's contiguous shard run is a node of the canonical
reduction tree, so ranks exchange ONE subtree root each; otherwise they
exchange per-shard partials (correct, more bytes — ``aligned`` tells the
reducer which).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# Default shard count: a power of two small enough that the per-shard
# batching overhead is negligible and large enough to cover the rank
# counts a CPU-process or small-pod run plausibly uses (1/2/4/8 all
# divide it, keeping the subtree-root exchange aligned).
DEFAULT_EM_SHARDS = 8


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def resolve_em_shards(config_value: int = 0, num_procs: int = 1) -> int:
    """The run's shard count: an explicit LDAConfig.em_shards (or
    ONI_ML_TPU_EM_SHARDS env) wins; 0 = auto — DEFAULT_EM_SHARDS, grown
    to the next power of two >= num_procs when more processes than
    default shards show up.  Byte-identity across rank counts holds
    exactly when the two runs resolve the SAME shard count — which auto
    guarantees for any rank counts <= DEFAULT_EM_SHARDS."""
    env = os.environ.get("ONI_ML_TPU_EM_SHARDS", "")
    if env:
        config_value = int(env)
    if config_value:
        if config_value < num_procs:
            raise ValueError(
                f"em_shards={config_value} < {num_procs} processes: every "
                "process must own at least one document shard"
            )
        return int(config_value)
    return max(DEFAULT_EM_SHARDS, _next_pow2(num_procs))


@dataclass(frozen=True)
class ShardPlan:
    """Contiguous document shards + their rank assignment.

    bounds[s] = (start, stop) document range of shard s; the bounds
    partition range(num_docs) in order.  owners[s] is the rank that
    computes shard s this run — the only field that depends on the
    process count; the bounds (and therefore every per-shard
    computation and the reduction tree) do not.
    """

    num_docs: int
    num_procs: int
    bounds: tuple          # tuple[(start, stop), ...]
    owners: tuple          # tuple[int, ...] — shard -> rank

    @property
    def num_shards(self) -> int:
        return len(self.bounds)

    @property
    def aligned(self) -> bool:
        """True when every rank's shard run is a node of the canonical
        pairwise reduction tree (equal contiguous runs, powers of two)
        — the reducer then exchanges one subtree root per rank instead
        of per-shard partials."""
        s, p = self.num_shards, self.num_procs
        return _is_pow2(s) and _is_pow2(p) and s % p == 0

    def owned(self, rank: int) -> list:
        """Shard indices rank computes, in shard order."""
        return [s for s, o in enumerate(self.owners) if o == rank]

    def record(self, rank: int) -> dict:
        """Journal form ({"kind": "shard_plan"} payload) — enough to
        reconstruct the exact split a run trained under post-hoc."""
        owned = self.owned(rank)
        return {
            "kind": "shard_plan",
            "num_docs": self.num_docs,
            "num_procs": self.num_procs,
            "num_shards": self.num_shards,
            "bounds": [list(b) for b in self.bounds],
            "rank": rank,
            "owned_shards": owned,
            "local_docs": sum(
                self.bounds[s][1] - self.bounds[s][0] for s in owned
            ),
            "aligned": self.aligned,
        }


def plan_shards(num_docs: int, num_procs: int = 1,
                num_shards: int = 0) -> ShardPlan:
    """Build the deterministic plan: `num_shards` contiguous document
    shards (sizes differing by at most one, larger shards first) owned
    by `num_procs` ranks in contiguous runs (shard runs per rank also
    differ by at most one).  Pure arithmetic — identical on every rank
    and across rank counts for the same (num_docs, num_shards)."""
    if num_docs < 0:
        raise ValueError(f"num_docs must be >= 0, got {num_docs}")
    if num_procs < 1:
        raise ValueError(f"num_procs must be >= 1, got {num_procs}")
    s = num_shards or resolve_em_shards(0, num_procs)
    if s < num_procs:
        raise ValueError(
            f"{s} shards cannot cover {num_procs} processes"
        )
    base, rem = divmod(num_docs, s)
    bounds = []
    start = 0
    for i in range(s):
        n = base + (1 if i < rem else 0)
        bounds.append((start, start + n))
        start += n
    pb, prem = divmod(s, num_procs)
    owners = []
    for r in range(num_procs):
        owners.extend([r] * (pb + (1 if r < prem else 0)))
    return ShardPlan(
        num_docs=num_docs, num_procs=num_procs,
        bounds=tuple(bounds), owners=tuple(owners),
    )
