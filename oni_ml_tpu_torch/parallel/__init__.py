"""Cross-process coordination for the port (the part of
oni_ml_tpu/parallel ported so far): the replicated serving fleet's
membership over the file KV or the TCP KV (parallel/membership.py), and
multi-process distributed EM: the process group (mesh.py's
`initialize_distributed`), the shard plan, the collective and the
rank-synchronized capacity tiers.  The single-process device mesh
(`--mesh`, `make_mesh`, `local_mesh`, sharded.py) waits for ROADMAP
Queue 1 item 6's mesh half."""

from .allreduce import (
    Collective,
    PeerFailure,
    get_collective,
    reduce_partials,
    tree_combine,
)
from .membership import (
    FileKVClient,
    HeartbeatPublisher,
    KVServer,
    MembershipClient,
    TcpKVClient,
    kv_list,
)
from .mesh import (
    StoreKVClient,
    initialize_distributed,
    is_coordinator,
    joined,
    process_count,
    process_index,
    shutdown_distributed,
)
from .shard_plan import ShardPlan, plan_shards, resolve_em_shards
from .tiers import sync_capacity_tier

__all__ = [
    "Collective",
    "FileKVClient",
    "HeartbeatPublisher",
    "KVServer",
    "MembershipClient",
    "PeerFailure",
    "ShardPlan",
    "StoreKVClient",
    "TcpKVClient",
    "get_collective",
    "initialize_distributed",
    "is_coordinator",
    "joined",
    "kv_list",
    "plan_shards",
    "process_count",
    "process_index",
    "reduce_partials",
    "resolve_em_shards",
    "shutdown_distributed",
    "sync_capacity_tier",
    "tree_combine",
]
