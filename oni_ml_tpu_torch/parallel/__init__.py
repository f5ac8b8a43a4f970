"""Scale-out for the port (port of oni_ml_tpu/parallel): the
single-process device mesh (mesh.py's `make_mesh`, `local_mesh`,
`is_local_mesh`, `mesh_from_spec` and the placement helpers; sharded.py's
data-parallel and vocab-sharded E/M steps and the sharded scorer;
`--mesh DATA,MODEL`), the replicated serving fleet's membership over the
file KV or the TCP KV (parallel/membership.py), and multi-process
distributed EM: the process group (mesh.py's `initialize_distributed`),
the shard plan, the collective and the rank-synchronized capacity
tiers.  A multi-process run composes the two: a host-local mesh within
each rank, the collective across ranks."""

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
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Sharded,
    StoreKVClient,
    batch_sharding,
    beta_sharding,
    initialize_distributed,
    is_coordinator,
    is_local_mesh,
    joined,
    local_mesh,
    make_mesh,
    mesh_from_spec,
    process_count,
    process_index,
    replicated,
    shutdown_distributed,
    stacked_batch_sharding,
    vocab_sharding,
)
from .shard_plan import ShardPlan, plan_shards, resolve_em_shards
from .sharded import (
    make_data_parallel_dense_e_step,
    make_data_parallel_e_step,
    make_sharded_score_fn,
    make_vocab_sharded_dense_e_step,
    make_vocab_sharded_fns,
    pad_vocab,
)
from .tiers import sync_capacity_tier

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "Sharded",
    "batch_sharding",
    "beta_sharding",
    "is_local_mesh",
    "local_mesh",
    "make_data_parallel_dense_e_step",
    "make_data_parallel_e_step",
    "make_mesh",
    "make_sharded_score_fn",
    "make_vocab_sharded_dense_e_step",
    "make_vocab_sharded_fns",
    "mesh_from_spec",
    "pad_vocab",
    "replicated",
    "stacked_batch_sharding",
    "vocab_sharding",
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
