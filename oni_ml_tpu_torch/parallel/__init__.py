"""Cross-process coordination for the port (the part of
oni_ml_tpu/parallel ported so far): the replicated serving fleet's
membership over the file KV or the TCP KV (parallel/membership.py).
The multi-GPU EM modules (mesh, collectives, sharded E-steps) wait for
ROADMAP Queue 1 item 6."""

from .membership import (
    FileKVClient,
    HeartbeatPublisher,
    KVServer,
    MembershipClient,
    TcpKVClient,
    kv_list,
)

__all__ = [
    "FileKVClient",
    "HeartbeatPublisher",
    "KVServer",
    "MembershipClient",
    "TcpKVClient",
    "kv_list",
]
