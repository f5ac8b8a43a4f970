"""The process group of a multi-process run (the part of
oni_ml_tpu/parallel/mesh.py ported so far: `initialize_distributed`).

A multi-process run is N rank processes, each with its own device (one
CUDA context each; on a machine with one card they share it).  They
find each other through torchrun's standard environment:

    MASTER_ADDR, MASTER_PORT   the rendezvous store (rank 0 hosts a
                               torch.distributed.TCPStore there, unless
                               torchrun's agent already does:
                               TORCHELASTIC_USE_AGENT_STORE=True)
    WORLD_SIZE, RANK           the world and this process's place in it
    LOCAL_RANK                 which card: cuda:(LOCAL_RANK mod the
                               cards this process sees); cuda:0 without it

where the JAX package reads JAX_COORDINATOR_ADDRESS and friends.  The
store is the collectives' KV control plane (`kv_client`, through
`StoreKVClient`) and the kvring transport's bulk plane; a
torch.distributed process group (NCCL on the card, gloo on the CPU) is
made only when a collective names the psum transport (`process_group`).

The mesh half of the JAX module (`make_mesh`, `local_mesh` and the
shardings of a single-process device mesh) is not ported yet.
"""

from __future__ import annotations

import datetime
import os
import time

_STATE = {"rank": 0, "world": 1, "device": "cuda", "store": None,
          "client": None, "pg": None, "joined": False}

# Rendezvous bound: how long rank 0's store waits for the others to
# connect, and each rank for the store to answer.
RENDEZVOUS_TIMEOUT_S = 300.0


class StoreKVClient:
    """The collectives' KV surface (`key_value_set`,
    `blocking_key_value_get` with DEADLINE_EXCEEDED, `key_value_delete`)
    over a torch.distributed store.  A blocking get polls the store's
    non-blocking `check` with a back-off from 0.2 ms to 5 ms (a store
    `wait` that times out logs a warning per slice)."""

    _POLL_MIN_S = 0.0002
    _POLL_MAX_S = 0.005

    def __init__(self, store) -> None:
        self._store = store

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        if not allow_overwrite and self._store.check([key]):
            raise RuntimeError(f"ALREADY_EXISTS: {key}")
        self._store.set(key, value.encode("utf-8"))

    def blocking_key_value_get(self, key: str, timeout_in_ms: int) -> str:
        deadline = time.monotonic() + timeout_in_ms / 1000.0
        pause = self._POLL_MIN_S
        while not self._store.check([key]):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(f"DEADLINE_EXCEEDED: {key}")
            time.sleep(min(pause, remaining))
            pause = min(pause * 2, self._POLL_MAX_S)
        return self._store.get(key).decode("utf-8")

    def key_value_delete(self, key: str) -> None:
        self._store.delete_key(key)


def _env_int(name: str, value, default: "int | None" = None) -> int:
    if value is not None:
        return int(value)
    raw = os.environ.get(name, "")
    if raw:
        return int(raw)
    if default is None:
        raise ValueError(f"a multi-process run needs {name} (torchrun's "
                         "environment) or the matching argument")
    return default


def initialize_distributed(master_addr: "str | None" = None,
                           master_port: "int | None" = None,
                           world_size: "int | None" = None,
                           rank: "int | None" = None, *,
                           device: str = "cuda") -> dict:
    """Join the run's process group: call once per process, before any
    collective.  Arguments override torchrun's variables (see the module
    doc).  `device` is what the run trains on: "cuda" sets this
    process's card from LOCAL_RANK; "cpu" runs on the host.  A
    one-process world needs no rendezvous.  Returns {"rank", "world",
    "device"}."""
    import torch

    world = _env_int("WORLD_SIZE", world_size, 1)
    me = _env_int("RANK", rank, 0)
    if world < 1 or not 0 <= me < world:
        raise ValueError(f"rank {me} is outside a world of {world}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (--device cpu) to run on the "
                               "CPU")
        local = int(os.environ.get("LOCAL_RANK", "0") or 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    store = client = None
    if world > 1:
        import torch.distributed as dist

        addr = master_addr or os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = _env_int("MASTER_PORT", master_port)
        agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
        base = dist.TCPStore(
            addr, port, world, is_master=(me == 0 and not agent),
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        store = dist.PrefixStore("oni_ml_tpu_torch", base)
        client = StoreKVClient(store)
    _STATE.update(rank=me, world=world, device=device, store=store,
                  client=client, pg=None, joined=True)
    return {"rank": me, "world": world, "device": device}


def joined() -> bool:
    """Whether this process joined a process group (even a one-rank
    world): the trainers then train distributed by default, so a
    one-rank run writes what a many-rank run does."""
    return _STATE["joined"]


def process_index() -> int:
    """This process's rank (0 before initialize_distributed)."""
    return _STATE["rank"]


def process_count() -> int:
    """The world's size (1 before initialize_distributed)."""
    return _STATE["world"]


def is_coordinator() -> bool:
    """Rank 0: the one writer of a multi-process run's shared files."""
    return _STATE["rank"] == 0


def run_device() -> str:
    """The device initialize_distributed was given ("cuda" before)."""
    return _STATE["device"]


def kv_client():
    """The rendezvous store's KV client (None in a one-process world)."""
    return _STATE["client"]


def process_group(device: str, timeout_s: float = 600.0):
    """The world's torch.distributed process group, made at first use:
    NCCL for "cuda", gloo for "cpu", over the rendezvous store (a
    one-process world gets a private store); its ops time out after
    `timeout_s`."""
    import torch.distributed as dist

    if _STATE["pg"] is None:
        backend = "nccl" if device == "cuda" else "gloo"
        if dist.is_initialized():
            if dist.get_backend() != backend:
                raise RuntimeError(
                    f"torch.distributed is already initialized on "
                    f"{dist.get_backend()}, not {backend}")
        else:
            store = _STATE["store"]
            if store is None:
                store = dist.HashStore()
            else:
                store = dist.PrefixStore("pg", store)
            dist.init_process_group(
                backend, store=store, rank=_STATE["rank"],
                world_size=_STATE["world"],
                timeout=datetime.timedelta(seconds=timeout_s))
        _STATE["pg"] = dist.group.WORLD
    return _STATE["pg"]


def shutdown_distributed(timeout_s: "float | None" = None) -> None:
    """Leave the process group and return to a one-process world.  Rank 0
    hosts the store, so it waits (at most `timeout_s`, default the
    collective's ONI_ML_TPU_ALLREDUCE_TIMEOUT_S or 60 s) until every
    other rank has said it is leaving: a rank still reading its last
    ring message must not lose the store under it.  Destroys a
    torch.distributed group this module made, and forgets the
    process-wide collective."""
    import torch.distributed as dist

    from .allreduce import reset_collective

    if timeout_s is None:
        timeout_s = float(os.environ.get("ONI_ML_TPU_ALLREDUCE_TIMEOUT_S")
                          or 60.0)

    client = _STATE["client"]
    if client is not None:
        try:
            client.key_value_set(f"exit/{_STATE['rank']}", "1",
                                 allow_overwrite=True)
            if _STATE["rank"] == 0:
                for r in range(1, _STATE["world"]):
                    client.blocking_key_value_get(
                        f"exit/{r}", int(timeout_s * 1000))
        except Exception:
            pass     # a peer already gone: nothing left to wait for
    if _STATE["pg"] is not None and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(rank=0, world=1, device="cuda", store=None, client=None,
                  pg=None, joined=False)
    reset_collective()
