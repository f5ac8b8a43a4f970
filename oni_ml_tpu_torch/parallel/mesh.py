"""The device mesh of one process and the process group of a
multi-process run (port of oni_ml_tpu/parallel/mesh.py).

The mesh.  A `Mesh` is a (data, model) grid of slots, each bound to one
torch.device, with the JAX package's axis names (`DATA_AXIS`,
`MODEL_AXIS`): documents shard over `data`, the vocabulary of beta and
the suff-stats over `model` (BASELINE.json config 4's huge-V DNS
vocabulary).  Where JAX runs one `shard_map` body per device, the port
runs the body once per slot from this process, in slot order
(parallel/sharded.py); a psum is a sum over one axis's slots in a fixed
order (`psum`: the partials moved to the group's first slot's device and
combined by allreduce.tree_combine's pairwise tree), and a pmax a max in
the same order, so two runs of one mesh write the same bytes.  A
tensor placed over the mesh (`Sharded`, made by the placement helpers
that stand for the JAX shardings: `batch_sharding`,
`stacked_batch_sharding`, `replicated`, `vocab_sharding`,
`beta_sharding`) holds each slot's piece on that slot's device; the
trainers place a fit's batches once, before EM starts.

`make_mesh(devices=None)` takes the cards this process sees, one slot
each; an explicit `devices=` list may repeat a device (the counterpart
of XLA's virtual host devices, on which the JAX suite runs its
eight-device mesh).  On the CPU (`device="cpu"`) every slot binds to the
one CPU device.  A mesh built for `cuda` never binds a CPU slot.

The process group.  A multi-process run is N rank processes, each with
its own device (one CUDA context each; on a machine with one card they
share it).  They find each other through torchrun's standard
environment:

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
A rank's local mesh (`local_mesh`) spans the cards that rank owns.
"""

from __future__ import annotations

import datetime
import os
import time
import warnings

import numpy as np

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


# ---------------------------------------------------------------------------
# The device mesh
# ---------------------------------------------------------------------------

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (data, model) grid of slots, each bound to a torch.device.

    `shape` maps each axis name to its size, as a JAX Mesh's does;
    `devices` is the [data, model] object array of the slots' devices.
    `launches` counts, per kernel, the launches each slot made inside
    the sharded E-steps (parallel/sharded.py), keyed by slot index
    i * model + j: a run reads whether a kernel ran on every slot."""

    def __init__(self, devices, axis_names=(DATA_AXIS, MODEL_AXIS)):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = _as_device(dev)
        if grid.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of devices, got shape "
                             f"{grid.shape}")
        types = {d.type for d in grid.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh binds one kind of device, got "
                             f"{sorted(types)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: grid.shape[0],
                      self.axis_names[1]: grid.shape[1]}
        self.launches: "dict[str, list[int]]" = {}

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def device(self, i: int, j: int = 0):
        """Slot (i, j)'s device."""
        return self.devices[i, j]

    @property
    def primary(self):
        """Slot (0, 0)'s device: where psums land and the replicated
        model state lives."""
        return self.devices[0, 0]

    def unique_devices(self) -> list:
        """The distinct devices of the mesh, in slot order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def count_launches(self, before: dict, after: dict, i: int,
                       j: int = 0) -> None:
        """Attribute the kernel launches between two counts to slot
        (i, j)."""
        n = self.devices.size
        for name, count in after.items():
            if count != before.get(name, 0):
                row = self.launches.setdefault(name, [0] * n)
                row[i * self.devices.shape[1] + j] += count - before[name]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _as_device(dev):
    import torch

    return torch.device(dev)


def _visible_devices(device: str) -> list:
    """The devices a mesh of `device` ("cuda" or "cpu") may take by
    default: every card this process sees, or the one CPU."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _check_devices(devices: list) -> None:
    """A mesh's devices exist: a cuda slot names a card this process
    sees (no CPU stands in for it)."""
    import torch

    for d in devices:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' "
                    "(--device cpu) to build the mesh on the CPU")
            index = 0 if d.index is None else d.index
            if index >= torch.cuda.device_count():
                raise ValueError(f"mesh device {d} is not visible: this "
                                 f"process sees {torch.cuda.device_count()}"
                                 " card(s)")
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}; expected cuda "
                             "or cpu")


def make_mesh(data: int = -1, model: int = 1, devices=None,
              device: "str | None" = None) -> Mesh:
    """Build the (data, model) mesh.  data=-1 means "all remaining
    devices".  `devices` (a list, which may repeat a device) is the
    slots' devices in order; by default the cards this process sees on
    `device` (None: the card), or on the CPU as many slots as asked,
    all bound to the one CPU device."""
    import torch

    if devices is None:
        pool = _visible_devices(device)
        if pool[0].type == "cpu":
            n_cpu = (data if data > 0 else 1) * model
            pool = pool * max(n_cpu, 1)
    else:
        pool = [torch.device(d) for d in devices]
    _check_devices(pool)
    n = len(pool)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data*model} devices, have {n}")
    if data * model < n:
        warnings.warn(
            f"mesh {data}x{model} uses {data*model} of {n} devices; "
            f"{n - data*model} left idle",
            stacklevel=2,
        )
    grid = np.empty((data, model), dtype=object)
    for idx in range(data * model):
        grid[idx // model, idx % model] = pool[idx]
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def local_devices(device: "str | None" = None) -> list:
    """This process's devices: on the CPU the one CPU device; on the
    card, the cards this rank owns.  One rank per host (LOCAL_WORLD_SIZE
    unset or 1) owns every card it sees; ranks sharing a host split its
    cards into contiguous blocks by LOCAL_RANK, and where there are
    fewer cards than ranks each rank owns its own card,
    cuda:(LOCAL_RANK mod cards), the card initialize_distributed set."""
    import torch

    pool = _visible_devices(device)
    if pool[0].type == "cpu":
        return pool
    local = int(os.environ.get("LOCAL_RANK", "0") or 0)
    nlocal = int(os.environ.get("LOCAL_WORLD_SIZE", "1") or 1)
    n = len(pool)
    if nlocal <= 1:
        return pool
    if n < nlocal:
        return [torch.device("cuda", local % n)]
    per = n // nlocal
    return pool[local * per:(local + 1) * per]


def local_mesh(data: int = -1, model: int = 1,
               device: "str | None" = None) -> Mesh:
    """The (data, model) mesh over THIS process's devices only
    (`local_devices`): the host-local training mesh of distributed EM
    (parallel/allreduce.py).  Each rank runs its E-step shards over its
    own devices and the cross-process reduction is an explicit
    collective, never a mesh spanning processes.  On the CPU every slot
    binds to the CPU.  data=-1 means all local devices."""
    pool = local_devices(device)
    if pool[0].type == "cpu":
        return make_mesh(data=data, model=model, device="cpu")
    return make_mesh(data=data, model=model, devices=pool)


def mesh_device(mesh: "Mesh | None", device=None):
    """The device a run takes as its own: `device` off a mesh
    (device.resolve_device); on one, the mesh's primary device, where a
    `device` of another kind raises (a cuda mesh never runs a CPU slot,
    nor a CPU mesh the card)."""
    import torch

    from ..device import resolve_device

    if mesh is None:
        return resolve_device(device)
    resolve_device(mesh.device_type)          # the precision policy
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device} does not match the mesh's "
                         f"devices ({mesh.device_type})")
    return mesh.primary


def is_local_mesh(mesh: Mesh) -> bool:
    """True when every device of `mesh` belongs to this process (its
    `local_devices`): the only meshes the distributed host-local
    trainers accept."""
    if mesh.device_type == "cpu":
        return True
    own = set(local_devices("cuda"))
    return all(d in own for d in mesh.devices.flat)


def mesh_from_spec(spec: str, device: "str | None" = None
                   ) -> "tuple[Mesh, bool]":
    """Parse a "DATA,MODEL" mesh spec (CLI flag) into a mesh plus
    whether the vocabulary should shard (model axis > 1)."""
    data, model = parse_mesh_spec(spec)
    return make_mesh(data=data, model=model, device=device), model > 1


def parse_mesh_spec(spec: str) -> "tuple[int, int]":
    """"DATA,MODEL" -> (data, model), with the JAX package's messages."""
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(
            f"mesh spec must be 'DATA,MODEL' (e.g. '8,1'), got {spec!r}"
        )
    try:
        data, model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"mesh spec must be two integers 'DATA,MODEL', got {spec!r}"
        ) from None
    if data < 1 or model < 1:
        raise ValueError(
            f"mesh spec 'DATA,MODEL' axes must be >= 1, got {spec!r}"
        )
    return data, model


# ---------------------------------------------------------------------------
# Tensors placed over a mesh
# ---------------------------------------------------------------------------


class Sharded:
    """A tensor placed over a mesh: `spec` names, per dimension, the
    mesh axis it is split over (None: whole), as a JAX PartitionSpec
    does, and block (i, j) is slot (i, j)'s piece on that slot's device.
    Slots on one device that hold the same piece share one tensor."""

    def __init__(self, mesh: Mesh, spec: tuple, blocks, shape, dtype):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.blocks = blocks          # [data][model] lists of tensors
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def device(self):
        return self.mesh.primary

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def block(self, i: int, j: int = 0):
        return self.blocks[i][j]

    def unbind(self, dim: int = 0) -> list:
        """Split an unsharded leading dimension (a stack of batches)
        into one Sharded per entry, each block a view of this one's."""
        if dim != 0 or self.spec[0] is not None:
            raise ValueError("only an unsharded leading dimension unbinds")
        per = {}
        views = [[None] * len(row) for row in self.blocks]
        for i, row in enumerate(self.blocks):
            for j, blk in enumerate(row):
                if id(blk) not in per:
                    per[id(blk)] = blk.unbind(0)
                views[i][j] = per[id(blk)]
        return [Sharded(self.mesh, self.spec[1:],
                        [[views[i][j][n] for j in range(len(views[i]))]
                         for i in range(len(views))],
                        self.shape[1:], self.dtype)
                for n in range(self.shape[0])]

    def to_global(self):
        """The whole tensor on the primary device: the blocks joined
        along their sharded dimensions in slot order."""
        import torch

        dev = self.mesh.primary
        d, m = len(self.blocks), len(self.blocks[0])

        def join(blocks_of, axis):
            dim = self.spec.index(axis)
            return torch.cat([b.to(dev) for b in blocks_of], dim=dim)

        rows = []
        for i in range(d):
            if MODEL_AXIS in self.spec:
                rows.append(join(self.blocks[i], MODEL_AXIS))
            else:
                rows.append(self.blocks[i][0].to(dev))
            if DATA_AXIS not in self.spec:
                break
        if DATA_AXIS in self.spec:
            return torch.cat(rows, dim=self.spec.index(DATA_AXIS))
        return rows[0]


class Sharding:
    """Where a tensor goes on a mesh: the JAX NamedSharding's
    counterpart.  `put(x)` splits x along the dimensions `spec` names
    and moves each slot's piece to that slot's device, once."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def put(self, x) -> Sharded:
        import torch

        x = torch.as_tensor(x)
        mesh, spec = self.mesh, self.spec
        sizes = {DATA_AXIS: mesh.shape[DATA_AXIS],
                 MODEL_AXIS: mesh.shape[MODEL_AXIS]}
        for dim, axis in enumerate(spec):
            if axis is not None and x.shape[dim] % sizes[axis]:
                raise ValueError(
                    f"dimension {dim} of size {x.shape[dim]} not divisible "
                    f"by {axis} axis {sizes[axis]}")
        made: dict = {}
        blocks = []
        for i in range(sizes[DATA_AXIS]):
            row = []
            for j in range(sizes[MODEL_AXIS]):
                dev = mesh.device(i, j)
                key = (i if DATA_AXIS in spec else None,
                       j if MODEL_AXIS in spec else None, dev)
                if key not in made:
                    piece = x
                    for dim, axis in enumerate(spec):
                        if axis is None:
                            continue
                        n = x.shape[dim] // sizes[axis]
                        at = i if axis == DATA_AXIS else j
                        piece = piece.narrow(dim, at * n, n)
                    made[key] = piece.contiguous().to(dev)
                row.append(made[key])
            blocks.append(row)
        return Sharded(mesh, spec, blocks, x.shape, x.dtype)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Documents (leading batch axis) sharded over `data`."""
    return Sharding(mesh, (DATA_AXIS,))


def stacked_batch_sharding(mesh: Mesh) -> Sharding:
    """[N, B, ...] stacks of micro-batches: docs (axis 1) sharded over
    `data`, the stack axis whole (each step consumes one full
    micro-batch)."""
    return Sharding(mesh, (None, DATA_AXIS))


def replicated(mesh: Mesh) -> Sharding:
    """The whole tensor on every slot's device."""
    return Sharding(mesh, ())


def vocab_sharding(mesh: Mesh) -> Sharding:
    """[V, K] suff-stats sharded over `model` on the vocab axis."""
    return Sharding(mesh, (MODEL_AXIS, None))


def beta_sharding(mesh: Mesh) -> Sharding:
    """[K, V] beta sharded over `model` on the vocab axis."""
    return Sharding(mesh, (None, MODEL_AXIS))


def psum(parts: list):
    """The sum of one axis's slot partials in slot order: each moved to
    the first partial's device, then allreduce.tree_combine's fixed
    pairwise tree (no atomics, no order that depends on timing)."""
    from .allreduce import tree_combine

    dev = parts[0].device
    return tree_combine([p.to(dev) for p in parts])


def pmax(parts: list):
    """The max of one axis's slot partials, in slot order, on the first
    partial's device."""
    import torch

    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(dev))
    return out
