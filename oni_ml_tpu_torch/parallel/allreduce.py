"""Explicit cross-process collectives for distributed EM (port of
oni_ml_tpu/parallel/allreduce.py).

Each rank process runs the full E-step over its own document shards
(parallel/shard_plan.py) on its own device, and the [V, K] sufficient
statistics, the alpha sufficient statistic and the likelihood cross
processes through this layer, between the E-step and the M-step.

Transports (``Collective.transport``):

- ``local``: one process; every op is the identity.
- ``kvring``: a ring allgather over a key-value client (the process
  group's TCPStore through parallel/mesh.StoreKVClient, or the port's
  FileKVClient / TcpKVClient), chunked (``max_chunk_bytes``) and bounded
  (``timeout_s``, with peer-failure polling between wait slices).
- ``psum``: ``torch.distributed``'s all-gather into one tensor, on NCCL
  when the run is on the card and on gloo on the CPU.  It moves bytes,
  never arithmetic: every array goes over bit-cast to its raw bytes.
  NCCL refuses two ranks on one device, so on a machine with one card
  a multi-process world takes ``kvring`` for its bulk plane, and
  ``psum`` runs on NCCL in a one-rank world that names it; a ``psum``
  that cannot run (ranks sharing a card) raises.  Named explicitly,
  ``psum`` runs its gather in a one-rank world too, where ``local``
  would skip it.

The reduction stays on the host and does not depend on the transport:
gather the per-rank partials, then ``tree_combine``, a fixed pairwise
tree in shard order.  The tree is anchored to the corpus-derived shard
plan, not the process count, so the reduced float32 bytes are the same
on every rank and at every rank count.

The wire carries no pickle (a peer must not reach an unpickler).  An
array payload is a JSON header (name, dtype, shape per array) followed
by the arrays' raw bytes; a control object is JSON.  The KV clients
store text, so the frames travel base64-encoded, as the JAX package's
do.

Failure semantics: a rank that fails posts a failure key
(``Collective.fail``); every peer's blocked wait polls it between
slices and raises ``PeerFailure`` ("failed on another rank"), a
``BackendLost`` subclass, so ``ml_ops`` exits 3 with its structured
record.  A peer that dies without posting surfaces as a bounded
``PeerFailure`` timeout (ONI_ML_TPU_ALLREDUCE_TIMEOUT_S).

Every data-plane op rides an ``allreduce.wait`` span and journals a
``{"kind": "allreduce"}`` record with its bytes, rounds and wall;
``Collective.stats`` keeps the process's running totals.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import time

import numpy as np

from ..telemetry.heartbeat import BackendLost
from ..telemetry.spans import current_recorder, maybe_span


class PeerFailure(BackendLost):
    """A collective op observed another rank's failure (or a peer's
    death through a timeout).  A BackendLost, so the runner's exit-3
    path applies."""


# Characters of base64 text per KV value: the KV stores are control
# planes (TcpKVClient frames stop at 16 MiB), so bulk payloads go in
# bounded slices.
DEFAULT_MAX_CHUNK_BYTES = 2 << 20
# Bound on any one collective wait.  Ranks run EM iterations in
# lockstep, so legitimate skew is one iteration's variance;
# ONI_ML_TPU_ALLREDUCE_TIMEOUT_S overrides.
DEFAULT_TIMEOUT_S = 600.0
# Wait-slice length: between slices a blocked rank polls the failure key.
POLL_SLICE_S = 2.0
# How long a rank that has already posted its own failure keeps trying to
# finish in-flight collectives before it gives up.
FAIL_DRAIN_S = 5.0

_TRANSPORTS = ("local", "kvring", "psum")


def _bf16_pack(arr: np.ndarray) -> np.ndarray:
    """f32/f64 -> the bf16 bit pattern as uint16, round to nearest even
    (the JAX package's pack, bit for bit).  NaN stays NaN."""
    a = np.asarray(arr, np.float32)
    u = np.ascontiguousarray(a).reshape(-1).view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16))
                                         & np.uint32(1)))
               >> np.uint32(16)).astype(np.uint16)
    is_nan = ((u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)) \
        & ((u & np.uint32(0x007FFFFF)) != 0)
    if is_nan.any():
        quiet = (((u >> np.uint32(16)) & np.uint32(0x8000))
                 | np.uint32(0x7FC0)).astype(np.uint16)
        rounded = np.where(is_nan, quiet, rounded)
    return rounded.reshape(a.shape)


def _bf16_unpack(u16: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit pattern -> f32 (exact)."""
    u16 = np.asarray(u16)
    return ((u16.reshape(-1).astype(np.uint32) << np.uint32(16))
            .view(np.float32).reshape(u16.shape))


# -- the wire: a JSON header, then raw bytes ---------------------------------

_HLEN = struct.Struct("!I")
_WIRE_KINDS = "biuf"        # bool, signed, unsigned, float


def encode_arrays(named: "dict[str, np.ndarray]",
                  precision: str = "f32") -> bytes:
    """Named arrays -> one frame: a 4-byte header length, the JSON header
    ({"arrays": [{"name", "dtype", "shape", "bf16"}, ...]}) and each
    array's C-order bytes in header order.  Under "bf16" float arrays go
    as their bf16 bit patterns (`bf16: true`), unpacked to f32 by every
    reader."""
    header, blobs = [], []
    for name, v in named.items():
        a = np.asarray(v)
        if a.dtype.kind not in _WIRE_KINDS:
            raise TypeError(f"array {name!r} of dtype {a.dtype} cannot go "
                            "on the collective's wire")
        bf16 = precision == "bf16" and a.dtype.kind == "f"
        if bf16:
            a = _bf16_pack(a)
        # (np.ascontiguousarray would turn a 0-d scalar into shape (1,).)
        a = np.require(a, requirements="C")
        header.append({"name": str(name), "dtype": a.dtype.str,
                       "shape": list(a.shape), "bf16": bf16})
        blobs.append(a.tobytes())
    head = json.dumps({"arrays": header}, separators=(",", ":")).encode()
    return _HLEN.pack(len(head)) + head + b"".join(blobs)


def decode_arrays(data: bytes) -> "dict[str, np.ndarray]":
    """A frame of encode_arrays -> named arrays (writable copies).
    Refuses a frame whose header and byte count disagree."""
    if len(data) < _HLEN.size:
        raise ValueError("collective frame shorter than its header length")
    (n,) = _HLEN.unpack_from(data)
    head = json.loads(data[_HLEN.size:_HLEN.size + n].decode())
    off = _HLEN.size + n
    out: "dict[str, np.ndarray]" = {}
    for entry in head["arrays"]:
        dt = np.dtype(entry["dtype"])
        if dt.kind not in _WIRE_KINDS:
            raise ValueError(f"collective frame names dtype {dt}")
        shape = tuple(int(s) for s in entry["shape"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if off + nbytes > len(data):
            raise ValueError("collective frame shorter than its header says")
        a = np.frombuffer(data, dt, count=nbytes // dt.itemsize,
                          offset=off).reshape(shape).copy()
        off += nbytes
        out[entry["name"]] = _bf16_unpack(a) if entry.get("bf16") else a
    if off != len(data):
        raise ValueError("collective frame longer than its header says")
    return out


def tree_combine(parts):
    """Deterministic pairwise-tree sum of a list of dicts of arrays (or of
    arrays): adjacent pairs combine level by level, an odd tail carries up
    unchanged.  For a contiguous, power-of-two-aligned block of leaves it
    reproduces the canonical tree's subtree node exactly, the property
    that makes the reduction invariant to the rank count."""
    parts = list(parts)
    if not parts:
        raise ValueError("tree_combine of no parts")
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            a, b = parts[i], parts[i + 1]
            if isinstance(a, dict):
                nxt.append({k: a[k] + b[k] for k in a})
            else:
                nxt.append(a + b)
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


class Collective:
    """One process's handle on the run's process group.

    Every method is collective: all ranks call the same ops in the same
    order (the key sequence advances in lockstep).  The control plane
    (broadcast and allgather of small JSON objects, barriers, the
    failure relay) rides the KV client whatever the transport; only the
    bulk array plane switches.  `device` is the device the run trains
    on: the psum transport gathers on NCCL for "cuda", on gloo for
    "cpu"."""

    def __init__(self, client=None, rank: "int | None" = None,
                 nprocs: "int | None" = None, *,
                 transport: "str | None" = None,
                 timeout_s: "float | None" = None,
                 max_chunk_bytes: int = DEFAULT_MAX_CHUNK_BYTES,
                 namespace: str = "oni/ar",
                 payload_precision: "str | None" = None,
                 device: "str | None" = None):
        from . import mesh

        self.rank = mesh.process_index() if rank is None else int(rank)
        self.num_processes = (mesh.process_count() if nprocs is None
                              else int(nprocs))
        if client is None and self.num_processes > 1:
            client = mesh.kv_client()
            if client is None:
                raise RuntimeError(
                    "a multi-process collective needs a KV client: call "
                    "parallel.initialize_distributed() first")
        self._client = client
        self.device = device or mesh.run_device()
        env_t = os.environ.get("ONI_ML_TPU_ALLREDUCE_TIMEOUT_S", "")
        self.timeout_s = (
            float(env_t) if env_t
            else (DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
        )
        self.max_chunk_bytes = int(max_chunk_bytes)
        self._ns = namespace
        self._seq = 0
        if transport is None:
            transport = os.environ.get("ONI_ML_TPU_ALLREDUCE", "")
        explicit = bool(transport)
        if not transport:
            transport = "local" if self.num_processes == 1 else "kvring"
        if transport not in _TRANSPORTS:
            raise ValueError(
                f"unknown allreduce transport {transport!r}: expected "
                "local, kvring, or psum")
        if transport == "local" and self.num_processes > 1:
            raise ValueError("the local transport is for one process; "
                             f"this world has {self.num_processes}")
        if transport == "kvring" and self._client is None:
            raise ValueError("the kvring transport needs a KV client")
        self.transport = transport
        # Named explicitly, psum gathers even in a one-rank world.
        self._gather_alone = explicit and transport == "psum"
        self._pg = None
        if transport == "psum":
            self._pg = mesh.process_group(self.device, self.timeout_s)
            if self.num_processes > 1 and self._pg_backend() == "nccl":
                self._check_distinct_cards()
        if payload_precision is None:
            payload_precision = os.environ.get(
                "ONI_ML_TPU_ALLREDUCE_PRECISION", "") or "f32"
        if payload_precision not in ("f32", "bf16"):
            raise ValueError(
                f"unknown allreduce payload_precision "
                f"{payload_precision!r}: expected f32 or bf16")
        # The wire precision of float payloads on the kvring transport:
        # "bf16" halves the bytes (round to nearest even, exact f32
        # unpack, f32 accumulation in the tree).  Per-call overrides let
        # the trainer compress the suff-stats while the f64 gamma merge
        # stays exact.
        self.payload_precision = payload_precision
        self._failed_reason: "str | None" = None
        # Process-local totals: data-plane ops, payload bytes out/in, wall.
        self.stats = {"ops": 0, "bytes_out": 0, "bytes_in": 0,
                      "wall_s": 0.0}

    def _pg_backend(self) -> str:
        import torch.distributed as dist

        return str(dist.get_backend(self._pg))

    def _check_distinct_cards(self) -> None:
        """NCCL takes one rank per card: refuse a psum world whose ranks
        share one (the control plane compares the cards' UUIDs)."""
        import torch

        dev = torch.cuda.current_device()
        uuid = str(getattr(torch.cuda.get_device_properties(dev), "uuid",
                           dev))
        cards = self.allgather_obj(uuid, "psum_cards")
        if len(set(cards)) != len(cards):
            raise ValueError(
                "the psum transport runs NCCL, which refuses two ranks on "
                f"one card ({len(cards)} ranks on {len(set(cards))} "
                "cards): use the kvring transport for this world")

    def applied_precision(self, precision: "str | None" = None) -> str:
        """The wire precision an allgather with this `precision` request
        actually uses: bf16 compresses only multi-process kvring payloads
        (psum gathers raw words; one process never touches a wire)."""
        if precision is None:
            precision = self.payload_precision
        return ("bf16" if precision == "bf16"
                and self.transport == "kvring"
                and self.num_processes > 1 else "f32")

    # -- failure relay ----------------------------------------------------

    def fail(self, reason: str) -> None:
        """Post this rank's failure for every peer's wait-slice poll.
        Best effort (the process is on its way out).  Also caps this
        collective's own later waits at FAIL_DRAIN_S."""
        self._failed_reason = str(reason)[:500]
        if self._client is None:
            return
        try:
            self._client.key_value_set(
                self._ns + "/fail",
                json.dumps({"rank": self.rank,
                            "reason": self._failed_reason}),
                allow_overwrite=True,
            )
        except Exception:
            pass

    def check_peer_failure(self) -> None:
        """Raise PeerFailure if any other rank posted a failure."""
        if self._client is None:
            return
        try:
            raw = self._client.blocking_key_value_get(self._ns + "/fail", 1)
        except Exception:
            return
        try:
            rec = json.loads(raw)
            rank, reason = int(rec["rank"]), str(rec["reason"])
        except (ValueError, KeyError, TypeError):
            rank, reason = -1, "unreadable failure record"
        if rank == self.rank:
            return
        raise PeerFailure(
            f"distributed run failed on another rank (rank {rank}: "
            f"{reason})")

    # -- KV primitives ----------------------------------------------------

    def _next_base(self, tag: str) -> str:
        self._seq += 1
        return f"{self._ns}/{self._seq}-{tag}"

    def _kv_get(self, key: str) -> str:
        """Blocking get with a bounded deadline and peer-failure polling
        between wait slices."""
        budget = (min(self.timeout_s, FAIL_DRAIN_S)
                  if self._failed_reason is not None else self.timeout_s)
        deadline = time.monotonic() + budget
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if self._failed_reason is not None:
                    raise PeerFailure(
                        "abandoning collective drain after this rank's "
                        f"own failure: {self._failed_reason}")
                raise PeerFailure(
                    f"collective wait for {key!r} timed out after "
                    f"{self.timeout_s:.0f}s: a peer rank is stalled or "
                    "died without posting a failure")
            slice_ms = max(1, int(min(POLL_SLICE_S, remaining) * 1000))
            try:
                return self._client.blocking_key_value_get(key, slice_ms)
            except Exception as e:
                if "DEADLINE_EXCEEDED" not in str(e):
                    raise
                self.check_peer_failure()

    def _put_chunked(self, key: str, data: bytes) -> None:
        """Publish `data` under `key` in bounded base64 chunks; the chunk
        count lands last, so a reader never sees a partial value."""
        enc = base64.b64encode(data).decode("ascii")
        n = -(-len(enc) // self.max_chunk_bytes) if enc else 0
        for i in range(n):
            self._client.key_value_set(
                f"{key}/c{i}",
                enc[i * self.max_chunk_bytes:(i + 1) * self.max_chunk_bytes])
        self._client.key_value_set(f"{key}/n", str(n))

    def _get_chunked(self, key: str, delete: bool = False) -> bytes:
        n = int(self._kv_get(f"{key}/n"))
        parts = [self._kv_get(f"{key}/c{i}") for i in range(n)]
        if delete:
            # Single-reader keys (ring messages): the reader retires them.
            try:
                for i in range(n):
                    self._client.key_value_delete(f"{key}/c{i}")
                self._client.key_value_delete(f"{key}/n")
            except Exception:
                pass
        return base64.b64decode("".join(parts))

    # -- control plane ----------------------------------------------------

    def broadcast_obj(self, obj, tag: str):
        """Coordinator (rank 0) -> all: a JSON object (tuples come back as
        lists).  The stage-decision primitive."""
        if self.num_processes == 1:
            return obj
        base = self._next_base(tag)
        if self.rank == 0:
            self._put_chunked(base, json.dumps(obj).encode())
            return obj
        return json.loads(self._get_chunked(base))

    def broadcast_arrays(self, named: "dict[str, np.ndarray] | None",
                         tag: str) -> "dict[str, np.ndarray]":
        """Coordinator (rank 0) -> all: named arrays, bit for bit (the
        warm-start seed of a distributed window refresh)."""
        if self.num_processes == 1:
            return dict(named or {})
        base = self._next_base(tag)
        if self.rank == 0:
            named = {k: np.asarray(v) for k, v in (named or {}).items()}
            self._put_chunked(base, encode_arrays(named))
            return named
        return decode_arrays(self._get_chunked(base))

    def allgather_obj(self, obj, tag: str) -> list:
        """Every rank's JSON object, in rank order, on every rank."""
        if self.num_processes == 1:
            return [obj]
        blocks, *_ = self._ring_allgather(json.dumps(obj).encode(), tag)
        return [json.loads(b) for b in blocks]

    def barrier(self, tag: str) -> None:
        """Returns when every rank has reached this point (with the
        failure relay while waiting)."""
        self.allgather_obj(True, tag)

    # -- data plane -------------------------------------------------------

    def _ring_allgather(self, payload: bytes, tag: str):
        """Ring allgather over the KV store: P-1 rounds, each rank
        forwarding one block per round to its successor (a single-reader
        key, retired after the read).  Returns (blocks_by_rank,
        bytes_out, bytes_in, rounds)."""
        base = self._next_base(tag)
        p, r = self.num_processes, self.rank
        blocks: list = [None] * p
        blocks[r] = payload
        bytes_out = bytes_in = 0
        for s in range(p - 1):
            send = (r - s) % p
            self._put_chunked(f"{base}/s{s}/r{r}", blocks[send])
            bytes_out += len(blocks[send])
            got = self._get_chunked(f"{base}/s{s}/r{(r - 1) % p}",
                                    delete=True)
            blocks[(r - s - 1) % p] = got
            bytes_in += len(got)
        return blocks, bytes_out, bytes_in, p - 1

    def _psum_gather(self, local: np.ndarray) -> np.ndarray:
        """[*shape] per-rank payload -> [nprocs, *shape] through
        torch.distributed's all-gather into one tensor (on the run's
        device: NCCL on the card, gloo on the CPU).  Bytes only: every
        array is bit-cast to its raw bytes (uint8, which both backends
        gather for any source dtype, 8-byte and bool ones included) and
        back."""
        import torch
        import torch.distributed as dist

        a = np.require(local, requirements="C")
        shape, dtype = a.shape, a.dtype
        flat = a.reshape(-1).view(np.uint8)
        dev = torch.device(self.device)
        t = torch.from_numpy(flat.copy()).to(dev)
        out = torch.empty((self.num_processes * t.numel(),), dtype=t.dtype,
                          device=dev)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        try:
            gather(out, t, group=self._pg)
        except Exception as e:
            # A gather fails when a peer is gone: say so as the KV ring
            # does (its posted reason where there is one).
            self.check_peer_failure()
            raise PeerFailure(f"psum gather failed: {e}") from e
        g = out.cpu().numpy().reshape(self.num_processes, -1)
        return np.ascontiguousarray(g).view(dtype).reshape(
            (self.num_processes, *shape))

    def allgather_arrays(self, named: "dict[str, np.ndarray]",
                         tag: str, *,
                         precision: "str | None" = None
                         ) -> "list[dict[str, np.ndarray]]":
        """The bulk primitive: every rank's named-array dict, in rank
        order, on every rank.  Journaled as {"kind": "allreduce"} with
        the op's bytes, rounds and wall; the wait under an
        `allreduce.wait` span.

        `precision` overrides payload_precision for this op.  Under
        "bf16" on the kvring transport float arrays go as bf16 bit
        patterns, and every rank, the sender reading its own block too,
        unpacks them to f32 before use, so the reduced bytes stay the
        same on every rank."""
        named = {k: np.asarray(v) for k, v in named.items()}
        applied = self.applied_precision(precision)
        if self.num_processes == 1 and not self._gather_alone:
            return [named]
        t0 = time.monotonic()
        with maybe_span("allreduce.wait", tag=tag,
                        transport=self.transport):
            if self.transport == "psum":
                stacked = {k: self._psum_gather(v)
                           for k, v in named.items()}
                out = [{k: stacked[k][p] for k in stacked}
                       for p in range(self.num_processes)]
                bytes_out = sum(v.nbytes for v in named.values())
                bytes_in = bytes_out * (self.num_processes - 1)
                rounds = 1
            else:
                own = encode_arrays(named, applied)
                blocks, bytes_out, bytes_in, rounds = (
                    self._ring_allgather(own, tag))
                out = [decode_arrays(b) for b in blocks]
        wall = time.monotonic() - t0
        self.stats["ops"] += 1
        self.stats["bytes_out"] += bytes_out
        self.stats["bytes_in"] += bytes_in
        self.stats["wall_s"] += wall
        rec = current_recorder()
        if rec is not None:
            rec.journal_record({
                "kind": "allreduce",
                "tag": tag,
                "transport": self.transport,
                "nprocs": self.num_processes,
                "rounds": rounds,
                "precision": applied,
                "bytes_out": bytes_out,
                "bytes_in": bytes_in,
                "wall_s": round(wall, 6),
            })
        return out


def reduce_partials(coll: Collective, plan, shard_stats: "dict[int, dict]",
                    tag: str, *,
                    precision: "str | None" = None
                    ) -> "dict[str, np.ndarray]":
    """The sufficient-statistics allreduce: per-shard partials in, the
    reduced statistics out, the same bytes on every rank and at every
    rank count for a fixed shard plan.

    `shard_stats` maps this rank's owned shard indices to named-array
    dicts.  Aligned plans (rank runs are canonical tree nodes) exchange
    one pre-combined subtree root per rank; unaligned plans exchange the
    per-shard partials, so the canonical shard-order tree still applies
    everywhere.  `precision="bf16"` compresses the kvring payload (f32
    accumulation after the unpack)."""
    owned = sorted(shard_stats)
    if plan.aligned:
        local = tree_combine([shard_stats[s] for s in owned])
        gathered = coll.allgather_arrays(local, tag, precision=precision)
        return tree_combine(gathered)
    flat: "dict[str, np.ndarray]" = {}
    for s in owned:
        for k, v in shard_stats[s].items():
            flat[f"{s}:{k}"] = v
    gathered = coll.allgather_arrays(flat, tag, precision=precision)
    by_shard: "dict[int, dict]" = {}
    for g in gathered:
        for key, v in g.items():
            s, name = key.split(":", 1)
            by_shard.setdefault(int(s), {})[name] = v
    return tree_combine([by_shard[s] for s in sorted(by_shard)])


_COLLECTIVE: "Collective | None" = None


def get_collective() -> Collective:
    """The process-wide collective: one per process, so the KV key
    sequence stays in lockstep across every consumer (the trainer's
    reduce, the runner's stage decisions, the online trainer's step)."""
    global _COLLECTIVE
    if _COLLECTIVE is None:
        _COLLECTIVE = Collective()
    return _COLLECTIVE


def reset_collective() -> None:
    """Forget the process-wide collective (the next get_collective()
    builds a new one): for a process that runs several worlds in turn."""
    global _COLLECTIVE
    _COLLECTIVE = None
