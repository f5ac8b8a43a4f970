"""Async fleet router (port of oni_ml_tpu/serving/router.py):
consistent-hash placement, scatter/gather over serve replicas,
shadow-promotion failover, rolling drain.

It speaks the submit()/future surface of BatchScorer/FleetScorer, but
every event is forwarded to the replica that owns its tenant
(serving/placement.py: primary + warm shadow per tenant) over a framed
socket link (serving/replica.py), and the response demuxes back to the
caller's ScoreFuture by correlation id.  A replica on this host that
offers a ring pair in the ``hello`` takes the link's data frames over
shared memory (wire.ShmRing); the TCP data socket stays open for the
liveness/EOF signal and any frame larger than a slab.  Every edge journals
``{"kind": "route"}`` records (events, bytes) and per-replica
``route.<replica>.hop_ms`` histograms ride the metrics plane.

**The admission journal.**  The router records every in-flight hop (id
-> tenant, raw event, future, replica) until its response lands.  That
table is the failover drain: when a replica dies mid-flight, the
victims are the rows pointing at it, each resubmits to the tenant's
promoted replica, and the caller's future resolves late instead of
failing.  Scoring is pure and the first resolution wins on the future,
so a duplicate is harmless: every ScoreFuture resolves once.

**Failover = shadow promotion, not re-placement.**  A lost replica
(connection EOF, KV heartbeat silence past ``replica_heartbeat_miss``
intervals, or a posted fail key) promotes each victim tenant's shadow
to primary in one pass under the router lock: the shadow already holds
the model (every ``publish`` fans out to primary and shadow) and has
warmed its stacked shapes, and only the vacated shadow slots are
refilled (placement.shadow_for).

**Rolling redeploy = drain one at a time.**  ``drain_replica`` flips
routing away, waits for the replica's in-flight hops to resolve, asks
the replica to drain and detaches it; ``join_replica`` recomputes the
minimal-movement placement and migrates only the tenants the ring
moved.  At most one replica is out of rotation: the fleet never stops
serving.
"""

from __future__ import annotations

import threading
import time

from ..config import ServingConfig
from . import wire
from .batcher import ScoreFuture
from .placement import Placement, place, shadow_for
from .tenants import TenantSpec

recv_frame = wire.recv_frame
send_frame = wire.send_frame


class _Hop:
    """One admission-journal row: an event the router has forwarded
    but whose response has not landed."""

    __slots__ = ("rid", "tenant", "raw", "future", "replica",
                 "t_submit", "resends")

    def __init__(self, rid: int, tenant: str, raw, future,
                 replica: str, t_submit: float) -> None:
        self.rid = rid
        self.tenant = tenant
        self.raw = raw
        self.future = future
        self.replica = replica
        self.t_submit = t_submit
        self.resends = 0


class ReplicaLink:
    """Client side of one replica: a DATA connection for async submit
    frames and a CONTROL connection for synchronous ops, so a batch of
    in-flight submits never queues behind a slow add_tenant push (and a
    blocked admission lane backpressures only the data path).
    `want_shm` asks a same-host replica for a ring pair in the hello;
    a ring link's data frames leave through its sender thread, which
    reports each frame's bytes to `on_bytes(replica_id, nbytes)`."""

    def __init__(self, replica_id: str, host: str, port: int, *,
                 op_timeout_s: float, on_score, on_down,
                 want_shm: bool = False, on_bytes=None) -> None:
        import socket

        self.replica_id = replica_id
        self.addr = (host, port)
        self._op_timeout_s = op_timeout_s
        self._on_score = on_score
        self._on_down = on_down
        self._on_bytes = on_bytes
        self.shm_tx: "wire.ShmRing | None" = None
        self.shm_rx: "wire.ShmRing | None" = None
        self._data = socket.create_connection((host, port))
        self._ctrl = socket.create_connection((host, port))
        for s in (self._data, self._ctrl):
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._data_wlock = threading.Lock()
        self._ctrl_wlock = threading.Lock()
        self._call_lock = threading.Lock()
        self._call_seq = 0
        self._calls: "dict[int, list]" = {}
        self._closed = False
        # A ring link's data frames not yet handed to the ring, and
        # whether the sender holds a batch taken from them; apart, the
        # events sent on the ring whose responses have not come back.
        self._txq: "list[dict]" = []
        self._tx_busy = False
        self._tx_cv = threading.Condition()
        self._ring_out = 0
        self._rx_cv = threading.Condition()
        for sock, name in ((self._data, "data"), (self._ctrl, "ctrl")):
            threading.Thread(
                target=self._reader, args=(sock, name == "data"),
                name=f"oni-route-{replica_id}-{name}", daemon=True,
            ).start()
        try:
            self._negotiate(want_shm)
        except (ConnectionError, RuntimeError, TimeoutError) as e:
            self.close()
            raise ConnectionError(
                f"replica {replica_id} failed the hello: {e}") from e

    def _negotiate(self, want_shm: bool) -> None:
        """The JAX package's hello handshake, offering the columnar
        codec only (a peer that answers anything else is refused), and
        attaching the ring pair a same-host replica offers.  A ring that
        does not attach leaves the link on TCP."""
        import socket

        rsp = self.call({"op": "hello", "wire": ["columnar"],
                         "shm": want_shm, "host": socket.gethostname()})
        if rsp.get("wire", "columnar") != "columnar":
            raise ConnectionError(
                f"replica {self.replica_id} answered the hello with "
                f"{rsp.get('wire')!r}; this router speaks only the "
                "columnar wire")
        shm = rsp.get("shm")
        if not shm:
            return
        try:
            tx = wire.ShmRing.attach(shm["c2s"], int(shm["slab"]))
        except Exception:
            return              # ring attach must never break the link
        try:
            rx = wire.ShmRing.attach(shm["s2c"], int(shm["slab"]))
        except Exception:
            tx.close()
            return
        # Set once, before the link is handed to any caller.
        self.shm_tx, self.shm_rx = tx, rx
        threading.Thread(
            target=self._ring_reader, args=(rx,),
            name=f"oni-route-{self.replica_id}-ring", daemon=True,
        ).start()
        threading.Thread(
            target=self._ring_sender, args=(tx,),
            name=f"oni-route-{self.replica_id}-tx", daemon=True,
        ).start()

    def _ring_reader(self, rx: "wire.ShmRing") -> None:
        """The shared-memory twin of the data socket's reader: score
        batches pop off the response ring.  Every response answers an
        event this link sent on the ring, so the thread polls only while
        such an event is out and otherwise waits on the sender's
        condition: an idle link takes no GIL from the router's process
        (the JAX reader polls its ring all the time).  Link death stays
        the TCP reader's job; this thread drains and exits when the ring
        closes."""
        while True:
            with self._rx_cv:
                while (self._ring_out <= 0 and not self._closed
                       and not rx.closed):
                    self._rx_cv.wait(0.25)
            payload = rx.pop(0.25)
            if payload is None:
                if rx.closed or self._closed:
                    return
                continue
            try:
                msg = wire.decode_payload(payload)
            except ConnectionError:
                return
            with self._rx_cv:
                self._ring_out -= len(msg) if isinstance(msg, list) else 1
            if isinstance(msg, list):
                for m in msg:
                    self._on_score(self.replica_id, m)
            else:
                self._on_score(self.replica_id, msg)

    def _reader(self, sock, is_data: bool) -> None:
        while True:
            try:
                msg = recv_frame(sock)
            except (ConnectionError, OSError) as e:
                with self._call_lock:
                    closed = self._closed
                    pending = list(self._calls.values())
                    self._calls.clear()
                for entry in pending:
                    entry[1] = {"error": f"link down: {e!r}"}
                    entry[0].set()
                if not closed:
                    self._on_down(self.replica_id,
                                  f"connection lost: {e!r}")
                return
            if is_data:
                # A list frame is a batched score response (the
                # replica's resolver coalesces ready futures).
                if isinstance(msg, list):
                    for m in msg:
                        self._on_score(self.replica_id, m)
                else:
                    self._on_score(self.replica_id, msg)
                continue
            with self._call_lock:
                entry = self._calls.pop(msg.get("id"), None)
            if entry is not None:
                entry[1] = msg
                entry[0].set()

    def call(self, req: dict, timeout_s: "float | None" = None) -> dict:
        """Synchronous control op; raises on link death, timeout, or
        an error response."""
        with self._call_lock:
            if self._closed:
                raise ConnectionError(
                    f"link to {self.replica_id} closed")
            self._call_seq += 1
            cid = self._call_seq
            entry = [threading.Event(), None]
            self._calls[cid] = entry
        wire.send_frame(self._ctrl, {**req, "id": cid},
                        self._ctrl_wlock)
        if not entry[0].wait(timeout_s or self._op_timeout_s):
            with self._call_lock:
                self._calls.pop(cid, None)
            raise TimeoutError(
                f"replica {self.replica_id} op {req.get('op')!r} "
                f"timed out"
            )
        rsp = entry[1]
        if rsp.get("error"):
            raise RuntimeError(
                f"replica {self.replica_id} op {req.get('op')!r} "
                f"failed: {rsp['error']}"
            )
        return rsp

    def send_submit(self, rid: int, tenant: str, raw) -> int:
        return self._send_data(
            {"op": "submit", "id": rid, "tenant": tenant, "raw": raw})

    def send_submit_many(self, rids: "list[int]", tenant: str,
                         raws: list) -> int:
        """One frame carrying a whole ingest chunk: per-event framing
        + syscall overhead amortizes across the chunk, which is what
        lets the router's feed path keep N replicas busy instead of
        spending its core on framing."""
        return self._send_data(
            {"op": "submit_many", "ids": rids, "tenant": tenant,
             "raws": raws})

    def _send_data(self, msg: dict) -> int:
        """A link without rings writes the frame to its TCP socket and
        returns its bytes.  A ring link queues it for `_ring_sender`
        and returns 0 (the sender reports the bytes it sends); a closed
        link raises the OSError the failover expects."""
        if self.shm_tx is None:
            return wire.send_frame(self._data, msg, self._data_wlock)
        with self._tx_cv:
            if self._closed:
                raise ConnectionError(f"link to {self.replica_id} closed")
            self._txq.append(msg)
            if not self._tx_busy:
                self._tx_cv.notify_all()
        return 0

    def _ring_sender(self, tx: "wire.ShmRing") -> None:
        """Hands a ring link's queued data frames to the ring, oldest
        first.  A ring holds two frames, so a caller pushing one event a
        frame would wait on the replica's reader every other event; here
        the caller only queues, and what queued while the ring was full
        leaves as one frame a tenant (`_coalesce`), and the events it
        sends wake the ring reader.  A frame larger than
        a slab, or one the ring refuses (closed, or no slab freed within
        the push's timeout), goes on the TCP socket, whose failure is
        the link's death: the failover resends the link's events from
        the router's admission journal."""
        while True:
            with self._tx_cv:
                while not self._txq and not self._closed:
                    self._tx_cv.wait()
                if self._closed:
                    self._txq.clear()
                    self._tx_cv.notify_all()
                    return
                batch, self._txq = self._txq, []
                self._tx_busy = True
            try:
                for msg in _coalesce(batch):
                    try:
                        payload = wire.encode_payload(msg)
                    except (TypeError, ValueError) as e:
                        for eid in msg.get("ids") or [msg["id"]]:
                            self._on_score(self.replica_id, {
                                "id": eid, "error": repr(e)[:300]})
                        continue
                    events = len(msg["ids"]) if "ids" in msg else 1
                    with self._rx_cv:
                        # Counted before the push: the response can
                        # come back before push() returns.
                        self._ring_out += events
                        if self._ring_out == events:
                            self._rx_cv.notify_all()
                    if len(payload) <= tx.capacity() and tx.push(payload):
                        nbytes = len(payload)
                    else:
                        with self._rx_cv:
                            self._ring_out -= events
                        nbytes = wire.send_frame(self._data, msg,
                                                 self._data_wlock)
                    if self._on_bytes is not None:
                        self._on_bytes(self.replica_id, nbytes)
            except OSError as e:
                with self._tx_cv:
                    closed = self._closed
                    self._tx_busy = False
                    self._tx_cv.notify_all()
                if not closed:
                    self._on_down(self.replica_id, f"send failed: {e!r}")
                return
            with self._tx_cv:
                self._tx_busy = False
                self._tx_cv.notify_all()

    def wait_sent(self, timeout_s: float) -> None:
        """Wait until the sender has handed over every queued frame, so
        a flush op on the control connection does not pass the submits
        it should flush."""
        with self._tx_cv:
            self._tx_cv.wait_for(
                lambda: self._closed or not (self._txq or self._tx_busy),
                timeout_s)

    def close(self) -> None:
        with self._call_lock:
            self._closed = True
        for cv in (self._tx_cv, self._rx_cv):
            with cv:
                cv.notify_all()
        for ring in (self.shm_tx, self.shm_rx):
            if ring is not None:
                ring.close()
        for s in (self._data, self._ctrl):
            try:
                s.close()
            except OSError:
                pass


def _coalesce(batch: "list[dict]"):
    """Queued submit and submit_many frames -> the frames to send: one a
    tenant, in the order the tenants first appear, each tenant's events
    in their order; a tenant's lone event stays a submit."""
    groups: "dict[str, tuple[list, list]]" = {}
    for msg in batch:
        ids, raws = groups.setdefault(msg["tenant"], ([], []))
        if msg["op"] == "submit":
            ids.append(msg["id"])
            raws.append(msg["raw"])
        else:
            ids.extend(msg["ids"])
            raws.extend(msg["raws"])
    for tenant, (ids, raws) in groups.items():
        if len(ids) == 1:
            yield {"op": "submit", "id": ids[0], "tenant": tenant,
                   "raw": raws[0]}
        else:
            yield {"op": "submit_many", "ids": ids, "tenant": tenant,
                   "raws": raws}


class FleetRouter:
    """Placement + scatter/gather + failover over a set of
    ReplicaLinks.  Lifecycle: connect_replica()* -> add_tenant()* ->
    start() -> submit()/publish()/drain_replica()/join_replica() ->
    close()."""

    def __init__(self, config: "ServingConfig | None" = None, *,
                 journal=None, recorder=None, kv=None,
                 membership_ns: str = "oni/fleet",
                 router_id: "str | None" = None) -> None:
        import os

        self.config = config or ServingConfig()
        # Distinct per router PROCESS: N routers run with zero
        # coordination (placement is a pure function of membership),
        # and this id is what first-writer-wins promotion claims and
        # per-router journal records key on.
        self.router_id = router_id or f"router-{os.getpid()}"
        self._journal = getattr(journal, "journal", journal)
        self._recorder = recorder
        self._cond = threading.Condition()
        self._links: "dict[str, ReplicaLink]" = {}
        self._dead: set = set()
        self._tenants: dict = {}       # tenant -> {spec, cuts, model, version}
        self._route: "dict[str, str]" = {}
        self._shadow: "dict[str, str | None]" = {}
        # replica -> {tenant: router_version last successfully pushed}.
        # The version is what publish/drain/failover convergence keys
        # on: membership alone cannot distinguish "hosts the tenant"
        # from "hosts the tenant at the CURRENT model", and the
        # drain/publish race (a re-placement concurrent with a publish
        # fan-out) is exactly a replica holding the former.
        self._hosted: "dict[str, dict]" = {}
        self._inflight: "dict[int, _Hop]" = {}
        self._inflight_by_replica: "dict[str, int]" = {}
        self._next_id = 0
        self._edge: "dict[str, dict]" = {}
        self._started = False
        self._closed = False
        self._failovers: "list[dict]" = []
        self._monitor_stop = threading.Event()
        self._monitor = None
        self._membership = None
        if kv is not None:
            from ..parallel.membership import MembershipClient

            self._membership = MembershipClient(kv, membership_ns)
            self._journal_safe({
                "kind": "membership", "event": "transport",
                "router": self.router_id,
                "transport": type(kv).__name__,
            })

    # -- setup ---------------------------------------------------------------

    def connect_replica(self, replica_id: str, host: str,
                        port: int) -> None:
        link = ReplicaLink(
            replica_id, host, port,
            op_timeout_s=self.config.route_op_timeout_s,
            on_score=self._on_score, on_down=self._on_link_down,
            want_shm=self.config.wire_shm,
            on_bytes=lambda r, nbytes: self._note_edge(r, nbytes, 0),
        )
        with self._cond:
            if replica_id in self._links:
                link.close()
                raise ValueError(f"replica {replica_id!r} already "
                                 "connected")
            self._links[replica_id] = link
            self._dead.discard(replica_id)
        self._journal_safe({
            "kind": "wire", "edge": replica_id,
            "router": self.router_id, "format": "columnar",
            "shm": link.shm_tx is not None,
        })
        if self._membership is not None:
            # A respawned replica under a previously-failed id must
            # not be re-killed by its own stale fail key on the
            # monitor's next poll — and a stale promotion claim from
            # its previous death must not make the NEXT failover
            # believe someone already owns it.
            try:
                self._membership.clear_failure(replica_id)
                self._membership.clear_promotion(replica_id)
            except Exception:
                pass
        with self._cond:
            self._hosted.setdefault(replica_id, {})
            self._inflight_by_replica.setdefault(replica_id, 0)
            self._edge.setdefault(replica_id, {
                "events": 0, "bytes": 0, "errors": 0, "resends": 0,
                "admission_stall_s": 0.0,
                "window_events": 0, "window_bytes": 0,
            })

    def connect_from_membership(self) -> "list[str]":
        """Discover and connect every replica registered in the KV
        roster — how a second (third, ...) router joins an already
        running fleet without a host/port list: replicas register
        their endpoint at startup, placement is a pure function of the
        roster, so any router that reads it computes the same routes.
        Idempotent; returns the connected replica ids."""
        if self._membership is None:
            raise RuntimeError(
                "connect_from_membership needs a KV client "
                "(FleetRouter(kv=...))")
        for rid, rec in sorted(self._membership.members().items()):
            meta = rec.get("meta", {})
            with self._cond:
                known = rid in self._links or rid in self._dead
            if known or "host" not in meta or "port" not in meta:
                continue
            try:
                self.connect_replica(rid, meta["host"],
                                     int(meta["port"]))
            except (OSError, ValueError):
                continue    # raced a dying/duplicate registration
        with self._cond:
            return sorted(self._links)

    def add_tenant(self, spec: TenantSpec, cuts: tuple, model, *,
                   featurizer=None) -> None:
        """Declare one tenant before start().  `featurizer` (optional)
        overrides `cuts`: the day-dir loading path hands over the exact
        featurizer `ml_ops serve --fleet` would build, and the replica
        rebuilds it from its cuts and top-domains table, the two things
        a source's `event_featurizer` takes (the JAX router pickles the
        object; this wire carries no pickle)."""
        with self._cond:
            if self._started:
                raise RuntimeError(
                    "add_tenant after start() is not supported — "
                    "restart placement with the full census"
                )
            if spec.tenant in self._tenants:
                raise ValueError(f"tenant {spec.tenant!r} already added")
            top: list = []
            if featurizer is not None:
                cuts = featurizer.cuts
                top = sorted(getattr(featurizer, "top_domains", ()))
            self._tenants[spec.tenant] = {
                "spec": spec, "cuts": cuts, "model": model,
                "top_domains": top, "version": 1,
            }

    def start(self, *, warmup: bool = True) -> dict:
        """Compute placement, push every tenant to its primary and
        shadow, AOT-warm each replica's stacked shapes, start the
        liveness monitor.  Returns the placement summary."""
        with self._cond:
            if self._started:
                raise RuntimeError("router already started")
            replicas = sorted(self._links)
            tenants = sorted(self._tenants)
            placement = place(tenants, replicas)
            self._route = {t: p.primary for t, p in placement.items()}
            self._shadow = {t: p.shadow for t, p in placement.items()}
            self._started = True
        for t in tenants:
            targets = [self._route[t]]
            if self._shadow[t]:
                targets.append(self._shadow[t])
            for r in targets:
                self._push_tenant(r, t)
        if warmup:
            for r in replicas:
                self._warmup(r)
        self._journal_safe({
            "kind": "membership", "event": "start",
            "replicas": replicas, "tenants": len(tenants),
        })
        monitor = threading.Thread(
            target=self._monitor_loop, name="oni-route-monitor",
            daemon=True)
        with self._cond:
            self._monitor = monitor
        monitor.start()
        return self.placement()

    def _warmup(self, replica_id: str) -> None:
        """Ask one replica to warm its stacked shapes.  A failed warm-up
        does not stop serving, and it is journaled, not dropped."""
        try:
            self._links[replica_id].call({"op": "warmup"})
        except Exception as e:
            self._journal_safe({
                "kind": "route", "edge": replica_id,
                "event": "warmup_error", "router": self.router_id,
                "error": repr(e)[:200],
            })

    def _push_tenant(self, replica_id: str, tenant: str) -> None:
        """Idempotent add_tenant push (control path) — placement
        setup, shadow backfill, and join migration all route through
        here so `_hosted` stays the single source of what each replica
        holds."""
        with self._cond:
            link = self._links.get(replica_id)
            info = self._tenants[tenant]
            spec: TenantSpec = info["spec"]
            req = {
                "op": "add_tenant",
                "spec": {
                    "tenant": spec.tenant, "dsource": spec.dsource,
                    "queue_max": spec.queue_max,
                    "admission": spec.admission,
                    "threshold": spec.threshold,
                    "weight": spec.weight,
                },
                "cuts": info["cuts"],
                "model": info["model"],
                "top_domains": info["top_domains"],
                "router_version": info["version"],
            }
        if link is None:
            raise ConnectionError(f"replica {replica_id!r} not "
                                  "connected")
        link.call(req)
        with self._cond:
            # Record the version this push CARRIED, monotone: a stale
            # concurrent push must not roll the record back below what
            # the replica actually holds (the replica itself keeps the
            # max it has seen).
            hosted = self._hosted.setdefault(replica_id, {})
            have = hosted.get(tenant)
            if have is None or req["router_version"] > have:
                hosted[tenant] = req["router_version"]

    # -- scoring path --------------------------------------------------------

    def _admit_locked(self, tenant: str, n: int):
        """Caller holds self._cond.  Resolve the tenant's live primary
        and wait out the bounded per-replica admission window (the
        Little's-law cap: at most route_max_inflight events
        outstanding per edge).  The stall, if any, is priced into the
        edge's admission_stall_s.  Returns (target, link)."""
        cap = self.config.route_max_inflight
        t0 = None
        while True:
            if self._closed:
                raise RuntimeError("router is closed")
            if tenant not in self._tenants:
                raise KeyError(
                    f"unknown tenant {tenant!r} "
                    f"(known: {sorted(self._tenants)})"
                )
            target = self._route.get(tenant)
            link = self._links.get(target)
            if link is None:
                raise RuntimeError(
                    f"tenant {tenant!r} has no live replica "
                    f"(route={target!r})"
                )
            if not cap or (
                    self._inflight_by_replica.get(target, 0) < cap):
                break
            if t0 is None:
                t0 = time.perf_counter()
            # Timed slices: a response, failover, or close notifies,
            # but a lost wakeup must not wedge admission forever.
            self._cond.wait(0.05)
        if t0 is not None:
            e = self._edge.get(target)
            if e is not None:
                e["admission_stall_s"] += time.perf_counter() - t0
        self._inflight_by_replica[target] = (
            self._inflight_by_replica.get(target, 0) + n)
        return target, link

    def submit(self, tenant: str, raw) -> ScoreFuture:
        """Forward one event to the tenant's primary replica; returns
        the future its response resolves.  A dead-link race retries
        through the failover path (the event lands on the promoted
        shadow), so callers only see an error when no replica can own
        the tenant."""
        for _ in range(3):
            with self._cond:
                target, link = self._admit_locked(tenant, 1)
                self._next_id += 1
                rid = self._next_id
                hop = _Hop(rid, tenant, raw, ScoreFuture(), target,
                           time.perf_counter())
                self._inflight[rid] = hop
            try:
                nbytes = link.send_submit(rid, tenant, raw)
            except OSError as e:
                # Make sure the dead link is handled, then decide who
                # owns the retry: if the failover pass already resent
                # this hop (it was in the admission journal pointing at
                # the dead replica), its future will resolve — hand it
                # back.  Otherwise remove the row and retry against the
                # promoted route ourselves.
                self._on_link_down(target, f"send failed: {e!r}")
                with self._cond:
                    cur = self._inflight.get(rid)
                    retry = cur is not None and cur.replica == target
                    if retry:
                        self._inflight.pop(rid, None)
                        self._dec_inflight_locked(target, 1)
                if not retry:
                    return hop.future
                continue
            self._note_edge(target, nbytes, 1)
            return hop.future
        raise RuntimeError(
            f"submit for tenant {tenant!r} failed after repeated "
            "replica losses"
        )

    def submit_many(self, tenant: str, raws: list
                    ) -> "list[ScoreFuture]":
        """Chunked ingest: one admission-journal row and one future
        per event, ONE frame on the wire and one lock acquisition for
        the whole chunk.  Failover semantics are identical to
        submit() — each event resubmits individually off the journal
        if its replica dies mid-flight."""
        if not raws:
            return []
        for _ in range(3):
            with self._cond:
                # The chunk admits as one unit (the window may
                # overshoot by at most one chunk — bounded, and it
                # keeps the admission wait off the per-event path).
                target, link = self._admit_locked(tenant, len(raws))
                t_submit = time.perf_counter()
                hops = []
                for raw in raws:
                    self._next_id += 1
                    hops.append(_Hop(
                        self._next_id, tenant, raw, ScoreFuture(),
                        target, t_submit,
                    ))
                for h in hops:
                    self._inflight[h.rid] = h
            try:
                nbytes = link.send_submit_many(
                    [h.rid for h in hops], tenant, raws)
            except OSError as e:
                self._on_link_down(target, f"send failed: {e!r}")
                retry = False
                with self._cond:
                    for h in hops:
                        cur = self._inflight.get(h.rid)
                        if cur is not None and cur.replica == target:
                            self._inflight.pop(h.rid, None)
                            self._dec_inflight_locked(target, 1)
                            retry = True
                if not retry:
                    return [h.future for h in hops]
                continue
            self._note_edge(target, nbytes, len(raws))
            return [h.future for h in hops]
        raise RuntimeError(
            f"submit_many for tenant {tenant!r} failed after repeated "
            "replica losses"
        )

    def flush(self) -> None:
        with self._cond:
            links = list(self._links.values())
        for link in links:
            try:
                link.wait_sent(self.config.route_op_timeout_s)
                link.call({"op": "flush"})
            except Exception:
                pass

    def publish(self, tenant: str, model, source: str = "router"
                ) -> int:
        """Fan one tenant's refreshed model out to its primary AND
        shadow — both stay fresh, so promotion never serves a stale
        model.  Returns the router-level version.

        The fan-out target set is computed under the lock but pushed
        outside it, so a CONCURRENT re-placement (drain_replica,
        join_replica, a failover promotion) can route the tenant onto
        a replica this publish never covered — leaving primary and
        shadow on DIFFERENT model versions until the next refresh.
        The re-validation loop below closes that race: after the
        pushes land, re-read the live route/shadow against the
        per-replica pushed-version ledger (`_hosted`) and re-push any
        mismatch, until the target set is stable or a newer publish
        has taken over convergence."""
        with self._cond:
            if tenant not in self._tenants:
                raise KeyError(f"unknown tenant {tenant!r}")
            self._tenants[tenant]["model"] = model
            self._tenants[tenant]["version"] += 1
            version = self._tenants[tenant]["version"]
            targets = [self._route[tenant]]
            if self._shadow.get(tenant):
                targets.append(self._shadow[tenant])
            links = [(r, self._links.get(r)) for r in targets]
        for r, link in links:
            if link is None:
                continue
            try:
                link.call({
                    "op": "publish", "tenant": tenant, "model": model,
                    "source": source, "router_version": version,
                })
                with self._cond:
                    hosted = self._hosted.setdefault(r, {})
                    if hosted.get(tenant, 0) < version:
                        hosted[tenant] = version
            except Exception as e:
                # The replica now holds a STALE model (or none): drop
                # it from _hosted so the failover/drain backfill
                # re-pushes the current version instead of trusting a
                # copy this publish never refreshed — otherwise a
                # later promotion would silently serve the superseded
                # model.
                with self._cond:
                    self._hosted.get(r, {}).pop(tenant, None)
                self._journal_safe({
                    "kind": "route", "edge": r, "event": "publish_error",
                    "tenant": tenant, "error": repr(e)[:200],
                })
        self._converge_publish(tenant, version)
        return version

    def _converge_publish(self, tenant: str, version: int) -> None:
        """Re-validate a publish's fan-out against LIVE membership:
        any current route/shadow holder whose pushed-version ledger
        entry is below `version` gets a re-push (through
        `_push_tenant`, which always carries the latest model).
        Bounded attempts — a target set churning faster than the
        pushes land is a fleet in active failover, and the failover
        backfill owns convergence there."""
        for _ in range(4):
            with self._cond:
                if self._tenants[tenant]["version"] != version:
                    return    # superseded: the newer publish converges
                targets = [self._route.get(tenant)]
                if self._shadow.get(tenant):
                    targets.append(self._shadow[tenant])
                stale = [
                    r for r in targets
                    if r and r in self._links
                    and self._hosted.get(r, {}).get(tenant, 0) < version
                ]
            if not stale:
                return
            self._journal_safe({
                "kind": "publish_repair", "tenant": tenant,
                "version": version, "router": self.router_id,
                "replicas": stale,
            })
            for r in stale:
                try:
                    self._push_tenant(r, tenant)
                except Exception as e:
                    self._journal_safe({
                        "kind": "route", "edge": r,
                        "event": "publish_error",
                        "tenant": tenant, "error": repr(e)[:200],
                    })
                    return  # link died mid-repair; failover re-pushes

    def _dec_inflight_locked(self, replica_id: str, n: int) -> None:
        """Caller holds self._cond.  Shrink one edge's outstanding
        count and wake admission waiters."""
        cur = self._inflight_by_replica.get(replica_id)
        if cur is not None:
            self._inflight_by_replica[replica_id] = max(0, cur - n)
        self._cond.notify_all()

    def _on_score(self, replica_id: str, msg: dict) -> None:
        with self._cond:
            hop = self._inflight.pop(msg.get("id"), None)
            if hop is not None:
                self._dec_inflight_locked(hop.replica, 1)
        if hop is None:
            return      # late duplicate after a failover resend
        if "error" in msg:
            hop.future._fail(RuntimeError(
                f"replica {replica_id}: {msg['error']}"))
            with self._cond:
                e = self._edge.get(replica_id)
                if e is not None:
                    e["errors"] += 1
            return
        hop.future._resolve(msg["score"], msg.get("version", 0))
        if self._recorder is not None:
            # Per edge, and over every edge (the route latency the
            # stream reports).
            hop_ms = (time.perf_counter() - hop.t_submit) * 1e3
            self._recorder.histogram(
                f"route.{replica_id}.hop_ms").observe(hop_ms)
            self._recorder.histogram("route.hop_ms").observe(hop_ms)

    def _note_edge(self, replica_id: str, nbytes: int,
                   events: int) -> None:
        every = self.config.route_journal_every
        emit = None
        with self._cond:
            e = self._edge.get(replica_id)
            if e is None:
                return
            e["events"] += events
            e["bytes"] += nbytes
            e["window_events"] += events
            e["window_bytes"] += nbytes
            if every and e["window_events"] >= every:
                emit = {
                    "kind": "route", "edge": replica_id,
                    "router": self.router_id,
                    "events": e["window_events"],
                    "bytes": e["window_bytes"],
                    "inflight": len(self._inflight),
                }
                e["window_events"] = 0
                e["window_bytes"] = 0
        if emit is not None:
            self._journal_safe(emit)

    # -- failover ------------------------------------------------------------

    def _on_link_down(self, replica_id: str, reason: str) -> None:
        t_detect = time.perf_counter()
        with self._cond:
            if (self._closed or replica_id in self._dead
                    or replica_id not in self._links):
                return
            self._dead.add(replica_id)
            link = self._links.pop(replica_id)
            self._hosted.pop(replica_id, None)
            live = sorted(self._links)
            promoted: "list[str]" = []
            reshadowed: "list[str]" = []
            for t, r in list(self._route.items()):
                if r != replica_id:
                    continue
                shadow = self._shadow.get(t)
                if shadow in self._links:
                    new_primary = shadow
                else:
                    new_primary = shadow_for(t, live)
                if new_primary is None:
                    continue     # no live replica at all; submits fail
                self._route[t] = new_primary
                self._shadow[t] = shadow_for(
                    t, live, exclude={new_primary})
                promoted.append(t)
            for t, s in list(self._shadow.items()):
                if s == replica_id:
                    self._shadow[t] = shadow_for(
                        t, live, exclude={self._route[t], replica_id})
                    reshadowed.append(t)
            victims = [h for h in self._inflight.values()
                       if h.replica == replica_id]
            self._inflight_by_replica.pop(replica_id, None)
            self._cond.notify_all()
        link.close()
        # Concurrent-router idempotence: first-writer-wins on the KV
        # promotion key decides which router owns the fleet-level
        # side of this failover (the model backfill pushes).  LOSERS
        # still promote locally — placement is a pure function of the
        # live roster, so every router computes the identical new
        # routes from its own copy — and still replay their OWN
        # admission journals (those futures live in this process).
        # What losing skips is the duplicate backfill churn.
        claimed = True
        if self._membership is not None:
            claimed = self._membership.claim_promotion(
                replica_id, self.router_id)
        self._journal_safe({
            "kind": "failover", "replica": replica_id,
            "router": self.router_id, "claimed": claimed,
            "reason": str(reason)[:300], "promoted": len(promoted),
            "reshadowed": len(reshadowed), "inflight": len(victims),
        })
        # Drain the admission journal onto the promoted primaries:
        # every in-flight hop of the dead replica resubmits — the
        # caller's future resolves late, never fails.  The promoted
        # replica already holds the model AND the compiled family
        # (shadow warmup), so this is a resend, not a rebuild.
        resent = failed = 0
        for hop in victims:
            ok = self._resend(hop)
            resent += ok
            failed += not ok
        # Backfill: make sure every promoted tenant's NEW primary and
        # refilled shadow actually hold the tenant (they do unless the
        # same tenant lost primary and shadow in quick succession).
        # Claim losers skip this — the winner pushes, and add_tenant
        # is router_version-idempotent on the replica even if both do.
        if claimed:
            for t in promoted + reshadowed:
                with self._cond:
                    targets = [self._route.get(t), self._shadow.get(t)]
                    want = self._tenants[t]["version"]
                    stale = [
                        r for r in targets
                        if r and self._hosted.get(r, {}).get(t, 0) < want
                    ]
                for r in stale:
                    try:
                        self._push_tenant(r, t)
                    except Exception:
                        pass
        recovery_s = time.perf_counter() - t_detect
        record = {
            "kind": "failover", "replica": replica_id,
            "router": self.router_id, "claimed": claimed,
            "event": "recovered", "promoted": len(promoted),
            "resent": resent, "resend_failures": failed,
            "recovery_s": round(recovery_s, 6),
        }
        # Journal BEFORE exposing through stats(): an observer that
        # polls stats() for the recovery and then reads the journal
        # must find the record there.
        self._journal_safe(record)
        with self._cond:
            self._failovers.append(record)
        if self._recorder is not None:
            self._recorder.histogram(
                "route.failover_recovery_s").observe(recovery_s)

    def _resend(self, hop: _Hop) -> bool:
        with self._cond:
            if hop.future.done():
                return True
            target = self._route.get(hop.tenant)
            link = self._links.get(target)
            if link is None:
                self._inflight.pop(hop.rid, None)
                hop.future._fail(RuntimeError(
                    f"tenant {hop.tenant!r} lost every replica"))
                return False
            hop.replica = target
            hop.resends += 1
            self._inflight[hop.rid] = hop
            # Failover replay bypasses the admission window (waiting
            # on the cap mid-failover could deadlock against the very
            # responses that free it); the overshoot is bounded by the
            # dead replica's window.
            self._inflight_by_replica[target] = (
                self._inflight_by_replica.get(target, 0) + 1)
            e = self._edge.get(target)
            if e is not None:
                e["resends"] += 1
        try:
            link.send_submit(hop.rid, hop.tenant, hop.raw)
            return True
        except OSError:
            with self._cond:
                self._inflight.pop(hop.rid, None)
                self._dec_inflight_locked(target, 1)
            hop.future._fail(RuntimeError(
                f"resend for tenant {hop.tenant!r} failed"))
            return False

    def _monitor_loop(self) -> None:
        """Liveness beyond connection EOF: KV heartbeats catch a
        WEDGED replica (process alive, drain loop stuck — the
        BackendLost mode), the fail key catches a replica that knew it
        was dying.  Detection latency = heartbeat_s * miss, the
        documented failover budget."""
        interval = self.config.replica_heartbeat_s
        ttl = interval * self.config.replica_heartbeat_miss
        while not self._monitor_stop.wait(interval):
            if self._membership is None:
                continue
            try:
                beats = self._membership.heartbeats()
                fails = self._membership.failures()
            except Exception:
                continue
            now = time.time()
            with self._cond:
                live = list(self._links)
            for r in live:
                if r in fails:
                    self._on_link_down(
                        r, f"fail key posted: "
                           f"{fails[r].get('reason', '')!r}")
                    continue
                hb = beats.get(r)
                if hb is not None and now - hb.get("t", now) > ttl:
                    self._on_link_down(
                        r, f"heartbeat silent for "
                           f"{now - hb['t']:.2f}s (ttl {ttl:.2f}s)")

    # -- elastic membership --------------------------------------------------

    def drain_replica(self, replica_id: str,
                      timeout_s: "float | None" = None) -> dict:
        """Rolling-redeploy step: flip routing away (graceful shadow
        promotion — the shadow is warm, so this is a pointer swap),
        wait for the replica's in-flight hops to resolve, ask it to
        drain, detach it.  The process itself is the caller's to stop
        or respawn."""
        timeout_s = timeout_s or self.config.route_op_timeout_s
        with self._cond:
            link = self._links.get(replica_id)
            if link is None:
                raise KeyError(f"replica {replica_id!r} not connected")
            if len(self._links) < 2:
                raise RuntimeError(
                    "cannot drain the last replica — join a "
                    "replacement first"
                )
            live = sorted(r for r in self._links if r != replica_id)
            moved = []
            for t, r in list(self._route.items()):
                if r != replica_id:
                    continue
                shadow = self._shadow.get(t)
                new_primary = (shadow if shadow in self._links
                               and shadow != replica_id
                               else shadow_for(t, live))
                self._route[t] = new_primary
                self._shadow[t] = shadow_for(
                    t, live, exclude={new_primary})
                moved.append(t)
            reshadowed = []
            for t, s in list(self._shadow.items()):
                if s == replica_id:
                    self._shadow[t] = shadow_for(
                        t, live, exclude={self._route[t]})
                    reshadowed.append(t)
        # Backfill new shadow/primary holders before declaring drained
        # — including tenants that only lost their SHADOW to the
        # drained replica: the publish fan-out and a later failover
        # both assume the shadow actually hosts the tenant.
        for t in moved + reshadowed:
            with self._cond:
                targets = [self._route.get(t), self._shadow.get(t)]
                want = self._tenants[t]["version"]
                stale = [
                    r for r in targets
                    if r and self._hosted.get(r, {}).get(t, 0) < want
                ]
            for r in stale:
                try:
                    self._push_tenant(r, t)
                except Exception:
                    pass
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cond:
                pending = sum(1 for h in self._inflight.values()
                              if h.replica == replica_id)
            if not pending:
                break
            time.sleep(0.005)
        rsp = link.call({"op": "drain", "timeout_s": timeout_s})
        with self._cond:
            self._links.pop(replica_id, None)
            self._hosted.pop(replica_id, None)
            self._inflight_by_replica.pop(replica_id, None)
            leftovers = [h for h in self._inflight.values()
                         if h.replica == replica_id]
        link.close()
        # A timed-out drain may leave admission-journal rows pointing
        # at the detached replica; closing the link suppresses the
        # _on_down failover path, so replay them explicitly — futures
        # resolve late on the promoted routes, never hang until
        # router.close().
        for hop in leftovers:
            self._resend(hop)
        self._journal_safe({
            "kind": "membership", "event": "drain",
            "replica": replica_id, "moved": len(moved),
            "drained": bool(rsp.get("drained")),
        })
        return {"replica": replica_id, "moved": len(moved),
                "drained": bool(rsp.get("drained"))}

    def join_replica(self, replica_id: str, host: str, port: int, *,
                     warmup: bool = True) -> dict:
        """Elastic join: connect, recompute the minimal-movement
        placement over the grown fleet, migrate ONLY the tenants the
        ring moved (push model first, flip route second — the tenant
        is never unowned), refill shadows, warm the new replica."""
        self.connect_replica(replica_id, host, port)
        with self._cond:
            replicas = sorted(self._links)
            tenants = sorted(self._tenants)
            desired = place(tenants, replicas)
            moves = [t for t in tenants
                     if desired[t].primary != self._route.get(t)]
            shadow_moves = [t for t in tenants
                            if desired[t].shadow != self._shadow.get(t)]
        for t in moves:
            self._push_tenant(desired[t].primary, t)
        for t in shadow_moves:
            if desired[t].shadow:
                self._push_tenant(desired[t].shadow, t)
        with self._cond:
            # The desired placement was computed before the (slow,
            # multi-RPC) model pushes; a replica lost meanwhile must
            # not be routed back to — keep the current live primary,
            # else fall back down the preference order.
            live = sorted(self._links)
            for t in moves:
                want = desired[t].primary
                if want in self._links:
                    self._route[t] = want
                elif self._route.get(t) not in self._links:
                    self._route[t] = shadow_for(t, live)
            for t in shadow_moves:
                want = desired[t].shadow
                if want is None or want in self._links:
                    self._shadow[t] = want
                else:
                    self._shadow[t] = shadow_for(
                        t, live, exclude={self._route.get(t)})
        if warmup:
            self._warmup(replica_id)
        self._journal_safe({
            "kind": "membership", "event": "join",
            "replica": replica_id, "moved": len(moves),
            "reshadowed": len(shadow_moves),
        })
        return {"replica": replica_id, "moved": len(moves),
                "reshadowed": len(shadow_moves)}

    # -- introspection / lifecycle -------------------------------------------

    def placement(self) -> dict:
        with self._cond:
            return {
                t: Placement(self._route[t], self._shadow.get(t))
                for t in self._route
            }

    def stats(self) -> dict:
        with self._cond:
            return {
                "replicas": sorted(self._links),
                "dead": sorted(self._dead),
                "tenants": len(self._tenants),
                "inflight": len(self._inflight),
                "edges": {
                    r: {
                        **{k: v for k, v in e.items()
                           if not k.startswith("window_")},
                        # Live occupancy of this edge's admission
                        # window.
                        "inflight": self._inflight_by_replica.get(r, 0),
                    }
                    for r, e in self._edge.items()
                },
                "max_inflight": self.config.route_max_inflight,
                "failovers": list(self._failovers),
            }

    def wire(self) -> "dict[str, dict]":
        """Each live link's transport: the codec, whether its data
        frames ride a shared-memory ring pair (what each link's `wire`
        journal record says at connect), and the ring segments' names
        (the replica owns and unlinks them)."""
        with self._cond:
            links = dict(self._links)
        return {r: {"format": "columnar", "shm": link.shm_tx is not None,
                    "segments": [ring.name for ring in
                                 (link.shm_tx, link.shm_rx)
                                 if ring is not None]}
                for r, link in sorted(links.items())}

    def replica_stats(self) -> "dict[str, dict]":
        """stats op fanned out to every live replica (compile
        counters, scored totals — the zero-retrace proof reads off
        this)."""
        with self._cond:
            links = dict(self._links)
        out = {}
        for r, link in links.items():
            try:
                out[r] = link.call({"op": "stats"})
            except Exception as e:
                out[r] = {"error": repr(e)[:200]}
        return out

    def close(self, timeout_s: float = 30.0) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            links = dict(self._links)
            self._cond.notify_all()    # admission waiters must raise
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        for link in links.values():
            try:
                link.wait_sent(timeout_s)
                link.call({"op": "flush"})
            except Exception:
                pass
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cond:
                if not self._inflight:
                    break
            time.sleep(0.005)
        with self._cond:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
        err = RuntimeError("router closed with events in flight")
        for hop in leftovers:
            hop.future._fail(err)
        for link in links.values():
            link.close()
        # Stream-end rollup: one route record per edge with cumulative
        # counts, whatever the periodic cadence was.
        with self._cond:
            edges = {r: dict(e) for r, e in self._edge.items()}
        for r, e in edges.items():
            self._journal_safe({
                "kind": "route", "edge": r, "event": "close",
                "router": self.router_id,
                "events": e["events"], "bytes": e["bytes"],
                "errors": e["errors"], "resends": e["resends"],
                "admission_stall_s": round(e["admission_stall_s"], 6),
            })

    def _journal_safe(self, record: dict) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(record)
        except Exception as e:
            import sys

            print(f"router journal append failed: {e!r}",
                  file=sys.stderr)
