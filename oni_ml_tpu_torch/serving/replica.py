"""One serve replica of the replicated fleet (port of
oni_ml_tpu/serving/replica.py).

A replica is the unit of blast radius: a whole single-process serving
stack (FleetRegistry -> dynamic FleetScorer) behind a small framed
socket protocol, plus a KV heartbeat (parallel/membership.py) so the
router can tell a wedged replica from a slow one.  N replicas each run
their own Python process and their own CUDA context on the card; a
wedged replica costs its tenants one shadow promotion instead of the
fleet.

Wire protocol (router <-> replica): length-prefixed columnar frames over
TCP (serving/wire.py, which has no pickle codec).  Every request carries
an ``id`` and every response echoes it.  A ``hello`` op confirms the
columnar codec per link and, for a same-host peer that asks, upgrades
the data path to a pair of shared-memory rings (wire.ShmRing), so local
hops skip the TCP stack; the socket stays open as the liveness/EOF
signal, and the rings live and die with it.  Control ops (add_tenant /
publish / warmup / stats / drain / shutdown / ping) answer
synchronously from the connection's reader thread.  ``submit`` is
asynchronous (on TCP or on the ring): the reader
enqueues the event into the tenant's admission lane and a
per-connection FIFO resolver thread streams ``{"id", "score",
"version"}`` responses back as the micro-batch flushes resolve them.  A
full lane blocks the reader, the socket buffer fills and the router's
send blocks: backpressure crosses the process boundary.

Warm standby: the router places every tenant on a primary and a shadow
replica, and both receive ``add_tenant``/``publish`` fan-outs, so the
shadow holds the same model and has run the ``warmup`` sizes of its
stacked shapes before a promotion sends it traffic.

`device` is where the replica's flushes score when the dispatch rule
sends them to the device (None: the card; a machine without CUDA
raises).  Nothing falls back to the host when a device dispatch fails:
the fleet's per-tenant failure isolation fails that tenant's futures.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque

from ..config import ServingConfig
from . import wire
from .fleet import FleetRegistry, FleetScorer
from .tenants import TenantSpec


def featurizer_for(dsource: str, cuts: tuple, top_domains=()):
    from ..sources import get as get_source

    return get_source(dsource).event_featurizer(
        cuts, top_domains=frozenset(top_domains))


def _hard_close(sock: socket.socket) -> None:
    """Shut a socket down, then close it.  A bare close() from another
    thread does not wake a thread blocked in recv()/accept() on it, and
    the peer sees no EOF until that thread's next call: the shutdown
    sends the FIN now, as a killed process's exit would."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _Resolver:
    """Per-connection FIFO response streamer: submits append (id,
    future); this thread resolves them in submit order and writes the
    response frames.  FIFO matches flush-resolution order closely enough
    that head-of-line waiting costs microseconds, and it keeps the
    response path single-writer (control responses share the socket
    under the same write lock)."""

    # Periodic liveness poll while blocked on an unresolved future, so a
    # shutdown/kill never strands the thread on .result(None).
    _WAIT_SLICE_S = 0.25
    # One coalesced frame never carries more than this many scores
    # (bounds frame size and head-of-line delay on the router's demux).
    _MAX_BATCH_RSP = 512

    def __init__(self, send_fn) -> None:
        self._send = send_fn
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="oni-replica-resolver", daemon=True)
        self._thread.start()

    def enqueue(self, rid: int, future) -> None:
        with self._cond:
            if self._stopped:
                raise RuntimeError("resolver stopped")
            self._queue.append((rid, future))
            self._cond.notify_all()

    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait()
                if not self._queue and self._stopped:
                    return
                rid, fut = self._queue.popleft()
            rsp = {"id": rid}
            while True:
                try:
                    score, version = fut.result(
                        timeout=self._WAIT_SLICE_S)
                    rsp["score"] = score
                    rsp["version"] = version
                    break
                except TimeoutError:
                    with self._cond:
                        if self._stopped:
                            return
                    continue
                except Exception as e:
                    rsp["error"] = repr(e)[:300]
                    break
            # Coalesce every already-resolved follower into the same
            # frame: a flush resolves a whole micro-batch at once, so the
            # head's wait usually pays for the batch.
            batch = [rsp]
            with self._cond:
                while (self._queue and len(batch) < self._MAX_BATCH_RSP
                       and self._queue[0][1].done()):
                    nrid, nfut = self._queue.popleft()
                    nrsp = {"id": nrid}
                    try:
                        score, version = nfut.result(timeout=0)
                        nrsp["score"] = score
                        nrsp["version"] = version
                    except Exception as e:
                        nrsp["error"] = repr(e)[:300]
                    batch.append(nrsp)
            try:
                self._send(batch if len(batch) > 1 else rsp)
            except OSError:
                return  # connection gone; the reader thread handles it


class ReplicaServer:
    """One replica process's serving stack and protocol endpoint.

    `kv` (optional) is a membership KV client (parallel/membership.py):
    the replica registers itself with its host/port and publishes
    heartbeats every ``config.replica_heartbeat_s`` carrying live
    counters, so the router's monitor reads load and liveness without
    extra round trips.  `health_check` (optional) is a liveness probe of
    the scoring backend: raising marks this replica wedged (fail key
    posted, heartbeats stop)."""

    def __init__(self, replica_id: str,
                 config: "ServingConfig | None" = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 kv=None, membership_ns: str = "oni/fleet",
                 metrics=None, journal=None,
                 health_check=None, device=None) -> None:
        from ..device import resolve_device

        self.replica_id = replica_id
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        self._health_check = health_check
        self.fleet = FleetRegistry(journal=journal)
        self.scorer = FleetScorer(
            self.fleet, {}, self.config, metrics=metrics,
            journal=journal, device=self.device, dynamic=True)
        self._lock = threading.Lock()
        self._closed = False
        self._draining = False
        # Set once the server has stopped (graceful or kill): what a CLI
        # main blocks on.
        self.stopped = threading.Event()
        self._conns: "list[socket.socket]" = []
        self._resolvers: "list[_Resolver]" = []
        self._rings: "list[wire.ShmRing]" = []
        self._router_versions: dict = {}
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"oni-replica-{replica_id}", daemon=True)
        self._accept_thread.start()
        self._membership = None
        self._heartbeat = None
        if kv is not None:
            from ..parallel.membership import (HeartbeatPublisher,
                                               MembershipClient)

            self._membership = MembershipClient(kv, membership_ns)
            self._membership.register(
                replica_id,
                {"host": self.host, "port": self.port, "pid": os.getpid()})
            self._heartbeat = HeartbeatPublisher(
                self._membership, replica_id,
                self.config.replica_heartbeat_s,
                payload_fn=self._hb_payload)

    # -- accept / per-connection loops --------------------------------------

    def _hb_payload(self) -> dict:
        """Heartbeat payload and wedge detector: a heartbeat is only
        worth sending if the scoring stack behind it is alive.  A dead
        scorer worker, or a failing `health_check`, posts the membership
        fail key and stops the beat, so the router's monitor promotes
        this replica's shadows within one poll."""
        reason = None
        if not self.scorer._worker.is_alive():
            reason = "fleet scorer worker died"
        elif self._health_check is not None:
            try:
                self._health_check()
            except Exception as e:
                reason = f"health check failed: {e!r}"
        if reason is not None:
            if self._membership is not None:
                self._membership.fail(self.replica_id, reason)
            raise RuntimeError(reason)   # stops the publisher loop
        return {"events_scored": self.scorer.events_scored,
                "draining": self._draining}

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return      # server socket closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"oni-replica-{self.replica_id}-conn",
                daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        # The ring pair this connection's hello negotiated, if any: torn
        # down with the connection in the finally below.
        state = {"rings": []}

        def reply(obj) -> int:
            return wire.send_frame(conn, obj, wlock)

        resolver = _Resolver(reply)
        with self._lock:
            self._resolvers.append(resolver)
        try:
            while True:
                try:
                    req = wire.recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                op = req.get("op")
                rid = req.get("id")
                if op == "submit":
                    try:
                        fut = self.scorer.submit(req["tenant"], req["raw"])
                        resolver.enqueue(rid, fut)
                    except Exception as e:
                        try:
                            reply({"id": rid, "error": repr(e)[:300]})
                        except OSError:
                            return
                    continue
                if op == "submit_many":
                    tenant = req["tenant"]
                    errors = []
                    for eid, raw in zip(req["ids"], req["raws"]):
                        try:
                            fut = self.scorer.submit(tenant, raw)
                            resolver.enqueue(eid, fut)
                        except Exception as e:
                            errors.append({"id": eid,
                                           "error": repr(e)[:300]})
                    if errors:
                        try:
                            reply(errors)
                        except OSError:
                            return
                    continue
                try:
                    rsp = {"id": rid, **self._handle(op, req, state)}
                except Exception as e:
                    rsp = {"id": rid, "error": repr(e)[:300]}
                try:
                    reply(rsp)
                except OSError:
                    return
                if op == "shutdown":
                    self.stop()
                    return
        finally:
            resolver.stop()
            # Ring lifetime = connection lifetime: a killed or
            # reconnecting router EOFs this socket, and the rings its
            # hello negotiated close (and unlink) here instead of piling
            # up segments and polling threads until the replica stops.
            self._drop_rings(state["rings"])
            try:
                conn.close()
            except OSError:
                pass

    # -- op handlers ---------------------------------------------------------

    def _handle(self, op: str, req: dict,
                state: "dict | None" = None) -> dict:
        if op == "ping":
            return {"ok": True, "replica": self.replica_id}
        if op == "hello":
            return self._op_hello(req, state)
        if op == "add_tenant":
            return self._op_add_tenant(req)
        if op == "publish":
            snap = self.fleet.publish(req["tenant"], req["model"],
                                      req.get("source", "router"))
            if "router_version" in req:
                with self._lock:
                    self._router_versions[req["tenant"]] = int(
                        req["router_version"])
            return {"ok": True, "version": snap.version}
        if op == "flush":
            self.scorer.flush()
            return {"ok": True}
        if op == "warmup":
            return {"ok": True, "warmup": self._op_warmup()}
        if op == "stats":
            return self._op_stats()
        if op == "drain":
            return self._op_drain(float(
                req.get("timeout_s", self.config.route_op_timeout_s)))
        if op == "shutdown":
            return {"ok": True}
        raise ValueError(f"unknown op {op!r}")

    def _op_hello(self, req: dict, state: "dict | None" = None) -> dict:
        """The JAX replica's hello: this wire has the columnar codec
        only, so a peer that does not offer it is refused.  A peer on
        this host that asks for ``shm`` (and a config with ``wire_shm``)
        gets a ring pair: the answer names the segments, the router
        attaches, and data frames leave the TCP socket.  A ring set-up
        that fails answers ``shm`` None: the link stays on TCP."""
        offered = req.get("wire") or []
        if "columnar" not in offered:
            raise ValueError(
                f"peer offered {offered!r}; this replica refuses any "
                "codec but the columnar wire")
        shm = None
        if (req.get("shm") and self.config.wire_shm
                and req.get("host") == socket.gethostname()):
            try:
                shm = self._make_rings(state)
            except Exception:
                shm = None    # ring set-up must never break the link
        return {"ok": True, "wire": "columnar", "shm": shm}

    def _make_rings(self, state: "dict | None" = None) -> dict:
        # A repeated hello on one connection replaces its rings: the
        # stale pair goes first, so a reconnect loop cannot pile up
        # segments behind one socket.
        if state is not None and state["rings"]:
            self._drop_rings(state["rings"])
            state["rings"] = []
        slab = int(self.config.wire_shm_slab_bytes)
        c2s = wire.ShmRing.create(slab)     # router -> replica submits
        try:
            s2c = wire.ShmRing.create(slab)     # replica -> router scores
        except BaseException:
            c2s.close()
            raise
        with self._lock:
            if self._closed:
                c2s.close()
                s2c.close()
                raise RuntimeError("replica closed")
            self._rings += [c2s, s2c]
        if state is not None:
            state["rings"] = [c2s, s2c]
        threading.Thread(
            target=self._serve_ring, args=(c2s, s2c),
            name=f"oni-replica-{self.replica_id}-ring", daemon=True,
        ).start()
        return {"c2s": c2s.name, "s2c": s2c.name, "slab": slab}

    def _drop_rings(self, rings: list) -> None:
        """Close a connection's rings and forget them: close() sets the
        shared closed flag (the _serve_ring poller exits at its next
        poll) and, on this owning side, unlinks the segments now."""
        if not rings:
            return
        for r in rings:
            r.close()
        with self._lock:
            self._rings = [r for r in self._rings if r not in rings]

    def _serve_ring(self, c2s: "wire.ShmRing",
                    s2c: "wire.ShmRing") -> None:
        """The data path of _serve_conn over a ring pair: pop submit
        frames, stream score batches back.  Control ops stay on the TCP
        control connection; a ring frame carrying one is answered with
        an error."""

        def reply(obj) -> int:
            payload = wire.encode_payload(obj)
            if not s2c.push(payload,
                            timeout_s=self.config.route_op_timeout_s):
                raise BrokenPipeError("response ring closed")
            return len(payload)

        resolver = _Resolver(reply)
        with self._lock:
            self._resolvers.append(resolver)
        try:
            while True:
                payload = c2s.pop(0.25)
                if payload is None:
                    if c2s.closed or self._closed:
                        return
                    continue
                try:
                    req = wire.decode_payload(payload)
                except ConnectionError:
                    return
                op = req.get("op")
                rid = req.get("id")
                try:
                    if op == "submit":
                        fut = self.scorer.submit(req["tenant"], req["raw"])
                        resolver.enqueue(rid, fut)
                    elif op == "submit_many":
                        tenant = req["tenant"]
                        for eid, raw in zip(req["ids"], req["raws"]):
                            try:
                                fut = self.scorer.submit(tenant, raw)
                                resolver.enqueue(eid, fut)
                            except Exception as e:
                                reply([{"id": eid,
                                        "error": repr(e)[:300]}])
                    else:
                        reply({"id": rid,
                               "error": f"op {op!r} is control-path "
                                        "only; rings carry data frames"})
                except OSError:
                    return
                except Exception as e:
                    try:
                        reply({"id": rid, "error": repr(e)[:300]})
                    except OSError:
                        return
        finally:
            resolver.stop()
            c2s.close()
            s2c.close()

    def _op_add_tenant(self, req: dict) -> dict:
        """Idempotent placement push: the first call registers the
        tenant, publishes its model and opens its admission lane; a
        repeat (failover re-push, shadow backfill) republishes only when
        the router's version moved."""
        spec = TenantSpec(**req["spec"])
        known = spec.tenant in self.fleet.tenants()
        if not known:
            self.fleet.add_tenant(spec)
        # The registry's version counts this replica's own publishes;
        # the router's growing router_version decides whether this push
        # carries news (a failover re-push of a model the shadow already
        # holds must not churn the stack).
        want = int(req.get("router_version", 1))
        with self._lock:
            have = self._router_versions.get(spec.tenant, 0)
            fresh = not known or have < want
        published = False
        if fresh:
            self.fleet.publish(spec.tenant, req["model"],
                               req.get("source", "router"))
            published = True
            # Recorded only after the publish lands: a failed first
            # publish leaves the version unclaimed, so the router's
            # re-push publishes again.
            with self._lock:
                self._router_versions[spec.tenant] = want
        if spec.tenant not in self.scorer._lanes:
            # The router sends a day-dir featurizer as its cuts and
            # top-domains table.
            fz = featurizer_for(spec.dsource, req["cuts"],
                                req.get("top_domains", ()))
            self.scorer.add_tenant(spec, fz)
        return {"ok": True, "published": published,
                "version": self.fleet.version(spec.tenant)}

    def _op_warmup(self) -> list:
        """Warm the device path of every stacked shape this replica
        hosts (plans/warmup.warmup_serving, the sizes `ml_ops serve
        --fleet` warms), so a shadow's first flush after a promotion
        finds its launches and allocator blocks ready.  A failure
        raises (the op answers an error): it never hides the card."""
        from ..plans.warmup import warmup_serving
        from ..sources import get as get_source

        out = []
        for k in sorted({self.fleet.tenant_k(t)
                         for t in self.fleet.tenants()}):
            stack = self.fleet.stack(k)
            mult = max(get_source(self.fleet.spec(t).dsource).pairs_per_event
                       for t in stack.tenants)
            out.append({"k": k, "tenants": len(stack.tenants),
                        **warmup_serving(stack.model,
                                         self.scorer.max_batch * mult,
                                         self.config.device_score_min,
                                         device=self.device)})
        return out

    def _op_stats(self) -> dict:
        """Counters read in this process: scored totals, the build
        counters, the device, and on the card its peak allocated
        bytes."""
        import torch

        from ..plans.warmup import compile_counts

        out = {
            "replica": self.replica_id,
            "pid": os.getpid(),
            "device": str(self.device),
            "events_scored": self.scorer.events_scored,
            "batches_flushed": self.scorer.batches_flushed,
            "tenants": sorted(self.fleet.tenants()),
            "pending": self._pending_events(),
            "draining": self._draining,
            "fleet_counts": dict(self.scorer.counts),
            "compile": compile_counts(),
        }
        if self.device.type == "cuda":
            out["cuda_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(self.device))
        return out

    def _pending_events(self) -> int:
        with self.scorer._cond:
            return sum(len(l.pending) for l in self.scorer._lanes.values())

    def _op_drain(self, timeout_s: float) -> dict:
        """Rolling-redeploy step: flush and wait until every admitted
        event has resolved and its response frame is queued out; after
        the reply the router may stop routing here and tear the process
        down with nothing in flight."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout_s
        self.scorer.flush()
        while time.monotonic() < deadline:
            with self._lock:
                resolvers = list(self._resolvers)
            if (self._pending_events() == 0
                    and all(r.pending() == 0 for r in resolvers)):
                return {"ok": True, "drained": True,
                        "events_scored": self.scorer.events_scored}
            self.scorer.flush()
            time.sleep(0.005)
        return {"ok": False, "drained": False,
                "pending": self._pending_events()}

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        """Graceful stop: deregister, stop heartbeats, close the scorer
        (draining queued events), close sockets.  After kill() it only
        closes the scorer the kill left running."""
        with self._lock:
            was_closed = self._closed
            self._closed = True
            conns = list(self._conns)
            rings = list(self._rings)
        if was_closed:
            self.scorer.close(timeout=self.config.route_op_timeout_s)
            return
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if self._membership is not None:
            try:
                self._membership.deregister(self.replica_id)
            except Exception:
                pass
        _hard_close(self._srv)
        self.scorer.close(timeout=self.config.route_op_timeout_s)
        for c in conns:
            _hard_close(c)
        for r in rings:
            r.close()
        self.stopped.set()

    def kill(self) -> None:
        """Abrupt death for chaos tests: close every socket now, skip the
        drain, leave queued futures unresolved: what SIGKILL does to a
        replica process, minus the process.  In-flight events are what
        the router's admission journal must replay.  The scorer is left
        running as a killed process would leave it; `stop()` afterwards
        closes it."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
            rings = list(self._rings)
        if self._heartbeat is not None:
            self._heartbeat.stop()
        _hard_close(self._srv)
        for c in conns:
            _hard_close(c)
        for r in rings:
            r.close()
        self.stopped.set()
