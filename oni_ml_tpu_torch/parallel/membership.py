"""KV-backed membership, heartbeats and the failure relay of the
replicated serving fleet (port of oni_ml_tpu/parallel/membership.py:
`FileKVClient`, `kv_list`, `KVServer`, `TcpKVClient`, `MembershipClient`
and `HeartbeatPublisher`).

``FileKVClient``
    A same-host, cross-process KV store with the coordination-client
    surface (``key_value_set`` / ``blocking_key_value_get`` /
    ``key_value_delete``) plus ``key_value_list`` for membership
    enumeration.  One file per key (name = urlsafe base64 of the key,
    so a key never escapes the root), atomic tmp+``os.replace``
    publication, polling blocking gets that raise DEADLINE_EXCEEDED.
    `ml_ops route` coordinates its replica subprocesses through it.
    The directory's files are the JAX package's, byte for byte, so
    either package's client reads the other's.

``MembershipClient``
    register / deregister / members / heartbeat / alive / fail over
    any such KV client.  Heartbeats are wall-clock stamped (they
    compare across processes, whose monotonic clocks share no epoch)
    and carry a per-publisher sequence number.  The fail key is
    per-replica: a failing replica posts its reason, and the router's
    monitor polls failures between heartbeat checks.

``HeartbeatPublisher``
    The replica-side daemon thread that publishes liveness every
    ``interval_s`` until ``stop()``.

``KVServer`` / ``TcpKVClient``
    The cross-host transport: a small TCP KV daemon speaking
    length-prefixed JSON frames (the JAX package's frames and error
    strings: either package's client talks to the other's server), and
    a client with FileKVClient's surface.  ``ml_ops route --kv-listen``
    runs the server next to one router; replicas and other routers
    connect with ``--kv-connect host:port``.  The server binds
    127.0.0.1 unless told otherwise and has no authentication.

Records are JSON, base64-wrapped for the string-value KV convention:
the membership plane carries no pickle.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import threading
import time


class FileKVClient:
    """Directory-backed KV store satisfying the coordination-client
    interface for same-host multi-process fleets.  Values are strings
    (the coordination-client convention); a set is atomic via
    tmp+rename, so a reader never observes a torn value."""

    # Poll cadence for blocking gets: coarse enough to stay invisible
    # in CPU profiles, fine enough that a heartbeat-interval wait
    # never quantizes noticeably.
    _POLL_S = 0.005

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        name = base64.urlsafe_b64encode(key.encode("utf-8")).decode(
            "ascii")
        return os.path.join(self.root, name)

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        path = self._path(key)
        if not allow_overwrite and os.path.exists(path):
            raise RuntimeError(f"ALREADY_EXISTS: {key}")
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, path)

    def blocking_key_value_get(self, key: str,
                               timeout_in_ms: int) -> str:
        deadline = time.monotonic() + timeout_in_ms / 1000.0
        path = self._path(key)
        while True:
            try:
                with open(path) as f:
                    return f.read()
            except FileNotFoundError:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(f"DEADLINE_EXCEEDED: {key}")
            time.sleep(min(self._POLL_S, remaining))

    def key_value_delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def key_value_list(self, prefix: str) -> "dict[str, str]":
        """Every (key, value) whose key starts with `prefix` — the
        membership-enumeration extension (the in-memory test KV
        mirrors it; a coordination client spells it key_value_dir_get)."""
        out: "dict[str, str]" = {}
        for name in os.listdir(self.root):
            if name.endswith(".tmp") or ".tmp." in name:
                continue
            try:
                key = base64.urlsafe_b64decode(
                    name.encode("ascii")).decode("utf-8")
            except Exception:
                continue
            if not key.startswith(prefix):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    out[key] = f.read()
            except FileNotFoundError:
                continue
        return out


def kv_list(client, prefix: str) -> "dict[str, str]":
    """Prefix enumeration over whichever client we were handed:
    FileKVClient and in-memory test stores spell it key_value_list; a
    coordination client spells it key_value_dir_get (pair list)."""
    lister = getattr(client, "key_value_list", None)
    if lister is not None:
        return dict(lister(prefix))
    dir_get = getattr(client, "key_value_dir_get", None)
    if dir_get is not None:
        return {k: v for k, v in dir_get(prefix)}
    raise RuntimeError(
        f"KV client {type(client).__name__} supports neither "
        "key_value_list nor key_value_dir_get — membership "
        "enumeration needs one"
    )


_KVLEN = struct.Struct("!I")
_KV_MAX_FRAME = 16 << 20  # a KV value is a roster record, not a payload


def _kv_send(sock: socket.socket, obj, lock=None) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    data = _KVLEN.pack(len(payload)) + payload
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def _kv_recv(sock: socket.socket):
    buf = b""
    while len(buf) < _KVLEN.size:
        chunk = sock.recv(_KVLEN.size - len(buf))
        if not chunk:
            raise ConnectionError("KV peer closed")
        buf += chunk
    (n,) = _KVLEN.unpack(buf)
    if n > _KV_MAX_FRAME:
        raise ConnectionError(f"oversized KV frame: {n} bytes")
    parts, got = [], 0
    while got < n:
        chunk = sock.recv(min(65536, n - got))
        if not chunk:
            raise ConnectionError("KV peer closed mid-frame")
        parts.append(chunk)
        got += len(chunk)
    return json.loads(b"".join(parts).decode("utf-8"))


class KVServer:
    """A TCP daemon exposing the coordination-client KV surface to the
    whole fleet: the cross-host replacement for FileKVClient's shared
    directory.  One in-memory dict under a lock; requests are
    length-prefixed JSON frames (op/key/value), one response per
    request, one thread per connection (control traffic is a few ops per
    heartbeat interval).  Run it next to one router (``ml_ops route
    --kv-listen``); everyone else connects a TcpKVClient.

    It binds 127.0.0.1 unless the caller names a host.  The protocol has
    no authentication: on any other address, whoever reaches the port
    can read and rewrite the roster (register a replica, post a fail
    key, claim a promotion).  Nothing in it is unpickled or executed."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._store: "dict[str, str]" = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._conns: "list[socket.socket]" = []
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept, name="oni-kv-server", daemon=True)
        self._accept_thread.start()

    def _accept(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self._closed.is_set():
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="oni-kv-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._closed.is_set():
                req = _kv_recv(conn)
                _kv_send(conn, self._apply(req))
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _apply(self, req) -> dict:
        if not isinstance(req, dict):
            return {"ok": False, "err": "UNKNOWN_OP: None"}
        op = req.get("op")
        key = req.get("key", "")
        with self._lock:
            if op == "set":
                if not req.get("overwrite") and key in self._store:
                    return {"ok": False, "err": f"ALREADY_EXISTS: {key}"}
                self._store[key] = req.get("value", "")
                return {"ok": True}
            if op == "get":
                if key in self._store:
                    return {"ok": True, "value": self._store[key]}
                return {"ok": False, "err": f"NOT_FOUND: {key}"}
            if op == "delete":
                self._store.pop(key, None)
                return {"ok": True}
            if op == "list":
                prefix = req.get("prefix", "")
                return {"ok": True,
                        "items": {k: v for k, v in self._store.items()
                                  if k.startswith(prefix)}}
        return {"ok": False, "err": f"UNKNOWN_OP: {op}"}

    def close(self) -> None:
        """Stop listening and end every open connection (its client's
        next request raises ConnectionError).  Each socket is shut down
        before it is closed: a bare close from this thread wakes neither
        the accept() nor a recv() blocked on it."""
        self._closed.set()
        with self._lock:
            conns, self._conns = self._conns, []
        for sock in (self._listener, *conns):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5.0)


class TcpKVClient:
    """FileKVClient's surface over one KVServer connection.  Blocking
    gets poll client-side (same contract, same DEADLINE_EXCEEDED error),
    so the server never parks a thread per waiter.  Thread-safe: one
    socket, one lock around each request/response exchange."""

    _POLL_S = 0.005

    def __init__(self, host: str, port: int,
                 connect_timeout_s: float = 5.0) -> None:
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout_s)
        self._sock.settimeout(30.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def _call(self, req: dict) -> dict:
        with self._lock:
            _kv_send(self._sock, req)
            return _kv_recv(self._sock)

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        rsp = self._call({"op": "set", "key": key, "value": value,
                          "overwrite": bool(allow_overwrite)})
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("err", "KV set failed"))

    def blocking_key_value_get(self, key: str,
                               timeout_in_ms: int) -> str:
        deadline = time.monotonic() + timeout_in_ms / 1000.0
        while True:
            rsp = self._call({"op": "get", "key": key})
            if rsp.get("ok"):
                return rsp["value"]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(f"DEADLINE_EXCEEDED: {key}")
            time.sleep(min(self._POLL_S, remaining))

    def key_value_delete(self, key: str) -> None:
        rsp = self._call({"op": "delete", "key": key})
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("err", "KV delete failed"))

    def key_value_list(self, prefix: str) -> "dict[str, str]":
        rsp = self._call({"op": "list", "prefix": prefix})
        if not rsp.get("ok"):
            raise RuntimeError(rsp.get("err", "KV list failed"))
        return dict(rsp.get("items", {}))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def parse_hostport(spec: str, default_port: "int | None" = None):
    """``[HOST][:PORT]`` -> (host, port): an empty host is 127.0.0.1; an
    empty port is `default_port` (ValueError when that is None)."""
    host, _, port = spec.partition(":")
    if not port:
        if default_port is None:
            raise ValueError(f"{spec!r}: expected HOST:PORT")
        return host or "127.0.0.1", default_port
    return host or "127.0.0.1", int(port)


def _enc(obj) -> str:
    """JSON-in-base64: keeps the string-value KV convention of the
    coordination client while staying pickle-free (roster records are
    plain dicts of scalars, so JSON is lossless here)."""
    return base64.b64encode(
        json.dumps(obj, sort_keys=True, separators=(",", ":"))
        .encode("utf-8")).decode("ascii")


def _dec(value: str):
    return json.loads(base64.b64decode(value).decode("utf-8"))


class MembershipClient:
    """The fleet roster over one KV namespace.  Thread-safe: every
    method is a single KV op (plus a per-instance heartbeat sequence
    counter under its own lock)."""

    def __init__(self, kv, namespace: str = "oni/fleet") -> None:
        self._kv = kv
        self._ns = namespace.rstrip("/")
        self._lock = threading.Lock()
        self._hb_seq = 0

    # -- roster -----------------------------------------------------------

    def register(self, replica_id: str, meta: "dict | None" = None) -> None:
        """Announce one replica (idempotent — re-registration
        overwrites, which is what a respawned replica under the same
        id wants).  Wall-clock stamped: registration times compare
        across processes."""
        rec = {"meta": dict(meta or {}),
               "t": time.time()}
        self._kv.key_value_set(f"{self._ns}/m/{replica_id}", _enc(rec),
                               allow_overwrite=True)

    def deregister(self, replica_id: str) -> None:
        self._kv.key_value_delete(f"{self._ns}/m/{replica_id}")
        self._kv.key_value_delete(f"{self._ns}/hb/{replica_id}")

    def members(self) -> "dict[str, dict]":
        out = {}
        prefix = f"{self._ns}/m/"
        for key, value in kv_list(self._kv, prefix).items():
            try:
                out[key[len(prefix):]] = _dec(value)
            except Exception:
                continue
        return out

    # -- liveness ---------------------------------------------------------

    def heartbeat(self, replica_id: str,
                  payload: "dict | None" = None) -> None:
        with self._lock:
            self._hb_seq += 1
            seq = self._hb_seq
        rec = {"seq": seq, **(payload or {}),
               "t": time.time()}
        self._kv.key_value_set(f"{self._ns}/hb/{replica_id}", _enc(rec),
                               allow_overwrite=True)

    def heartbeats(self) -> "dict[str, dict]":
        out = {}
        prefix = f"{self._ns}/hb/"
        for key, value in kv_list(self._kv, prefix).items():
            try:
                out[key[len(prefix):]] = _dec(value)
            except Exception:
                continue
        return out

    def alive(self, ttl_s: float) -> "dict[str, dict]":
        """Members whose last heartbeat is younger than `ttl_s` (by
        THIS process's wall clock — same-host deployments share it;
        cross-host ones need NTP-grade agreement, stated in docs)."""
        now = time.time()
        return {
            rid: hb for rid, hb in self.heartbeats().items()
            if now - hb.get("t", 0.0) <= ttl_s
        }

    # -- failure relay ----------------------------------------------------

    def fail(self, replica_id: str, reason: str) -> None:
        """Post one replica's failure for every monitor poll to see —
        the serving twin of a collective's fail key.  Best-effort: the
        process is usually on its way out."""
        try:
            self._kv.key_value_set(
                f"{self._ns}/fail/{replica_id}",
                _enc({"reason": str(reason)[:500],
                      "t": time.time()}),
                allow_overwrite=True,
            )
        except Exception:
            pass

    def failures(self) -> "dict[str, dict]":
        out = {}
        prefix = f"{self._ns}/fail/"
        for key, value in kv_list(self._kv, prefix).items():
            try:
                out[key[len(prefix):]] = _dec(value)
            except Exception:
                continue
        return out

    def clear_failure(self, replica_id: str) -> None:
        self._kv.key_value_delete(f"{self._ns}/fail/{replica_id}")

    # -- promotion claims -------------------------------------------------

    def claim_promotion(self, replica_id: str, router_id: str) -> bool:
        """First-writer-wins claim on failing over `replica_id`.  With
        N routers watching the same fleet, every one of them sees the
        same dead link; exactly one should re-push tenant state to the
        promoted successors.  The claim is an overwrite-forbidden set —
        the KV's ALREADY_EXISTS is the election: True means this router
        owns the backfill, False means a peer already claimed it (the
        loser still promotes locally, placement being a pure function
        of membership, and just skips the pushes).

        Only a genuine ALREADY_EXISTS loses the election.  A transport
        error (KV server unreachable or timing out — likely in exactly
        the degraded scenario failover exists for) claims by DEFAULT:
        if every router treated it as a loss, none would push the
        promoted tenants' models and the new primaries would serve
        nothing.  Duplicate pushes are safe (replica add_tenant is
        router_version-idempotent); zero pushes are silent data-path
        loss."""
        try:
            self._kv.key_value_set(
                f"{self._ns}/promote/{replica_id}",
                _enc({"router": router_id,
                      "t": time.time()}),
                allow_overwrite=False,
            )
            return True
        except Exception as e:
            if "ALREADY_EXISTS" in str(e):
                return False
            return True

    def clear_promotion(self, replica_id: str) -> None:
        """Forget a settled claim so a future respawn under the same id
        can fail over again (called when a router [re]connects the
        replica)."""
        self._kv.key_value_delete(f"{self._ns}/promote/{replica_id}")


class HeartbeatPublisher:
    """Replica-side liveness daemon: publish a heartbeat every
    `interval_s` until stop().  `payload_fn` (optional) contributes
    live stats to each beat (queue depth, events scored) so the
    router's monitor reads load without an extra RPC."""

    def __init__(self, membership: MembershipClient, replica_id: str,
                 interval_s: float, payload_fn=None) -> None:
        self._membership = membership
        self._replica_id = replica_id
        self._interval_s = interval_s
        self._payload_fn = payload_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"oni-hb-{replica_id}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                payload = self._payload_fn() if self._payload_fn else None
            except Exception:
                # The payload hook is the publisher's health gate: a
                # raise means the replica declared itself unhealthy
                # (serving/replica.py posts the fail key first) — stop
                # beating, so the heartbeat SILENCE corroborates the
                # fail key instead of contradicting it.
                return
            try:
                self._membership.heartbeat(self._replica_id, payload)
            except Exception:
                # A failed beat is indistinguishable from a late one to
                # the monitor; keep trying until stopped.
                pass
            self._stop.wait(self._interval_s)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
