"""The port's TCP KV control plane (oni_ml_tpu_torch/parallel/
membership.py `KVServer`, `TcpKVClient`) against the JAX package's, on
the CPU.

A port client against the JAX server and a JAX client against the port
server give the same replies, op for op, to set, get, delete and list
and to each error (ALREADY_EXISTS, DEADLINE_EXCEEDED, NOT_FOUND,
UNKNOWN_OP); the raw frames the two servers answer are the same bytes;
an oversized frame is refused; MembershipClient runs over TCP as the
JAX test runs it over the file KV (tests/test_router.py:183).

Servers listen on 127.0.0.1:0; every server, client and thread is
closed in a finally, and every wait has its own timeout."""

import socket
import struct
import threading
import time

import pytest

from oni_ml_tpu.parallel import membership as jmembership
from oni_ml_tpu_torch.parallel import (HeartbeatPublisher, KVServer,
                                       MembershipClient, TcpKVClient,
                                       kv_list)
from oni_ml_tpu_torch.parallel import membership

WAIT_S = 30.0


def _outcome(fn, *args, **kw):
    """("ok", result) or ("err", message) of one client call."""
    try:
        return "ok", fn(*args, **kw)
    except RuntimeError as e:
        return "err", str(e)


def _script(kv) -> list:
    """The same sequence of ops and errors against one client."""
    return [
        _outcome(kv.key_value_set, "a/b", "one"),
        _outcome(kv.blocking_key_value_get, "a/b", 100),
        _outcome(kv.key_value_set, "a/b", "two"),
        _outcome(kv.key_value_set, "a/b", "two", allow_overwrite=True),
        _outcome(kv.key_value_set, "a/c", "three"),
        _outcome(kv.key_value_set, "z", "zed"),
        _outcome(kv.key_value_list, "a/"),
        _outcome(kv_list, kv, ""),
        _outcome(kv.key_value_delete, "a/b"),
        _outcome(kv.key_value_delete, "a/b"),      # idempotent
        _outcome(kv.blocking_key_value_get, "a/b", 30),
        _outcome(kv.key_value_list, "a/"),
        _outcome(kv.key_value_set, "ü/ключ", "värde ✓"),
        _outcome(kv.blocking_key_value_get, "ü/ключ", 100),
    ]


@pytest.mark.parametrize("pairing", ["port_client_jax_server",
                                     "jax_client_port_server"])
def test_tcp_kv_replies_match_across_packages(pairing):
    """Each package's client against the other's server gives the replies
    of the JAX client against the JAX server."""
    jserver = jmembership.KVServer()
    server = (jmembership.KVServer() if pairing.startswith("port")
              else KVServer())
    client_cls = (TcpKVClient if pairing.startswith("port")
                  else jmembership.TcpKVClient)
    ref = jmembership.TcpKVClient(jserver.host, jserver.port)
    kv = client_cls(server.host, server.port)
    try:
        want, got = _script(ref), _script(kv)
        assert got == want
        assert want[2] == ("err", "ALREADY_EXISTS: a/b")
        assert want[10] == ("err", "DEADLINE_EXCEEDED: a/b")
        assert want[6] == ("ok", {"a/b": "two", "a/c": "three"})
    finally:
        kv.close()
        ref.close()
        server.close()
        jserver.close()


def _raw(host, port, frames: list) -> list:
    """Send raw length-prefixed payloads; the raw replies, in order."""
    out = []
    with socket.create_connection((host, port), timeout=WAIT_S) as s:
        for payload in frames:
            s.sendall(struct.pack("!I", len(payload)) + payload)
            head = b""
            while len(head) < 4:
                chunk = s.recv(4 - len(head))
                assert chunk
                head += chunk
            (n,) = struct.unpack("!I", head)
            body = b""
            while len(body) < n:
                chunk = s.recv(n - len(body))
                assert chunk
                body += chunk
            out.append(body)
    return out


def test_tcp_kv_servers_answer_the_same_bytes():
    """Raw frames, the error ones included (NOT_FOUND, UNKNOWN_OP), get
    byte-identical answers from the two servers."""
    frames = [b'{"op":"set","key":"k","value":"v"}',
              b'{"op":"set","key":"k","value":"w"}',
              b'{"op":"get","key":"k"}',
              b'{"op":"get","key":"missing"}',
              b'{"op":"list","prefix":"k"}',
              b'{"op":"delete","key":"k"}',
              b'{"op":"frobnicate","key":"k"}',
              b'{"key":"k"}']
    servers = [KVServer(), jmembership.KVServer()]
    try:
        port_rsp, jax_rsp = (_raw(s.host, s.port, frames) for s in servers)
        assert port_rsp == jax_rsp
        assert b"NOT_FOUND: missing" in port_rsp[3]
        assert b"UNKNOWN_OP: frobnicate" in port_rsp[6]
    finally:
        for s in servers:
            s.close()


def test_tcp_kv_refuses_an_oversized_frame():
    """A frame announcing more than 16 MiB is refused before it is read:
    the server drops the connection, and the client's reader raises the
    JAX package's ConnectionError."""
    assert membership._KV_MAX_FRAME == jmembership._KV_MAX_FRAME == 16 << 20
    server = KVServer()
    try:
        with socket.create_connection((server.host, server.port),
                                      timeout=WAIT_S) as s:
            s.sendall(struct.pack("!I", (16 << 20) + 1))
            assert s.recv(4) == b""          # dropped, nothing answered
        # The server still serves other connections.
        kv = TcpKVClient(server.host, server.port)
        try:
            kv.key_value_set("k", "v")
            assert kv.blocking_key_value_get("k", 100) == "v"
        finally:
            kv.close()
    finally:
        server.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", (16 << 20) + 1))
        with pytest.raises(ConnectionError, match="oversized KV frame"):
            membership._kv_recv(b)
    finally:
        a.close()
        b.close()


def test_tcp_kv_blocking_get_sees_a_concurrent_writer():
    server = KVServer()
    kv = TcpKVClient(server.host, server.port)
    writer = TcpKVClient(server.host, server.port)
    got = {}
    try:
        def reader():
            got["v"] = kv.blocking_key_value_get("late", 10_000)

        th = threading.Thread(target=reader)
        th.start()
        time.sleep(0.05)
        writer.key_value_set("late", "arrived")
        th.join(timeout=WAIT_S)
        assert not th.is_alive()
        assert got["v"] == "arrived"
    finally:
        writer.close()
        kv.close()
        server.close()


def test_kv_server_binds_loopback_unless_told():
    server = KVServer()
    try:
        assert server.host == "127.0.0.1" and server.port > 0
    finally:
        server.close()
    assert membership.parse_hostport(":0", default_port=0) == \
        ("127.0.0.1", 0)
    assert membership.parse_hostport("", default_port=0) == \
        ("127.0.0.1", 0)
    assert membership.parse_hostport("10.0.0.5:7000") == ("10.0.0.5", 7000)
    with pytest.raises(ValueError, match="HOST:PORT"):
        membership.parse_hostport("10.0.0.5")


def test_kv_server_close_ends_its_connections():
    server = KVServer()
    kv = TcpKVClient(server.host, server.port)
    try:
        kv.key_value_set("k", "v")
        server.close()
        with pytest.raises((ConnectionError, OSError)):
            kv.key_value_set("k", "w", allow_overwrite=True)
    finally:
        kv.close()
        server.close()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_membership_over_tcp_kv(server_pkg):
    """tests/test_router.py:183's roster, heartbeat and fail-relay run,
    over a TCP KV instead of the file KV; a JAX MembershipClient over
    the same server reads the port's records."""
    server = KVServer() if server_pkg == "port" else jmembership.KVServer()
    kv = TcpKVClient(server.host, server.port)
    jkv = jmembership.TcpKVClient(server.host, server.port)
    try:
        m = MembershipClient(kv, "oni/testfleet")
        jm = jmembership.MembershipClient(jkv, "oni/testfleet")
        m.register("r0", {"port": 1})
        m.register("r1", {"port": 2})
        assert set(m.members()) == {"r0", "r1"}
        assert m.members()["r1"]["meta"]["port"] == 2
        assert jm.members() == m.members()
        hb = HeartbeatPublisher(m, "r0", 0.03)
        try:
            deadline = time.monotonic() + WAIT_S
            while (m.heartbeats().get("r0", {}).get("seq", 0) < 2
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert m.heartbeats()["r0"]["seq"] >= 2
            assert "r0" in m.alive(5.0)
            assert "r1" not in m.alive(5.0)     # never beat
            assert "r0" in jm.alive(5.0)
        finally:
            hb.stop()
        m.fail("r0", "injected wedge")
        assert m.failures()["r0"]["reason"] == "injected wedge"
        assert jm.failures() == m.failures()
        m.clear_failure("r0")
        assert m.failures() == {}
        assert m.claim_promotion("r1", "ra") is True
        assert jm.claim_promotion("r1", "rb") is False
        m.clear_promotion("r1")
        assert jm.claim_promotion("r1", "rb") is True
        m.deregister("r0")
        assert set(m.members()) == {"r1"}
    finally:
        jkv.close()
        kv.close()
        server.close()
