"""The port's same-host shared-memory rings (oni_ml_tpu_torch/serving/
wire.py `ShmRing`, the replica's and router's ring code) against the JAX
package's, on the CPU.

A port ring and a JAX ring attach to each other's segments and carry
frames both ways; the ring's own contracts are the JAX tests'
(tests/test_wire.py:310-436): wraparound and slab reuse, a concurrent
columnar stress, a stuck seqlock that times out, a close that unblocks
the peer, rings torn down with the hello's connection.  A port router
over port replicas on the CPU scores the same events with `wire_shm` on
and off, bit for bit, and leaves no segment behind.

Every wait has its own timeout (a ring pop's, a thread join's, a
future's), and every ring, router and replica is closed in a finally.
Tolerances: frames and scores are compared for equality; scores take
the float64 host path (device_score_min=None)."""

import os
import socket
import threading
import time

import numpy as np
import pytest

from oni_ml_tpu.serving import ShmRing as JShmRing
from oni_ml_tpu.serving import wire as jwire
from oni_ml_tpu_torch.config import ServingConfig
from oni_ml_tpu_torch.runner import serve
from oni_ml_tpu_torch.serving import (DnsEventFeaturizer, FleetRouter,
                                      ReplicaServer, ShmRing, TenantSpec,
                                      decode_payload, encode_payload,
                                      score_features)
from oni_ml_tpu_torch.serving import wire

CPU = "cpu"
WAIT_S = 30.0


def _present(names) -> set:
    """Those of the shared-memory segments `names` that still exist
    (Linux: /dev/shm).  Only the segments a test made are looked at:
    other processes make and drop their own."""
    return {n for n in names if os.path.exists(os.path.join("/dev/shm", n))}


def _wait_until(pred, timeout_s: float = WAIT_S):
    deadline = time.monotonic() + timeout_s
    while True:
        v = pred()
        if v or time.monotonic() >= deadline:
            return v
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# the ring across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("owner", ["port", "jax"])
def test_ring_crosses_packages_both_ways(owner):
    """One package creates the segment, the other attaches: frames pushed
    on either side pop on the other, in order and intact, and the header
    constants are the JAX package's."""
    assert (wire._RING_HDR, wire._RING_MAGIC, wire.WIRE_VERSION) == \
        (jwire._RING_HDR, jwire._RING_MAGIC, jwire.WIRE_VERSION)
    assert (wire._OFF_PSEQ, wire._OFF_WSEQ, wire._OFF_LEN0, wire._OFF_LEN1,
            wire._OFF_CSEQ, wire._OFF_RSEQ, wire._OFF_CLOSED) == \
        (jwire._OFF_PSEQ, jwire._OFF_WSEQ, jwire._OFF_LEN0, jwire._OFF_LEN1,
         jwire._OFF_CSEQ, jwire._OFF_RSEQ, jwire._OFF_CLOSED)
    made, attach = (ShmRing, JShmRing) if owner == "port" \
        else (JShmRing, ShmRing)
    rng = np.random.default_rng(7)
    # Two rings, one a direction, as a hello negotiates them.
    fwd = made.create(slab_bytes=2048)
    back = made.create(slab_bytes=2048)
    fwd_peer = attach.attach(fwd.name, 2048)
    back_peer = attach.attach(back.name, 2048)
    try:
        for i in range(9):      # past two slabs: the seqlock wraps
            a = bytes(rng.integers(0, 256, size=int(rng.integers(0, 2048)),
                                   dtype=np.uint8))
            assert fwd.push(a, timeout_s=WAIT_S)
            assert fwd_peer.pop(timeout_s=WAIT_S) == a
            msg = [{"id": 100 * i + j, "score": float(rng.random()),
                    "version": i} for j in range(5)]
            assert back_peer.push(encode_payload(msg), timeout_s=WAIT_S)
            got = back.pop(timeout_s=WAIT_S)
            assert decode_payload(got) == msg
            assert jwire.decode_payload(got) == msg
        fwd.close()
        assert fwd_peer.closed and fwd_peer.pop(timeout_s=0.2) is None
    finally:
        for r in (fwd_peer, back_peer, fwd, back):
            r.close()


def test_ring_attach_refuses_a_foreign_segment():
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(create=True, size=4096)
    try:
        with pytest.raises(ConnectionError, match="not a ring"):
            ShmRing.attach(shm.name, 1024)
        shm.buf[:4] = b"OCWR"
        shm.buf[4] = wire.WIRE_VERSION + 1
        with pytest.raises(ConnectionError, match="version mismatch"):
            ShmRing.attach(shm.name, 1024)
        shm.buf[4] = wire.WIRE_VERSION
        with pytest.raises(ConnectionError, match="too few"):
            ShmRing.attach(shm.name, 4096)
    finally:
        # Each refused attach unregistered the name from this process's
        # resource tracker (the attaching side's rule); the creator
        # registers it again before its own unlink unregisters it.
        from multiprocessing import resource_tracker

        resource_tracker.register(shm._name, "shared_memory")
        shm.close()
        shm.unlink()


# ---------------------------------------------------------------------------
# the ring's contracts (ports of tests/test_wire.py:347-436)
# ---------------------------------------------------------------------------


def test_ring_wraparound_orders_and_survives_reuse():
    """Sequence numbers run far past the two slabs: every frame arrives
    intact and in order, from empty to nearly a slab; reuse never
    overwrites an unread frame."""
    ring = ShmRing.create(slab_bytes=4096)
    peer = ShmRing.attach(ring.name, 4096)
    try:
        rng = np.random.default_rng(2)
        sizes = [int(s) for s in rng.integers(0, 4000, size=64)]
        payloads = [bytes(rng.integers(0, 256, size=s, dtype=np.uint8))
                    for s in sizes]
        got = []

        def consume():
            while len(got) < len(payloads):
                p = peer.pop(timeout_s=5.0)
                if p is None:
                    return
                got.append(p)

        t = threading.Thread(target=consume)
        t.start()
        for p in payloads:
            assert ring.push(p, timeout_s=5.0)
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
        assert got == payloads
        with pytest.raises(ValueError, match="exceeds ring slab"):
            ring.push(b"x" * 4097)
    finally:
        peer.close()
        ring.close()


def test_ring_concurrent_stress_columnar_frames():
    """Producer and consumer threads on real columnar frames: 300 score
    batches of varying size cross bit-identically while the producer
    waits on the two-slab window."""
    ring = ShmRing.create(slab_bytes=1 << 16)
    peer = ShmRing.attach(ring.name, 1 << 16)
    rng = np.random.default_rng(3)
    sent = [[{"id": 1000 * i + j, "score": float(rng.standard_normal()),
              "version": i} for j in range(int(rng.integers(1, 64)))]
            for i in range(300)]
    got = []
    try:
        def consume():
            while len(got) < len(sent):
                p = peer.pop(timeout_s=10.0)
                if p is None:
                    return
                got.append(decode_payload(p))

        t = threading.Thread(target=consume)
        t.start()
        for batch in sent:
            assert ring.push(encode_payload(batch), timeout_s=10.0)
        t.join(timeout=2 * WAIT_S)
        assert not t.is_alive()
        assert got == sent
    finally:
        peer.close()
        ring.close()


def test_ring_stuck_seqlock_times_out_and_closes():
    """A writer killed between its guard writes leaves the guard odd: the
    reader's wait is bounded, marks the ring closed, and both ends then
    return at once."""
    ring = ShmRing.create(slab_bytes=1024)
    peer = ShmRing.attach(ring.name, 1024)
    try:
        peer._SEQLOCK_STUCK_S = 0.2
        ring._write_u64(wire._OFF_PSEQ, 1)      # producer died mid-write
        t0 = time.monotonic()
        assert peer.pop(timeout_s=WAIT_S) is None
        assert time.monotonic() - t0 < 5.0
        assert peer.closed
        assert peer.pop(timeout_s=1.0) is None
        assert not ring.push(b"x", timeout_s=0.2)
    finally:
        peer.close()
        ring.close()


def test_ring_close_unblocks_peer():
    ring = ShmRing.create(slab_bytes=1024)
    peer = ShmRing.attach(ring.name, 1024)
    try:
        assert ring.push(b"last", timeout_s=1.0)
        ring.close()
        # Published frames still drain after the close...
        assert peer.pop(timeout_s=1.0) == b"last"
        # ...then the peer sees the shutdown, not a hang.
        assert peer.pop(timeout_s=1.0) is None
        assert peer.closed
        assert not peer.push(b"x", timeout_s=0.2)
    finally:
        peer.close()
        ring.close()


def test_ring_corrupt_length_closes_instead_of_reading():
    """A header announcing more bytes than a slab holds (a corrupt or
    hostile writer) closes the ring; the reader returns None."""
    ring = ShmRing.create(slab_bytes=1024)
    peer = ShmRing.attach(ring.name, 1024)
    try:
        ring._locked_write(wire._OFF_PSEQ, ((wire._OFF_LEN0, 1 << 20),
                                            (wire._OFF_WSEQ, 1)))
        assert peer.pop(timeout_s=1.0) is None
        assert peer.closed and ring.closed
    finally:
        peer.close()
        ring.close()


# ---------------------------------------------------------------------------
# the hello's rings (port of tests/test_wire.py:310)
# ---------------------------------------------------------------------------


def test_hello_rings_are_torn_down_with_their_connection():
    """Rings a connection's hello negotiated die with the connection, and
    a repeat hello replaces them: a reconnecting or killed router leaves
    no segment or polling thread on the replica."""
    names = set()
    rep = ReplicaServer("r0", ServingConfig(), device=CPU)
    try:
        hello = {"op": "hello", "wire": ["columnar"], "shm": True,
                 "host": socket.gethostname()}
        s = socket.create_connection((rep.host, rep.port), timeout=WAIT_S)
        try:
            wire.send_frame(s, {**hello, "id": 1})
            rsp = wire.recv_frame(s)
            assert rsp["shm"] is not None and rsp["wire"] == "columnar"
            assert len(rep._rings) == 2
            first = {rsp["shm"]["c2s"], rsp["shm"]["s2c"]}
            names |= first
            assert _present(first) == first
            wire.send_frame(s, {**hello, "id": 2})
            rsp2 = wire.recv_frame(s)
            assert rsp2["shm"] is not None
            assert rsp2["shm"]["c2s"] != rsp["shm"]["c2s"]
            names |= {rsp2["shm"]["c2s"], rsp2["shm"]["s2c"]}
            assert len(rep._rings) == 2
            # The replaced pair is unlinked at once.
            assert not _present(first)
            # A hello from another host, or without shm, gets none.
            wire.send_frame(s, {**hello, "id": 3, "host": "elsewhere"})
            assert wire.recv_frame(s)["shm"] is None
        finally:
            s.close()
        assert _wait_until(lambda: not rep._rings)
        assert rep._rings == []
    finally:
        rep.stop()
    assert len(names) == 4
    assert _wait_until(lambda: not _present(names))


def test_hello_without_wire_shm_stays_on_tcp():
    rep = ReplicaServer("r0", ServingConfig(wire_shm=False), device=CPU)
    try:
        s = socket.create_connection((rep.host, rep.port), timeout=WAIT_S)
        try:
            wire.send_frame(s, {"op": "hello", "id": 1,
                                "wire": ["columnar"], "shm": True,
                                "host": socket.gethostname()})
            assert wire.recv_frame(s)["shm"] is None
            assert rep._rings == []
        finally:
            s.close()
    finally:
        rep.stop()


def test_ring_frame_carrying_a_control_op_is_answered_with_an_error():
    """Rings carry data frames only: a control op pushed on the submit
    ring comes back as an error on the response ring."""
    rep = ReplicaServer("r0", ServingConfig(), device=CPU)
    try:
        s = socket.create_connection((rep.host, rep.port), timeout=WAIT_S)
        try:
            wire.send_frame(s, {"op": "hello", "id": 1,
                                "wire": ["columnar"], "shm": True,
                                "host": socket.gethostname()})
            shm = wire.recv_frame(s)["shm"]
            tx = ShmRing.attach(shm["c2s"], shm["slab"])
            rx = ShmRing.attach(shm["s2c"], shm["slab"])
            try:
                assert tx.push(encode_payload({"op": "stats", "id": 9}))
                rsp = decode_payload(rx.pop(timeout_s=WAIT_S))
                assert rsp["id"] == 9 and "control-path" in rsp["error"]
            finally:
                tx.close()
                rx.close()
        finally:
            s.close()
    finally:
        rep.stop()


# ---------------------------------------------------------------------------
# the router over rings: the same scores as over TCP
# ---------------------------------------------------------------------------


def _routed_scores(wire_shm: bool, days: dict):
    cfg = ServingConfig(fleet_max_batch=32, fleet_max_wait_ms=5.0,
                        device_score_min=None, wire_shm=wire_shm)
    replicas = {f"r{i}": ReplicaServer(f"r{i}", cfg, device=CPU)
                for i in range(2)}
    router = FleetRouter(cfg)
    try:
        for rid, rep in replicas.items():
            router.connect_replica(rid, rep.host, rep.port)
        links = router.wire()
        for t, (rows, model, cuts) in days.items():
            router.add_tenant(TenantSpec(tenant=t, dsource="dns"), cuts,
                              model)
        router.start(warmup=False)
        futs = {t: router.submit_many(t, rows[:40]) + [
            router.submit(t, r) for r in rows[40:]]
            for t, (rows, _, _) in days.items()}
        router.flush()
        scores = {t: np.array([f.result(timeout=WAIT_S)[0] for f in fs])
                  for t, fs in futs.items()}
        edges = router.stats()["edges"]
        return scores, links, edges
    finally:
        router.close()
        for rep in replicas.values():
            rep.stop()


def test_router_scores_bit_identical_with_rings_on_and_off():
    """The same events through a port router over two port replicas,
    once on shared-memory rings and once on TCP: every link took the
    transport asked for, the scores are the same bits both ways and
    equal to the host scorer's, and no segment outlives the run."""
    days = {f"t{i}": serve._synthetic_day(n_events=64, seed=900 + i)
            for i in range(3)}
    on, links_on, edges_on = _routed_scores(True, days)
    off, links_off, edges_off = _routed_scores(False, days)
    assert {r: link["shm"] for r, link in links_on.items()} == \
        {"r0": True, "r1": True}
    assert {r: link["shm"] for r, link in links_off.items()} == \
        {"r0": False, "r1": False}
    for t, (rows, model, cuts) in days.items():
        oracle = score_features(model, DnsEventFeaturizer(cuts)(rows),
                                "dns")
        np.testing.assert_array_equal(on[t], off[t])
        np.testing.assert_array_equal(on[t], oracle)
    assert sum(e["events"] for e in edges_on.values()) == \
        sum(e["events"] for e in edges_off.values()) == 3 * 64
    names = {n for link in links_on.values() for n in link["segments"]}
    assert len(names) == 4
    assert all(link["segments"] == [] for link in links_off.values())
    assert _wait_until(lambda: not _present(names))


# ---------------------------------------------------------------------------
# a ring link's sender: what queues behind a full ring leaves coalesced
# ---------------------------------------------------------------------------


def _submit(rid, tenant, raw="x"):
    return {"op": "submit", "id": rid, "tenant": tenant, "raw": raw}


@pytest.mark.parametrize("batch,frames", [
    ([_submit(1, "a")], [_submit(1, "a")]),
    ([_submit(1, "a"), _submit(2, "b"), _submit(3, "a", "y")],
     [{"op": "submit_many", "ids": [1, 3], "tenant": "a",
       "raws": ["x", "y"]}, _submit(2, "b")]),
    ([{"op": "submit_many", "ids": [1, 2], "tenant": "a",
       "raws": ["p", "q"]}, _submit(3, "a", "r")],
     [{"op": "submit_many", "ids": [1, 2, 3], "tenant": "a",
       "raws": ["p", "q", "r"]}]),
])
def test_coalesce_merges_queued_frames_a_tenant_in_order(batch, frames):
    from oni_ml_tpu_torch.serving.router import _coalesce

    assert list(_coalesce(batch)) == frames


def test_ring_link_coalesces_submits_queued_behind_a_full_ring(
        monkeypatch):
    """One `submit` a call over a ring link whose replica has not begun
    to read: the caller never waits on the two-frame ring, the sender
    sends what queued as one submit_many a tenant, and the scores are
    the host scorer's."""
    from oni_ml_tpu_torch.serving import replica as replica_mod

    go = threading.Event()
    real_serve = ReplicaServer._serve_ring

    def held_serve(self, c2s, s2c):
        assert go.wait(WAIT_S)
        real_serve(self, c2s, s2c)

    monkeypatch.setattr(ReplicaServer, "_serve_ring", held_serve)
    frames = []
    real_decode = replica_mod.wire.decode_payload

    def counting_decode(buf):
        msg = real_decode(buf)
        if isinstance(msg, dict) and msg.get("op") in ("submit",
                                                       "submit_many"):
            frames.append((msg["op"], len(msg.get("ids") or [1])))
        return msg

    monkeypatch.setattr(replica_mod.wire, "decode_payload", counting_decode)
    cfg = ServingConfig(fleet_max_batch=32, fleet_max_wait_ms=5.0,
                        device_score_min=None)
    days = {f"t{i}": serve._synthetic_day(n_events=50, seed=950 + i)
            for i in range(2)}
    rep = ReplicaServer("r0", cfg, device=CPU)
    router = FleetRouter(cfg)
    try:
        router.connect_replica("r0", rep.host, rep.port)
        assert router.wire()["r0"]["shm"] is True
        for t, (rows, model, cuts) in days.items():
            router.add_tenant(TenantSpec(tenant=t, dsource="dns"), cuts,
                              model)
        router.start(warmup=False)
        t0 = time.perf_counter()
        futs = {t: [] for t in days}
        for j in range(50):
            for t, (rows, _, _) in days.items():
                futs[t].append(router.submit(t, rows[j]))
        submit_s = time.perf_counter() - t0
        go.set()
        router.flush()
        for t, (rows, model, cuts) in days.items():
            got = np.array([f.result(timeout=WAIT_S)[0] for f in futs[t]])
            oracle = score_features(model, DnsEventFeaturizer(cuts)(rows),
                                    "dns")
            np.testing.assert_array_equal(got, oracle)
        edges = router.stats()["edges"]
    finally:
        go.set()
        router.close()
        rep.stop()
    # The 100 submits queued while nothing read the ring: they took well
    # under the push's 5-s timeout, and at most the first few frames
    # went out alone.
    assert submit_s < 5.0
    assert sum(n for _, n in frames) == 100
    assert len(frames) <= 8, frames
    assert edges["r0"]["events"] == 100 and edges["r0"]["bytes"] > 0
