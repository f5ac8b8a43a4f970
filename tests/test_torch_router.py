"""The port's replicated serving core (oni_ml_tpu_torch/serving/
placement.py, replica.py, router.py, parallel/membership.py and the
FleetScorer's dynamic lanes) against the JAX package's, on the CPU: the
same seeded tenant days, manifests and events through both.

Every replica here runs in-process on the CPU and listens on
127.0.0.1:0; every router, replica and thread is closed in a finally.
Waits poll a condition (a failover record, a heartbeat sequence, a fail
key), each with a cap far above its expected time.

Tolerances: placement, KV files and membership records are identical
to the JAX package's.  Routed scores take the float64 host path
(device_score_min=None), so they are bit-equal to the port's
single-process host scorer; against the JAX router's scores for the
same events they are held within rel 1e-6, the bound
tests/test_torch_fleet.py uses for the fleet."""

import math
import os
import threading
import time

import numpy as np
import pytest

from oni_ml_tpu.config import ServingConfig as JServingConfig
from oni_ml_tpu.parallel import membership as jmembership
from oni_ml_tpu.runner import serve as jserve
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.serving import FleetRouter as JFleetRouter
from oni_ml_tpu.serving import ReplicaServer as JReplicaServer
from oni_ml_tpu.serving import TenantSpec as JTenantSpec
from oni_ml_tpu.serving import placement as jplacement
from oni_ml_tpu_torch.config import ServingConfig
from oni_ml_tpu_torch.parallel import membership
from oni_ml_tpu_torch.parallel.membership import (FileKVClient,
                                                  HeartbeatPublisher,
                                                  MembershipClient, kv_list)
from oni_ml_tpu_torch.runner import serve
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.serving import (DnsEventFeaturizer, FleetRouter,
                                      ReplicaLink, ReplicaServer, TenantSpec,
                                      load_by_replica, moved_primaries, place,
                                      placement, score_features, shadow_for)
from oni_ml_tpu_torch.serving.placement import preference, stable_hash

CPU = "cpu"
RTOL = 1e-6
WAIT_S = 30.0


def _wait_until(pred, timeout_s: float = WAIT_S):
    """Poll `pred` until it is truthy (or the cap passes); returns its
    last value."""
    deadline = time.monotonic() + timeout_s
    while True:
        v = pred()
        if v or time.monotonic() >= deadline:
            return v
        time.sleep(0.01)


def _tenants(n):
    return [f"t{i}" for i in range(n)]


def _replicas(n):
    return [f"r{i}" for i in range(n)]


def _flat(pl: dict) -> dict:
    return {t: (p.primary, p.shadow) for t, p in pl.items()}


# ---------------------------------------------------------------------------
# placement: identical to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rep", range(1, 9))
def test_placement_identical_to_jax_with_join_and_leave(n_rep):
    reps = _replicas(n_rep)
    for n_ten in (1, 2, 3, 7, 16, 33, 64):
        ts = _tenants(n_ten)
        got, want = place(ts, reps), jplacement.place(ts, reps)
        assert _flat(got) == _flat(want)
        assert load_by_replica(got) == jplacement.load_by_replica(want)
        assert max(load_by_replica(got).values()) <= math.ceil(n_ten / n_rep)
        # Join one replica, then lose one: the moves match too.
        joined = reps + ["rj"]
        gj, wj = place(ts, joined), jplacement.place(ts, joined)
        assert _flat(gj) == _flat(wj)
        assert moved_primaries(got, gj) == \
            jplacement.moved_primaries(want, wj)
        if n_rep > 1:
            left = reps[1:]
            gl, wl = place(ts, left), jplacement.place(ts, left)
            assert _flat(gl) == _flat(wl)
            assert moved_primaries(got, gl) == \
                jplacement.moved_primaries(want, wl)
        for t in ts[:8]:
            assert preference(t, reps) == jplacement.preference(t, reps)
            for excl in ({reps[0]}, set(reps[:2]), set()):
                assert shadow_for(t, reps, exclude=excl) == \
                    jplacement.shadow_for(t, reps, exclude=excl)
        if n_rep > 1:
            assert all(p.shadow not in (None, p.primary)
                       for p in got.values())


def test_stable_hash_and_placement_errors_identical_to_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        parts = ["".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 6))
                 for _ in range(int(rng.integers(1, 4)))]
        assert stable_hash(*parts) == jplacement.stable_hash(*parts)
    for args in ((_tenants(3), []), (["a", "a"], _replicas(2))):
        with pytest.raises(ValueError) as got:
            place(*args)
        with pytest.raises(ValueError) as want:
            jplacement.place(*args)
        assert str(got.value) == str(want.value)
    assert shadow_for("t3", ["r0"], exclude={"r0"}) is None
    assert placement.Placement("a", None) == placement.Placement("a", None)


# ---------------------------------------------------------------------------
# file KV + membership: the same files as the JAX package's
# ---------------------------------------------------------------------------


def _dir_files(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            out[name] = f.read()
    return out


def _kv_ops(kv) -> list:
    """The same operations on either package's client; returns what
    each step answered (values, lists, errors)."""
    seen = []
    kv.key_value_set("a/b", "one")
    seen.append(kv.blocking_key_value_get("a/b", 10))
    try:
        kv.key_value_set("a/b", "two")
    except RuntimeError as e:
        seen.append(str(e))
    kv.key_value_set("a/b", "two", allow_overwrite=True)
    kv.key_value_set("a/c", "three")
    kv.key_value_set("z", "zed")
    kv.key_value_set("oni/fleet/m/ré plica 1", "ünïcode / key")
    seen.append(kv.key_value_list("a/"))
    kv.key_value_delete("a/c")
    kv.key_value_delete("a/c")          # idempotent
    try:
        kv.blocking_key_value_get("a/c", 20)
    except RuntimeError as e:
        seen.append(str(e))
    return seen


def test_file_kv_files_identical_to_jax_and_cross_read(tmp_path):
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    seen = _kv_ops(FileKVClient(port))
    assert seen == _kv_ops(jmembership.FileKVClient(jax))
    assert seen[1] == "ALREADY_EXISTS: a/b"
    assert seen[3] == "DEADLINE_EXCEEDED: a/c"
    assert _dir_files(port) == _dir_files(jax)
    # Each package's client reads the other's directory.
    assert kv_list(FileKVClient(jax), "") == \
        jmembership.kv_list(jmembership.FileKVClient(port), "")
    assert FileKVClient(jax).blocking_key_value_get(
        "oni/fleet/m/ré plica 1", 10) == "ünïcode / key"


def test_file_kv_blocked_get_is_satisfied_by_a_writer(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    got = {}
    started = threading.Event()

    def reader():
        started.set()
        got["v"] = kv.blocking_key_value_get("late", int(WAIT_S * 1e3))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        assert started.wait(WAIT_S)
        # The writer comes from the other package: the same file.
        jmembership.FileKVClient(str(tmp_path / "kv")).key_value_set(
            "late", "arrived")
    finally:
        th.join(WAIT_S)
    assert got["v"] == "arrived"


def _strip_t(recs: dict) -> dict:
    return {k: {f: v for f, v in r.items() if f != "t"}
            for k, r in recs.items()}


def test_membership_records_cross_read_with_jax(tmp_path):
    """A roster, heartbeats and fail keys written by one package read
    back the same through the other's client (wall stamps aside)."""
    kvd = str(tmp_path / "kv")
    pm = MembershipClient(FileKVClient(kvd), "oni/x")
    jm = jmembership.MembershipClient(jmembership.FileKVClient(kvd), "oni/x")
    pm.register("r0", {"host": "127.0.0.1", "port": 5})
    jm.register("r1", {"host": "127.0.0.1", "port": 6})
    pm.heartbeat("r0", {"events_scored": 3})
    jm.heartbeat("r1", {"events_scored": 4})
    pm.fail("r0", "backend lost")
    for reader in (pm, jm):
        assert _strip_t(reader.members()) == {
            "r0": {"meta": {"host": "127.0.0.1", "port": 5}},
            "r1": {"meta": {"host": "127.0.0.1", "port": 6}}}
        assert _strip_t(reader.heartbeats()) == {
            "r0": {"seq": 1, "events_scored": 3},
            "r1": {"seq": 1, "events_scored": 4}}
        assert _strip_t(reader.failures()) == {
            "r0": {"reason": "backend lost"}}
    assert set(pm.alive(60.0)) == set(jm.alive(60.0)) == {"r0", "r1"}
    # First-writer-wins promotion claims across the two packages.
    assert pm.claim_promotion("r0", "router-a") is True
    assert jm.claim_promotion("r0", "router-b") is False
    jm.clear_promotion("r0")
    assert pm.claim_promotion("r0", "router-c") is True
    jm.deregister("r0")
    assert set(pm.members()) == {"r1"}


def test_membership_roster_heartbeats_fail_relay(tmp_path):
    kv = FileKVClient(str(tmp_path / "kv"))
    m = MembershipClient(kv, "oni/testfleet")
    m.register("r0", {"port": 1})
    m.register("r1", {"port": 2})
    assert set(m.members()) == {"r0", "r1"}
    assert m.members()["r1"]["meta"]["port"] == 2
    hb = HeartbeatPublisher(m, "r0", 0.02)
    try:
        assert _wait_until(
            lambda: m.heartbeats().get("r0", {}).get("seq", 0) >= 2)
        assert "r0" in m.alive(WAIT_S)
        assert "r1" not in m.alive(WAIT_S)     # never beat
    finally:
        hb.stop()
    m.fail("r0", "injected wedge")
    assert m.failures()["r0"]["reason"] == "injected wedge"
    m.clear_failure("r0")
    assert m.failures() == {}
    m.deregister("r0")
    assert set(m.members()) == {"r1"}
    with pytest.raises(RuntimeError, match="neither"):
        membership.kv_list(object(), "x")


# ---------------------------------------------------------------------------
# router + replicas end to end (in-process, real sockets), port vs JAX
# ---------------------------------------------------------------------------


def _cfg(jax: bool, **kw):
    cls = JServingConfig if jax else ServingConfig
    return cls(fleet_max_batch=32, fleet_max_wait_ms=5.0,
               device_score_min=None, **kw)


class _Fleet:
    """N in-process replicas + a router + T synthetic DNS tenants of one
    package, started; close() tears everything down."""

    def __init__(self, jax: bool, n_rep: int = 3, n_ten: int = 6,
                 seed0: int = 200, cfg=None, kv=None, start=True) -> None:
        self.jax = jax
        cfg = cfg or _cfg(jax)
        self.replicas = {}
        self.router = (JFleetRouter if jax else FleetRouter)(cfg, kv=kv)
        self.days = {}
        try:
            for i in range(n_rep):
                rid = f"r{i}"
                self.replicas[rid] = (JReplicaServer(rid, cfg, kv=kv)
                                      if jax else
                                      ReplicaServer(rid, cfg, kv=kv,
                                                    device=CPU))
                rep = self.replicas[rid]
                self.router.connect_replica(rid, rep.host, rep.port)
            spec = JTenantSpec if jax else TenantSpec
            day = jserve._synthetic_day if jax else serve._synthetic_day
            for i in range(n_ten):
                t = f"t{i}"
                self.days[t] = day(n_events=48, seed=seed0 + i)
                rows, model, cuts = self.days[t]
                self.router.add_tenant(spec(tenant=t, dsource="dns"), cuts,
                                       model)
            if start:
                self.router.start(warmup=False)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        self.router.close()
        for rep in self.replicas.values():
            rep.stop()


@pytest.fixture()
def fleet3():
    f = _Fleet(jax=False)
    try:
        yield f
    finally:
        f.close()


@pytest.fixture()
def jfleet3():
    f = _Fleet(jax=True)
    try:
        yield f
    finally:
        f.close()


def _oracle(days, t, rows):
    _, model, cuts = days[t]
    return score_features(model, DnsEventFeaturizer(cuts)(rows), "dns")


def _scores(futs):
    return np.array([f.result(timeout=WAIT_S)[0] for f in futs])


def _submit_both(f: _Fleet, lo: int, hi: int, mid: int) -> dict:
    """Single submits for rows [lo, mid), one submit_many for [mid, hi)."""
    out = {}
    for t, (rows, _, _) in f.days.items():
        out[t] = [f.router.submit(t, r) for r in rows[lo:mid]]
        out[t] += f.router.submit_many(t, rows[mid:hi])
    f.router.flush()
    return out


def test_router_score_parity_submit_and_submit_many(fleet3, jfleet3):
    """Routed scores, from single submits and from a chunked submit_many
    with batched responses, are bit-equal to the port's host scorer and
    within rel 1e-6 of the JAX router's for the same events; the two
    routers place the census identically."""
    assert _flat(fleet3.router.placement()) == \
        _flat(jfleet3.router.placement())
    futs = _submit_both(fleet3, 0, 44, 20)
    jfuts = _submit_both(jfleet3, 0, 44, 20)
    for t, fs in futs.items():
        got = _scores(fs)
        np.testing.assert_array_equal(
            got, _oracle(fleet3.days, t, fleet3.days[t][0][:44]))
        np.testing.assert_allclose(got, _scores(jfuts[t]), rtol=RTOL,
                                   atol=0)
    for p in fleet3.router.placement().values():
        assert p.shadow is not None and p.shadow != p.primary
    stats = fleet3.router.stats()
    assert sum(e["events"] for e in stats["edges"].values()) \
        == sum(len(fs) for fs in futs.values())
    assert set(stats) == set(jfleet3.router.stats())


def _kill_and_check(f: _Fleet):
    placement_before = f.router.placement()
    victim = placement_before["t0"].primary
    futs = {t: [f.router.submit(t, r) for r in f.days[t][0][:30]]
            for t in f.days}
    f.replicas[victim].kill()
    f.router.flush()
    scores = {t: _scores(fs) for t, fs in futs.items()}
    fos = _wait_until(lambda: f.router.stats()["failovers"])
    return victim, placement_before, scores, fos


def test_router_kill_replica_zero_failed_futures(fleet3, jfleet3):
    """Kill a replica with events in flight: zero failed futures (the
    admission journal replays the victims onto the promoted shadows),
    the promoted primary is the old shadow, tenants that never touched
    the dead replica stay put, and the new placement is the JAX
    router's after the same kill."""
    victim, old, scores, fos = _kill_and_check(fleet3)
    jvictim, _, jscores, jfos = _kill_and_check(jfleet3)
    assert victim == jvictim
    new = fleet3.router.placement()
    assert _flat(new) == _flat(jfleet3.router.placement())
    for t in fleet3.days:
        np.testing.assert_array_equal(
            scores[t], _oracle(fleet3.days, t, fleet3.days[t][0][:30]))
        np.testing.assert_allclose(scores[t], jscores[t], rtol=RTOL, atol=0)
        if old[t].primary == victim:
            assert new[t].primary == old[t].shadow
        else:
            assert new[t].primary == old[t].primary
        assert victim not in (new[t].primary, new[t].shadow)
        assert new[t].shadow != new[t].primary
    assert len(fos) == len(jfos) == 1
    assert fos[0]["resend_failures"] == 0
    assert fos[0]["promoted"] == jfos[0]["promoted"]
    assert set(fos[0]) == set(jfos[0])
    # Traffic after the failover stays bit-equal on every tenant.
    futs2 = {t: fleet3.router.submit_many(t, fleet3.days[t][0][:12])
             for t in fleet3.days}
    fleet3.router.flush()
    for t, fs in futs2.items():
        np.testing.assert_array_equal(
            _scores(fs), _oracle(fleet3.days, t, fleet3.days[t][0][:12]))


def _refreshed(cls, model, seed: int = 11):
    rng = np.random.default_rng(seed)
    k = model.num_topics
    ips = sorted(model.ip_index, key=model.ip_index.get)
    vocab = sorted(model.word_index, key=model.word_index.get)
    return cls.from_results(ips, rng.dirichlet(np.ones(k), size=len(ips)),
                            vocab,
                            rng.dirichlet(np.ones(len(vocab)), size=k).T,
                            fallback=0.1)


def _publish_then_kill(f: _Fleet, cls):
    rows, model, cuts = f.days["t0"]
    model2 = _refreshed(cls, model)
    version = f.router.publish("t0", model2)
    victim = f.router.placement()["t0"].primary
    f.replicas[victim].kill()
    _wait_until(lambda: f.router.stats()["failovers"])
    futs = f.router.submit_many("t0", rows[:16])
    f.router.flush()
    return version, model2, _scores(futs)


def test_router_publish_fanout_keeps_shadow_fresh(fleet3, jfleet3):
    """publish() fans out to primary and shadow, so a failover after the
    publish serves the refreshed model: the shadow was never stale."""
    version, model2, got = _publish_then_kill(fleet3, ScoringModel)
    jversion, _, jgot = _publish_then_kill(jfleet3, JScoringModel)
    assert version == jversion == 2
    rows, _, cuts = fleet3.days["t0"]
    np.testing.assert_array_equal(
        got, score_features(model2, DnsEventFeaturizer(cuts)(rows[:16]),
                            "dns"))
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=0)


def _drain_join(f: _Fleet, spare_cls, **kw):
    target = f.router.placement()["t0"].primary
    futs = {t: f.router.submit_many(t, f.days[t][0][:16]) for t in f.days}
    res = f.router.drain_replica(target)
    scores = {t: _scores(fs) for t, fs in futs.items()}
    after_drain = f.router.placement()
    spare = spare_cls("r9", _cfg(f.jax), **kw)
    f.replicas["r9"] = spare
    joined = f.router.join_replica("r9", spare.host, spare.port,
                                   warmup=False)
    return target, res, scores, after_drain, joined


def test_router_drain_join_rolling_redeploy(fleet3, jfleet3):
    """Drain one replica at a time: routing flips to the warm shadows,
    the drained replica reports a clean drain, a replacement joins with
    bounded movement, traffic never breaks, and every placement along
    the way is the JAX router's."""
    target, res, scores, after_drain, joined = _drain_join(
        fleet3, ReplicaServer, device=CPU)
    jtarget, jres, _, jafter, jjoined = _drain_join(jfleet3, JReplicaServer)
    assert target == jtarget
    assert res == jres and res["drained"] is True
    assert _flat(after_drain) == _flat(jafter)
    assert all(target not in (p.primary, p.shadow)
               for p in after_drain.values())
    assert target not in fleet3.router.stats()["replicas"]
    for t, got in scores.items():
        np.testing.assert_array_equal(
            got, _oracle(fleet3.days, t, fleet3.days[t][0][:16]))
    assert joined == jjoined
    assert len(moved_primaries(after_drain, fleet3.router.placement())) \
        == joined["moved"] <= math.ceil(len(fleet3.days) / 2)
    assert _flat(fleet3.router.placement()) == \
        _flat(jfleet3.router.placement())
    futs = {t: fleet3.router.submit_many(t, fleet3.days[t][0][:10])
            for t in fleet3.days}
    fleet3.router.flush()
    for t, fs in futs.items():
        np.testing.assert_array_equal(
            _scores(fs), _oracle(fleet3.days, t, fleet3.days[t][0][:10]))


def test_router_drain_last_replica_refused(fleet3, jfleet3):
    msgs = []
    for f in (fleet3, jfleet3):
        live = f.router.stats()["replicas"]
        f.router.drain_replica(live[0])
        f.router.drain_replica(live[1])
        with pytest.raises(RuntimeError, match="last replica") as e:
            f.router.drain_replica(live[2])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _admission_run(jax: bool):
    cfg = (JServingConfig if jax else ServingConfig)(
        fleet_max_batch=64, fleet_max_wait_ms=20.0, device_score_min=None,
        route_max_inflight=8)
    f = _Fleet(jax, n_rep=1, n_ten=1, seed0=500, cfg=cfg)
    try:
        rows = f.days["t0"][0]
        futs = [f.router.submit("t0", rows[i % len(rows)])
                for i in range(200)]
        f.router.flush()
        scores = _scores(futs)
        return scores, f.router.stats()["edges"]["r0"]
    finally:
        f.close()


def test_router_admission_window_blocks_and_prices_stall():
    """route_max_inflight bounds the outstanding events per edge: a
    saturating burst stalls at the window, the stall is priced into the
    edge's stats, and every event still resolves once, as in the JAX
    router."""
    scores, edge = _admission_run(jax=False)
    jscores, jedge = _admission_run(jax=True)
    assert edge["events"] == jedge["events"] == 200
    assert edge["admission_stall_s"] > 0.0 and jedge["admission_stall_s"] > 0
    assert set(edge) == set(jedge)
    np.testing.assert_allclose(scores, jscores, rtol=RTOL, atol=0)


def _journal_kinds(f: _Fleet, path) -> dict:
    journal = (__import__("oni_ml_tpu.telemetry.journal",
                          fromlist=["Journal"]).Journal if f.jax else
               __import__("oni_ml_tpu_torch.telemetry.journal",
                          fromlist=["Journal"]).Journal)(str(path))
    f.router._journal = journal
    victim = f.router.placement()["t0"].primary
    futs = {t: f.router.submit_many(t, f.days[t][0][:8]) for t in f.days}
    f.replicas[victim].kill()
    f.router.flush()
    for fs in futs.values():
        _scores(fs)
    assert _wait_until(lambda: f.router.stats()["failovers"])
    f.router.close()
    journal.close()
    import json

    kinds: dict = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            kinds.setdefault((rec["kind"], rec.get("event")), set()).update(
                k for k in rec if k not in ("mono_ns", "wall_ns", "ts"))
    return kinds


def test_router_journals_route_membership_failover(tmp_path, fleet3,
                                                  jfleet3):
    """A journaled router run writes the JAX router's record kinds, each
    with the same fields."""
    kinds = _journal_kinds(fleet3, tmp_path / "port.jsonl")
    jkinds = _journal_kinds(jfleet3, tmp_path / "jax.jsonl")
    assert ("failover", "recovered") in kinds
    assert ("route", "close") in kinds
    assert kinds == jkinds


def test_router_fail_key_triggers_monitor_failover(tmp_path):
    """A replica posting its fail key is failed over by the router's
    monitor without a connection EOF; a replacement under the same id
    is not failed again by the stale key."""
    kv = FileKVClient(str(tmp_path / "kv"))
    cfg = _cfg(False, replica_heartbeat_s=0.05)
    f = _Fleet(False, n_rep=2, n_ten=4, seed0=400, cfg=cfg, kv=kv)
    try:
        victim = f.router.placement()["t0"].primary
        MembershipClient(kv).fail(victim, "backend lost")
        fos = _wait_until(lambda: f.router.stats()["failovers"])
        assert fos and fos[0]["replica"] == victim
        assert victim not in f.router.stats()["replicas"]
        rows = f.days["t0"][0]
        _scores(f.router.submit_many("t0", rows[:8]))
        f.replicas[victim].stop()
        respawn = ReplicaServer(victim, cfg, kv=kv, device=CPU)
        f.replicas[victim + "_v2"] = respawn
        f.router.join_replica(victim, respawn.host, respawn.port,
                              warmup=False)
        # Four beats of the replacement (as many monitor polls) later it
        # is still routed to.
        assert _wait_until(lambda: MembershipClient(kv).heartbeats().get(
            victim, {}).get("seq", 0) >= 4)
        assert victim in f.router.stats()["replicas"]
        assert len(f.router.stats()["failovers"]) == len(fos)
        f.router.flush()
        _scores(f.router.submit_many("t0", rows[:6]))
    finally:
        f.close()


def test_replica_wedge_posts_fail_key_and_stops_beating(tmp_path):
    """A wedged replica (healthy process, failing health check) posts
    the membership fail key and stops heartbeating."""
    kv = FileKVClient(str(tmp_path / "kv"))
    cfg = _cfg(False, replica_heartbeat_s=0.02)
    state = {"wedged": False}

    def health():
        if state["wedged"]:
            raise RuntimeError("backend lost (injected)")

    rep = ReplicaServer("rw", cfg, kv=kv, health_check=health, device=CPU)
    try:
        m = MembershipClient(kv)
        assert _wait_until(lambda: "rw" in m.alive(WAIT_S))
        assert m.failures() == {}
        state["wedged"] = True
        assert _wait_until(lambda: "rw" in m.failures())
        assert "health check failed" in m.failures()["rw"]["reason"]
        # The beat stopped: the publisher thread has exited.
        rep._heartbeat._thread.join(WAIT_S)
        assert not rep._heartbeat._thread.is_alive()
        seq = m.heartbeats()["rw"]["seq"]
        assert m.heartbeats()["rw"]["seq"] == seq
    finally:
        rep.stop()


def test_replica_protocol_ops_direct():
    """Raw protocol against one replica: ping, hello (no shared-memory
    upgrade), idempotent add_tenant (router_version decides news),
    publish version bump, stats with the device, drain."""
    rep = ReplicaServer("rx", _cfg(False), device=CPU)
    events = []
    got_event = threading.Event()

    def on_score(r, m):
        events.append(m)
        got_event.set()

    link = ReplicaLink("rx", rep.host, rep.port, op_timeout_s=WAIT_S,
                       on_score=on_score, on_down=lambda r, m: None)
    try:
        assert link.call({"op": "ping"})["ok"] is True
        assert link.call({"op": "hello", "wire": ["columnar"],
                          "shm": True})["shm"] is None
        with pytest.raises(RuntimeError, match="refuses"):
            link.call({"op": "hello", "wire": ["pickle"]})
        rows, model, cuts = serve._synthetic_day(n_events=32, seed=600)
        req = {"op": "add_tenant", "spec": {"tenant": "ta",
                                            "dsource": "dns"},
               "cuts": cuts, "model": model, "router_version": 1}
        assert link.call(dict(req))["published"] is True
        rsp = link.call(dict(req))
        assert rsp["published"] is False and rsp["version"] == 1
        assert link.call({"op": "publish", "tenant": "ta", "model": model,
                          "router_version": 2})["version"] == 2
        link.send_submit(101, "ta", rows[0])
        link.call({"op": "flush"})
        assert got_event.wait(WAIT_S)
        assert events[0]["id"] == 101 and np.isfinite(events[0]["score"])
        stats = link.call({"op": "stats"})
        assert stats["tenants"] == ["ta"] and stats["events_scored"] == 1
        assert stats["device"] == "cpu" and "cuda_peak_bytes" not in stats
        assert link.call({"op": "warmup"})["warmup"][0]["warmed"] == 0
        assert link.call({"op": "drain"})["drained"] is True
        with pytest.raises(RuntimeError, match="unknown op"):
            link.call({"op": "nope"})
    finally:
        link.close()
        rep.stop()


def test_dynamic_scorer_grows_lanes_like_jax(tmp_path):
    """A dynamic FleetScorer starts with no lanes and grows one per
    add_tenant; its flush size and source stay the config's at every
    step, as the JAX scorer's do with no plan entry.  A static scorer
    refuses add_tenant, and a tenant gets one lane."""
    from oni_ml_tpu.plans import PlanStore, use_store
    from oni_ml_tpu.serving import DnsEventFeaturizer as JDnsEventFeaturizer
    from oni_ml_tpu.serving import FleetRegistry as JFleetRegistry
    from oni_ml_tpu.serving import FleetScorer as JFleetScorer
    from oni_ml_tpu_torch.serving import FleetRegistry, FleetScorer

    def run(jax: bool) -> list:
        reg = (JFleetRegistry if jax else FleetRegistry)()
        cfg = (JServingConfig if jax else ServingConfig)(
            device_score_min=None)
        spec = JTenantSpec if jax else TenantSpec
        fz = JDnsEventFeaturizer if jax else DnsEventFeaturizer
        day = jserve._synthetic_day if jax else serve._synthetic_day
        rows, model, cuts = day(n_events=24, seed=700)
        kw = {} if jax else {"device": CPU}
        scorer = (JFleetScorer if jax else FleetScorer)(
            reg, {}, cfg, dynamic=True, **kw)
        seen = [(len(scorer._lanes), scorer.max_batch,
                 scorer.plan["max_batch"]["source"])]
        try:
            for i in range(3):
                t = f"t{i}"
                reg.add_tenant(spec(tenant=t, dsource="dns", queue_max=40))
                reg.publish(t, model, source="test")
                scorer.add_tenant(spec(tenant=t, dsource="dns",
                                       queue_max=40), fz(cuts))
                seen.append((len(scorer._lanes), scorer.max_batch,
                             scorer.plan["max_batch"]["source"]))
            with pytest.raises(ValueError, match="already has a lane"):
                scorer.add_tenant(spec(tenant="t0", dsource="dns"),
                                  fz(cuts))
            futs = [scorer.submit("t1", r) for r in rows]
            scorer.flush()
            seen.append([f.result(timeout=WAIT_S)[0] for f in futs])
        finally:
            scorer.close()
        return seen

    with use_store(PlanStore(str(tmp_path / "plans.jsonl"), seeds=False)):
        want = run(jax=True)
    got = run(jax=False)
    default = ServingConfig.fleet_max_batch
    assert got[:4] == [(n, default, "default") for n in range(4)]
    assert got[:4] == want[:4]
    np.testing.assert_allclose(got[4], want[4], rtol=RTOL, atol=0)
    reg = FleetRegistry()
    rows, model, cuts = serve._synthetic_day(n_events=24, seed=700)
    reg.add_tenant(TenantSpec(tenant="s", dsource="dns"))
    reg.publish("s", model, source="test")
    static = FleetScorer(reg, {"s": DnsEventFeaturizer(cuts)},
                         ServingConfig(device_score_min=None), device=CPU)
    try:
        with pytest.raises(RuntimeError, match="dynamic=True"):
            static.add_tenant(TenantSpec(tenant="u", dsource="dns"),
                              DnsEventFeaturizer(cuts))
    finally:
        static.close()


def _gadget_pickle(target: str) -> bytes:
    """A protocol-4 pickle whose global is a dotted name under a module
    of the port (`oni_ml_tpu_torch.serving.replica` imports os), which
    CPython's find_class follows to os.makedirs: the shape of gadget a
    root-only module allowlist lets through.  Unpickled, it creates
    `target`."""
    def ustr(x: str) -> bytes:
        b = x.encode()
        return b"\x8c" + bytes([len(b)]) + b
    return (b"\x80\x04" + ustr("oni_ml_tpu_torch.serving.replica")
            + ustr("os.makedirs") + b"\x93" + ustr(target) + b"\x85"
            + b"R" + b".")


def test_replica_refuses_pickle_frames_without_running_them(tmp_path):
    """Nothing a peer sends reaches an unpickler: a whole-frame pickle
    and a columnar frame with the JAX package's pickled (`opq`) field,
    each carrying a dotted-name gadget, fail to decode; the replica
    drops that connection, the gadget never runs, and the replica keeps
    serving other links."""
    import pickle
    import socket
    import struct

    from oni_ml_tpu_torch.serving import wire

    target = tmp_path / "gadget_ran"
    gadget = _gadget_pickle(str(target))
    # The gadget is what the review found: it reaches os.makedirs
    # through a port module under pickle's own rules.
    probe = tmp_path / "probe"
    pickle.loads(_gadget_pickle(str(probe)))
    assert probe.is_dir()
    frames = {
        "whole_frame": gadget,
        "opq_field": wire._frame(
            wire.KIND_MSG, {"f": {"op": "add_tenant"},
                            "e": {"featurizer": "opq"}},
            [("featurizer", np.frombuffer(gadget, np.uint8))]),
    }
    for frame in frames.values():
        with pytest.raises(ConnectionError):
            wire.decode_payload(frame)
    rep = ReplicaServer("rg", _cfg(False), device=CPU)
    link = None
    try:
        for name, frame in frames.items():
            s = socket.create_connection((rep.host, rep.port),
                                         timeout=WAIT_S)
            try:
                s.sendall(struct.pack("!I", len(frame)) + frame)
                # The replica closes the connection without a reply.
                assert s.recv(1) == b"", name
            finally:
                s.close()
        assert not target.exists()
        link = ReplicaLink("rg", rep.host, rep.port, op_timeout_s=WAIT_S,
                           on_score=lambda r, m: None,
                           on_down=lambda r, m: None)
        assert link.call({"op": "ping"})["replica"] == "rg"
    finally:
        if link is not None:
            link.close()
        rep.stop()
    with pytest.raises(TypeError, match="no columnar encoding"):
        wire.encode_payload({"op": "x", "obj": {1: "a"}})


def test_router_pushes_a_featurizer_as_cuts_and_top_domains():
    """A day-dir featurizer handed to FleetRouter.add_tenant reaches
    the replica as its cuts and top-domains table: the replica's lane
    rebuilds an equal featurizer, and routed scores are bit-equal to the
    host scorer's under the original."""
    rows, model, cuts = serve._synthetic_day(n_events=40, seed=810)
    top = frozenset(["example.com", "wikipedia.org", "n\u00e9t.fr"])
    fz = DnsEventFeaturizer(cuts, top_domains=top)
    rep = ReplicaServer("rf", _cfg(False), device=CPU)
    router = FleetRouter(_cfg(False))
    try:
        router.connect_replica("rf", rep.host, rep.port)
        router.add_tenant(TenantSpec(tenant="ta", dsource="dns"), (),
                          model, featurizer=fz)
        router.start(warmup=False)
        lane_fz = rep.scorer._lanes["ta"].featurizer
        assert lane_fz.top_domains == top
        assert len(lane_fz.cuts) == len(fz.cuts)
        for a, b in zip(lane_fz.cuts, fz.cuts):
            np.testing.assert_array_equal(a, b)
        futs = router.submit_many("ta", rows)
        router.flush()
        np.testing.assert_array_equal(
            _scores(futs), score_features(model, fz(rows), "dns"))
    finally:
        router.close()
        rep.stop()
