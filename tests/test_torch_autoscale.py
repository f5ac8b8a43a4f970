"""The port's Little's-law autoscaler (oni_ml_tpu_torch/serving/
autoscale.py) against the JAX package's, on the CPU.

Both controllers read the same sequence of stats from a fake router
through the same `tick(now=)` clock, with no thread and no sleep: their
decision records are equal key for key, and their EWMAs agree within
1e-12 at every tick.  The cases are the JAX tests'
(tests/test_wire.py:503-556): hysteresis, EWMA and the reaction clock;
cooldown, max_replicas and the LIFO drain of owned replicas only; the
journal.  A seeded random load adds a long mixed sequence.  The
controller thread's error path is driven by an event, with a timeout."""

import random
import threading

import pytest

from oni_ml_tpu.config import ServingConfig as JServingConfig
from oni_ml_tpu.serving import AutoScaler as JAutoScaler
from oni_ml_tpu_torch.config import ServingConfig
from oni_ml_tpu_torch.serving import AutoScaler

WAIT_S = 30.0
EWMA_TOL = 1e-12


class _FakeRouter:
    """stats()-shaped occupancy the tests steer directly."""

    def __init__(self, replicas, cap=8):
        self.replicas = list(replicas)
        self.cap = cap
        self.occupancy = 0
        self.events = 0
        self.stall_s = 0.0
        self.joined = []
        self.drained = []

    def stats(self):
        n = max(1, len(self.replicas))
        return {
            "replicas": list(self.replicas),
            "max_inflight": self.cap,
            "edges": {r: {"inflight": self.occupancy // n,
                          "events": self.events // n,
                          "admission_stall_s": self.stall_s / n}
                      for r in self.replicas},
        }

    def join_replica(self, rid, host, port):
        self.replicas.append(rid)
        self.joined.append(rid)

    def drain_replica(self, rid):
        self.replicas.remove(rid)
        self.drained.append(rid)


class _Pair:
    """A port and a JAX controller, each over its own fake router, driven
    in lockstep."""

    def __init__(self, replicas=("r0",), cap=8, journal=False,
                 port_drain=False, **cfg_kw):
        kw = dict(autoscale_interval_s=0.5, autoscale_halflife_s=1.0,
                  autoscale_cooldown_s=5.0, autoscale_high=0.75,
                  autoscale_low=0.25, autoscale_max_replicas=4)
        kw.update(cfg_kw)
        self.routers = [_FakeRouter(replicas, cap) for _ in range(2)]
        self.journals = [[], []]
        self.scalers = []
        # With `port_drain` the port controller drains through its own
        # `drain=` callable (the JAX one through its router); `order`
        # logs its drain and stop calls.
        self.order = []
        for i, (cls, cfg_cls) in enumerate(((AutoScaler, ServingConfig),
                                            (JAutoScaler, JServingConfig))):
            counter = {"n": 0}

            def spawn(counter=counter):
                counter["n"] += 1
                return f"as{counter['n']}", "127.0.0.1", 0

            sink = self.journals[i]

            class _J:
                def append(self, rec, sink=sink):
                    sink.append(rec)

            extra = {}
            if port_drain and i == 0:
                router = self.routers[0]

                def drain(rid, router=router):
                    self.order.append(("drain", rid))
                    return router.drain_replica(rid)

                extra = {"drain": drain, "stop": lambda rid: self.order.append(
                    ("stop", rid))}
            self.scalers.append(cls(
                self.routers[i], **{"spawn": spawn,
                                    "stop": lambda rid: None, **extra},
                config=cfg_cls(**kw), journal=_J() if journal else None))

    def set(self, **load):
        for r in self.routers:
            for k, v in load.items():
                setattr(r, k, v)

    def tick(self, now: float) -> dict:
        port, jax = (s.tick(now=now) for s in self.scalers)
        assert port == jax
        a, b = (s._util_ewma for s in self.scalers)
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) <= EWMA_TOL
        assert self.routers[0].replicas == self.routers[1].replicas
        return port


def test_autoscaler_hysteresis_ewma_and_reaction_clock_like_jax():
    """The EWMA holds the decision past the first raw breach and
    reaction_s measures breach -> join."""
    p = _Pair()
    p.set(occupancy=4)              # util 0.5 of 1 x 8: in band
    assert p.tick(0.0)["action"] == "hold"
    p.set(occupancy=8)              # util 1.0; the EWMA still under
    d = p.tick(1.0)
    assert d["action"] == "hold" and d["util"] == 1.0
    d = p.tick(2.0)
    assert d["action"] == "up" and p.routers[0].joined == ["as1"]
    assert d["reaction_s"] == pytest.approx(1.0)


def test_autoscaler_cooldown_max_replicas_and_owned_drain_like_jax():
    p = _Pair()
    p.set(occupancy=8)
    assert p.tick(0.0)["action"] == "up"
    d = p.tick(1.0)
    assert (d["action"], d["reason"]) == ("hold", "cooldown")
    p.set(occupancy=16)
    assert p.tick(6.0)["action"] == "up"
    p.set(occupancy=96)
    assert p.tick(12.0)["action"] == "up"
    d = p.tick(18.0)
    assert d["action"] == "hold" and d["reason"] == "at max_replicas"
    assert p.routers[0].replicas == ["r0", "as1", "as2", "as3"]
    # LIFO over owned replicas only, down to the floor: r0 stays.
    p.set(occupancy=0)
    for i in range(40):
        p.tick(20.0 + 6.0 * i)
        if not p.scalers[0]._owned:
            break
    assert p.scalers[0]._owned == p.scalers[1]._owned == []
    assert p.routers[0].drained == ["as3", "as2", "as1"]
    assert p.routers[0].replicas == ["r0"]
    d = p.tick(500.0)
    assert (d["action"], d["reason"]) == ("hold", "in band")   # the floor


def test_autoscaler_drain_callable_takes_the_victim_before_stop():
    """`drain=` (the port's; route.py keeps a drained replica's stats
    there) takes the LIFO victim in place of router.drain_replica, before
    `stop`: the records and EWMAs stay the JAX controller's."""
    p = _Pair(port_drain=True)
    p.set(occupancy=8)
    assert p.tick(0.0)["action"] == "up"
    p.set(occupancy=16)
    assert p.tick(6.0)["action"] == "up"
    p.set(occupancy=0)
    assert p.tick(12.0)["action"] == "down"
    assert p.tick(18.0)["action"] == "down"
    assert p.order == [("drain", "as2"), ("stop", "as2"),
                       ("drain", "as1"), ("stop", "as1")]
    assert p.routers[0].drained == p.routers[1].drained == ["as2", "as1"]


def test_autoscaler_decisions_are_journaled_like_jax():
    p = _Pair(journal=True)
    p.set(occupancy=0, events=100, stall_s=0.5)
    p.tick(0.0)
    p.set(events=300, stall_s=1.5)
    p.tick(2.0)
    assert p.journals[0] == p.journals[1]
    rec = p.journals[0][-1]
    assert rec["kind"] == "autoscale"
    assert {"action", "util", "util_ewma", "replicas", "occupancy",
            "lambda_eps", "stall_rate", "cooldown"} <= set(rec)
    assert rec["lambda_eps"] == pytest.approx(100.0)
    assert rec["stall_rate"] == pytest.approx(0.5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_random_load_matches_jax(seed):
    """A seeded random walk of occupancy, arrivals and stalls over
    uneven tick spacing: the same records and EWMAs at every tick."""
    rng = random.Random(seed)
    p = _Pair(replicas=("r0", "r1"), cap=16, autoscale_min_replicas=2,
              autoscale_max_replicas=5, autoscale_cooldown_s=2.0)
    now, events, stall = 0.0, 0, 0.0
    actions = set()
    for _ in range(300):
        now += rng.choice((0.1, 0.5, 0.5, 1.0, 3.0))
        events += rng.randrange(0, 500)
        stall += rng.random() * 0.1
        n = len(p.routers[0].replicas)
        p.set(occupancy=rng.randrange(0, 16 * n + 1), events=events,
              stall_s=stall)
        actions.add(p.tick(now)["action"])
    assert {"up", "down", "hold"} <= actions


def test_autoscaler_thread_journals_a_failed_spawn_as_error():
    """A spawn that raises inside the controller thread is journaled as
    action "error" (as the JAX controller journals it) and kept in
    `decisions`; the controller keeps running."""
    router = _FakeRouter(["r0"], cap=8)
    router.occupancy = 8
    records = []
    seen = threading.Event()

    class _J:
        def append(self, rec):
            records.append(rec)
            if rec.get("action") == "error":
                seen.set()

    def spawn():
        raise RuntimeError("replica never listened")

    sc = AutoScaler(router, spawn=spawn, stop=lambda rid: None,
                    config=ServingConfig(autoscale_interval_s=0.01),
                    journal=_J())
    sc.start()
    try:
        assert seen.wait(WAIT_S)
    finally:
        sc.close()
    assert not sc._thread.is_alive()
    errors = [d for d in sc.decisions if d["action"] == "error"]
    assert errors and "never listened" in errors[0]["error"]
    assert router.joined == []
    with pytest.raises(RuntimeError, match="already started"):
        sc.start()


def test_autoscaler_hold_restarts_smoothing_from_the_next_sample():
    """`hold()` (the port's, for a rolling redeploy): after the block the
    EWMA restarts from the live sample, so a pause in the stream is not
    averaged into the next decision; that sample starts a cooldown (the
    block changed the fleet), after which the smoothed load decides."""
    cooldown = ServingConfig().autoscale_cooldown_s

    def run(held):
        router = _FakeRouter(["r0"], cap=8)
        sc = AutoScaler(router, spawn=lambda: ("as1", "127.0.0.1", 0),
                        stop=lambda rid: None, config=ServingConfig(
                            autoscale_halflife_s=1.0))
        assert sc.tick(now=0.0)["util_ewma"] == 0.0
        router.occupancy = 8
        assert sc.tick(now=0.5)["action"] == "hold"
        if held:
            with sc.hold():
                pass
        return sc, sc.tick(now=1.0), router.joined

    sc, rec, joined = run(held=True)
    assert (rec["action"], rec["reason"]) == ("hold", "cooldown")
    assert rec["cooldown"] and rec["util_ewma"] == 1.0
    assert joined == []
    rec = sc.tick(now=1.0 + cooldown)
    assert rec["action"] == "up" and rec["util_ewma"] == 1.0
    assert sc._router.joined == ["as1"]
    _, rec, joined = run(held=False)
    assert rec["action"] == "hold" and 0.25 < rec["util_ewma"] < 0.75
    assert not rec["cooldown"] and joined == []


def test_autoscaler_hold_keeps_an_owned_replica_through_its_cooldown():
    """A rolling redeploy's fresh replicas start with empty windows: the
    low sample right after `hold()` does not drain the replica the
    controller owns; the load after the cooldown decides."""
    router = _FakeRouter(["r0"], cap=8)
    sc = AutoScaler(router, spawn=lambda: ("as1", "127.0.0.1", 0),
                    stop=lambda rid: None, config=ServingConfig())
    router.occupancy = 8
    assert sc.tick(now=0.0)["action"] == "up"
    with sc.hold():
        router.replicas = ["r0v2", "as1"]
    router.occupancy = 2                      # util 0.125, under the band
    rec = sc.tick(now=100.0)
    assert (rec["action"], rec["reason"]) == ("hold", "cooldown")
    assert router.drained == []
    router.occupancy = 8                      # the stream back: in band
    for t in (101.0, 102.0, 103.0, 104.0):
        assert sc.tick(now=t)["reason"] == "cooldown"
    rec = sc.tick(now=105.5)
    assert (rec["action"], rec["reason"]) == ("hold", "in band")
    router.occupancy = 0
    for t in range(106, 140):
        if sc.tick(now=float(t))["action"] == "down":
            break
    assert router.drained == ["as1"]


def test_autoscaler_thread_does_not_tick_inside_hold():
    """The controller thread ticks around a `hold()` block, never in it,
    and `close()` inside the block leaves no tick after it."""
    inside = threading.Event()
    ticked = threading.Event()
    bad = []

    class _Router(_FakeRouter):
        def stats(self):
            if inside.is_set():
                bad.append("tick inside hold")
            ticked.set()
            return super().stats()

    sc = AutoScaler(_Router(["r0"]), spawn=lambda: None,
                    stop=lambda rid: None,
                    config=ServingConfig(autoscale_interval_s=0.01))
    sc.start()
    try:
        assert ticked.wait(WAIT_S)
        with sc.hold():
            inside.set()
            for _ in range(20):
                # Twenty intervals in which the thread would tick.
                threading.Event().wait(0.01)
            sc.close(timeout_s=0)
            inside.clear()
        sc._thread.join(WAIT_S)
    finally:
        sc.close()
    assert not sc._thread.is_alive()
    assert bad == []


def test_serving_config_fields_and_defaults_match_jax():
    """The two ServingConfigs have the same fields with the same
    defaults (this slice's `wire_shm*` and `autoscale_*` among them),
    but for the JAX package's pickle codec (`wire_format`,
    `wire_accept_pickle`), which the port's wire does not have."""
    import dataclasses

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    port, jax = fields(ServingConfig), fields(JServingConfig)
    pickle_codec = {"wire_format", "wire_accept_pickle"}
    assert set(jax) - set(port) == pickle_codec
    assert set(port) <= set(jax)
    assert port == {k: v for k, v in jax.items() if k not in pickle_codec}
    assert {k for k in port if k.startswith(("wire_shm", "autoscale_"))} \
        == {"wire_shm", "wire_shm_slab_bytes", "autoscale_interval_s",
            "autoscale_high", "autoscale_low", "autoscale_halflife_s",
            "autoscale_cooldown_s", "autoscale_min_replicas",
            "autoscale_max_replicas"}
