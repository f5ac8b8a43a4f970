"""The rest of the port's replicated serving (oni_ml_tpu_torch/runner/
route.py `--kv-listen`, `--kv-connect`, `--autoscale`, `replica
--kv-connect`; runner/continuous.py `RouterBinding`, `replicated=` and
`--replicated N`) on the CPU, held to the JAX package's contracts.

Replica subprocesses run `ml_ops replica --device cpu`; in-process
replicas listen on 127.0.0.1:0.  The autoscaler is driven by events, not
by a sleep racing a deadline: the stream's input waits (with a timeout)
for the controller's join.  The chaos kill is the JAX test's
(tests/test_cosched_fleet.py:367-430): a tenant's primary killed while
its refit is active, with zero failed futures after.  Every router,
replica, server and process is closed in a finally; no shared-memory
segment outlives a test.

Tolerances: routed scores take the float64 host path
(device_score_min None), so flagged lines are the host scorer's, %.6e,
exactly."""

import dataclasses
import io
import json
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest

from oni_ml_tpu_torch.config import (ContinuousConfig, PipelineConfig,
                                     ScoringConfig, ServingConfig)
from oni_ml_tpu_torch.parallel import (KVServer, MembershipClient,
                                       TcpKVClient)
from oni_ml_tpu_torch.runner import ml_ops, route, serve
from oni_ml_tpu_torch.runner import continuous as cont
from oni_ml_tpu_torch.runner.continuous import (FleetContinuousService,
                                                IngestSlice)
from oni_ml_tpu_torch.serving import (FleetRouter, ModelRegistry,
                                      ReplicaLink, ReplicaServer,
                                      score_features)
from oni_ml_tpu_torch.sources import get as get_source

CPU = "cpu"
WAIT_S = 120.0


def _present(names) -> set:
    """Those of the shared-memory segments `names` that still exist
    (Linux: /dev/shm).  Only the segments a test's links negotiated are
    looked at: other processes make and drop their own."""
    return {n for n in names if os.path.exists(os.path.join("/dev/shm", n))}


def _ring_names(links: dict) -> set:
    """The ring segments a `FleetRouter.wire()` listing names."""
    return {n for link in links.values() for n in link["segments"]}


def _wait_until(pred, timeout_s: float = WAIT_S):
    deadline = time.monotonic() + timeout_s
    while True:
        v = pred()
        if v or time.monotonic() >= deadline:
            return v
        time.sleep(0.02)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# `ml_ops route` / `ml_ops replica` over the TCP KV, with the autoscaler
# ---------------------------------------------------------------------------


def _write_day_dir(path, rows, model):
    """A completed DNS day directory as the port writes one."""
    from oni_ml_tpu_torch.features.dns import featurize_dns
    from oni_ml_tpu_torch.io import formats

    os.makedirs(path, exist_ok=True)
    ips = sorted(model.ip_index, key=model.ip_index.get)
    vocab = sorted(model.word_index, key=model.word_index.get)
    formats.write_doc_results(os.path.join(path, "doc_results.csv"), ips,
                              model.theta[:-1])
    formats.write_word_results(
        os.path.join(path, "word_results.csv"), vocab,
        np.log(np.asarray(model.p[:-1], np.float64)).T)
    with open(os.path.join(path, "features.pkl"), "wb") as f:
        pickle.dump(featurize_dns(rows), f)


def _manifest(tmp_path, names, n=30, threshold=0.02):
    """Day dirs and a manifest for `names`; the tagged stream lines
    (tenant-major per event index) and the expected flagged lines."""
    manifest = {"tenants": []}
    per, flagged = {}, []
    for i, t in enumerate(names):
        rows, model, _ = serve._synthetic_day(seed=80 + i)
        day = str(tmp_path / t)
        _write_day_dir(day, rows, model)
        manifest["tenants"].append({"tenant": t, "day_dir": day,
                                    "dsource": "dns",
                                    "threshold": threshold})
        fz = serve._load_featurizer(day, None)
        snap = ModelRegistry().load_day(
            day, get_source("dns").fallback(ScoringConfig()))
        scores = score_features(snap.model, fz(rows[:n]), "dns")
        per[t] = [f"{t}\t" + ",".join(r) for r in rows[:n]]
        flagged += [f"{t}\t{s:.6e}\t" + ",".join(r)
                    for r, s in zip(rows[:n], scores) if s < threshold]
    lines = [per[t][j] for j in range(n) for t in names]
    mpath = str(tmp_path / "fleet.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    return mpath, lines, flagged


def test_route_kv_listen_autoscale_spawns_a_replica_that_scores(
        tmp_path, monkeypatch, capsys):
    """`route --replicas 1 --kv-listen 127.0.0.1:0 --autoscale` over
    `--device cpu` replicas: the spawned replicas join through
    `--kv-connect`, every same-host link rides the rings.  `r0`'s
    responses are held until the controller joins a replica, so its
    admission window (`--max-inflight 4`) stays full: the default band
    reads that load and spawns one replica, which takes a tenant's
    primary and scores its events; every event resolves once and the
    flagged lines are the host scorer's."""
    mpath, lines, flagged = _manifest(tmp_path, ["alpha", "beta"])
    joined = threading.Event()
    real_join = FleetRouter.join_replica
    real_on_score = FleetRouter._on_score

    def join_replica(self, rid, host, port, **kw):
        out = real_join(self, rid, host, port, **kw)
        if rid.startswith("as"):
            joined.set()
        return out

    def on_score(self, rid, msg):
        if rid == "r0":
            assert joined.wait(WAIT_S), "the autoscaler never joined"
        real_on_score(self, rid, msg)

    monkeypatch.setattr(FleetRouter, "join_replica", join_replica)
    monkeypatch.setattr(FleetRouter, "_on_score", on_score)
    monkeypatch.setattr(sys, "stdin",
                        io.StringIO("\n".join(lines) + "\n"))
    rc = ml_ops.main([
        "route", "--fleet", mpath, "--replicas", "1",
        "--kv-listen", "127.0.0.1:0", "--autoscale", "--max-inflight", "4",
        "--device", "cpu", "--device-score-min", "none"])
    cap = capsys.readouterr()
    assert rc == 0, cap.err[-3000:]
    assert "KV_LISTEN 127.0.0.1 " in cap.err
    summary = _last_json(cap.err)
    assert summary["routed"] == summary["resolved"] == len(lines)
    assert summary["errors"] == 0
    ups = [d for d in summary["autoscale"] if d["action"] == "up"]
    assert ups and ups[0]["replica"] == "as1"
    assert ups[0]["util_ewma"] > ServingConfig().autoscale_high
    assert summary["stats"]["max_inflight"] == 4
    assert not [d for d in summary["autoscale"] if d["action"] == "error"]
    assert {r: (w["format"], w["shm"]) for r, w in summary["wire"].items()
            } == {r: ("columnar", True) for r in ("r0", *(
                d["replica"] for d in ups))}
    stats = summary["replica_stats"]
    assert stats["as1"]["device"] == "cpu"
    assert stats["as1"]["events_scored"] > 0
    assert stats["as1"]["events_scored"] + stats["r0"]["events_scored"] \
        >= len(lines)
    assert sorted(cap.out.splitlines()) == sorted(flagged)
    names = _ring_names(summary["wire"])
    assert len(names) == 2 * len(summary["wire"])
    assert _wait_until(lambda: not _present(names), 30.0)


def test_retire_keeps_what_the_drain_forgets():
    """route's `_retire`, through which the rolling redeploy and the
    autoscaler drain a replica: its own stats reply and its link's
    transport are kept from before the drain, which detaches both from
    the router, so the summary still reports the replica."""

    class _Router:
        def __init__(self):
            self.live = {"r0": {"device": "cpu", "events_scored": 3},
                         "as1": {"device": "cpu", "events_scored": 7}}

        def replica_stats(self):
            return dict(self.live)

        def wire(self):
            return {r: {"format": "columnar", "shm": True,
                        "segments": [f"{r}_c2s", f"{r}_s2c"]}
                    for r in self.live}

        def drain_replica(self, rid):
            del self.live[rid]
            return {"replica": rid, "moved": 1, "drained": True}

    router, retired = _Router(), {}
    assert route._retire(router, retired, "as1") == {
        "replica": "as1", "moved": 1, "drained": True}
    assert set(router.live) == {"r0"}
    assert retired == {"as1": {
        "stats": {"device": "cpu", "events_scored": 7},
        "wire": {"format": "columnar", "shm": True,
                 "segments": ["as1_c2s", "as1_s2c"]}}}


def test_replica_subprocess_registers_over_tcp_kv(tmp_path):
    """`ml_ops replica --kv-connect HOST:PORT --device cpu`: registered
    and heartbeating in the TCP KV, its link on rings, stats naming the
    device, a clean shutdown over the wire that deregisters it."""
    server = KVServer()
    kv = TcpKVClient(server.host, server.port)
    proc = link = None
    try:
        proc, host, port = route._spawn_replica(
            "rsub", ["--kv-connect", f"{server.host}:{server.port}"],
            str(tmp_path), ["--device", "cpu", "--device-score-min",
                            "none"])
        m = MembershipClient(kv)
        assert m.members()["rsub"]["meta"]["port"] == port
        assert _wait_until(lambda: "rsub" in m.alive(WAIT_S))
        link = ReplicaLink("rsub", host, port, op_timeout_s=WAIT_S,
                           on_score=lambda r, msg: None,
                           on_down=lambda r, msg: None, want_shm=True)
        assert link.shm_tx is not None and link.shm_rx is not None
        stats = link.call({"op": "stats"})
        assert stats["device"] == "cpu" and stats["pid"] == proc.pid
        link.call({"op": "shutdown"})
        assert proc.wait(timeout=WAIT_S) == 0
        assert "rsub" not in m.members()
    finally:
        if link is not None:
            link.close()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
        kv.close()
        server.close()


def test_route_kv_connect_joins_an_existing_kv(tmp_path, monkeypatch,
                                               capsys):
    """`route --kv-connect` joins another router's KV server: the router
    journals its transport there, attaches to in-process replicas that
    registered in it, and every event resolves once."""
    mpath, lines, flagged = _manifest(tmp_path, ["alpha", "beta"], n=20)
    server = KVServer()
    cfg = ServingConfig(device_score_min=None)
    kvs = [TcpKVClient(server.host, server.port) for _ in range(2)]
    reps = {f"r{i}": ReplicaServer(f"r{i}", cfg, kv=kvs[i], device=CPU)
            for i in range(2)}
    try:
        roster = MembershipClient(kvs[0]).members()
        assert set(roster) == {"r0", "r1"}
        connect = ",".join(f"{r}={m['meta']['host']}:{m['meta']['port']}"
                           for r, m in sorted(roster.items()))
        monkeypatch.setattr(sys, "stdin",
                            io.StringIO("\n".join(lines) + "\n"))
        rc = ml_ops.main(["route", "--fleet", mpath, "--connect", connect,
                          "--kv-connect", f"{server.host}:{server.port}",
                          "--device", "cpu"])
        cap = capsys.readouterr()
    finally:
        for rep in reps.values():
            rep.stop()
        for kv in kvs:
            kv.close()
        server.close()
    assert rc == 0, cap.err[-3000:]
    summary = _last_json(cap.err)
    assert summary["routed"] == summary["resolved"] == len(lines)
    assert {r: (w["format"], w["shm"]) for r, w in summary["wire"].items()
            } == {r: ("columnar", True) for r in ("r0", "r1")}
    assert sorted(cap.out.splitlines()) == sorted(flagged)


@pytest.mark.parametrize("argv,window", [
    ([], ServingConfig().route_max_inflight),
    (["--max-inflight", "7"], 7),
    (["--max-inflight", "0"], 0),
])
def test_route_max_inflight_sets_the_admission_window(
        argv, window, tmp_path, monkeypatch, capsys):
    """`--max-inflight N` is the router's route_max_inflight (the
    window the autoscaler measures occupancy against); without it the
    default holds."""
    mpath, lines, _ = _manifest(tmp_path, ["alpha"], n=4)
    cfg = ServingConfig(device_score_min=None)
    rep = ReplicaServer("r0", cfg, device=CPU)
    try:
        monkeypatch.setattr(sys, "stdin",
                            io.StringIO("\n".join(lines) + "\n"))
        rc = ml_ops.main(["route", "--fleet", mpath, "--connect",
                          f"r0={rep.host}:{rep.port}", *argv,
                          "--device", "cpu"])
        cap = capsys.readouterr()
    finally:
        rep.stop()
    assert rc == 0, cap.err[-3000:]
    summary = _last_json(cap.err)
    assert summary["stats"]["max_inflight"] == window
    assert summary["routed"] == summary["resolved"] == len(lines)


# ---------------------------------------------------------------------------
# `ml_ops continuous --replicated`
# ---------------------------------------------------------------------------


def _flow_line(rng, sip, dip, dport, h=None):
    h = int(rng.integers(0, 24)) if h is None else h
    return (
        "2016-01-22 00:00:00,2016,1,22,"
        f"{h},{int(rng.integers(0, 60))},{int(rng.integers(0, 60))},0.0,"
        f"{sip},{dip},{int(rng.integers(1024, 60000))},{dport},TCP,,0,0,"
        f"{int(rng.integers(1, 100))},{int(rng.integers(40, 100000))},"
        "0,0,0,0,0,0,0,0,0"
    )


def _slice(rng, idx, n=120, t_base=0.0):
    ports = (80, 443, 22, 53)
    lines = [
        _flow_line(rng, f"10.0.0.{int(rng.integers(0, 24))}",
                   f"10.1.0.{int(rng.integers(0, 12))}",
                   ports[int(rng.integers(0, len(ports)))])
        for _ in range(n)
    ]
    return IngestSlice(lines=lines, t0=t_base + idx * 600.0,
                       t1=t_base + (idx + 1) * 600.0, index=idx)


def _fleet_config(tmp_path):
    """tests/test_cosched_fleet.py's `_fleet_config`, in the port."""
    config = PipelineConfig(
        data_dir=str(tmp_path),
        continuous=ContinuousConfig(
            window_s=1800.0, refresh_every_s=1200.0,
            min_refresh_docs=8, drift_tol_nats=0.8,
            drift_min_history=2, vocab_floor=512, batch_size=64,
            holdout_frac=0.3))
    return dataclasses.replace(
        config,
        lda=dataclasses.replace(config.lda, num_topics=4, em_max_iters=20),
        serving=ServingConfig(fleet_max_batch=32, fleet_max_wait_ms=5.0,
                              device_score_min=None))


def _journal_kinds(path) -> set:
    kinds = set()
    with open(path) as f:
        for ln in f:
            try:
                kinds.add(json.loads(ln).get("kind"))
            except json.JSONDecodeError:
                pass
    return kinds


def _drive_with_kill(fleet, kill, rng):
    """Bootstrap the binding, then feed until a refit is active, kill the
    first tenant's primary right then, and feed four slices more."""
    for idx in range(4):
        for t in ("acme", "globex"):
            fleet.ingest(t, _slice(rng, idx))
    assert _wait_until(lambda: fleet.binding.ready("acme")), \
        "router never bootstrapped"
    killed = None
    idx = 4
    deadline = time.monotonic() + 180.0
    while idx < 40 and time.monotonic() < deadline:
        for t in ("acme", "globex"):
            fleet.ingest(t, _slice(rng, idx))
        if killed is None and fleet.cosched.refresh_active:
            victim = fleet.router.placement()["acme"].primary
            kill(victim)
            killed = (victim, idx)
        if killed is not None and idx - killed[1] >= 4:
            break
        idx += 1
    return killed


def _check_after_kill(payload, router_versions):
    assert payload["serving"]["failed_futures"] == 0, payload["serving"]
    assert payload["serving"]["events_scored"] > 0
    for t in ("acme", "globex"):
        assert payload["serving"]["versions"][t] == router_versions[t]
        assert payload["tenants"][t]["events"] > 0
    assert payload["refresh_errors"] == 0
    assert len(payload["router"]["failovers"]) >= 1


def test_chaos_kill_primary_mid_refresh(tmp_path):
    """tests/test_cosched_fleet.py:367's chaos run in the port: in-process
    replicas behind a caller's router, acme's primary killed while a
    refit is active.  Zero failed futures (the admission journal replays
    through the promoted shadow), each tenant's publishes converge on
    the router's version, and the journals hold the episode."""
    from oni_ml_tpu_torch.telemetry import Journal

    config = _fleet_config(tmp_path)
    scfg = config.serving
    replicas = {f"r{i}": ReplicaServer(f"r{i}", scfg, device=CPU)
                for i in range(3)}
    router_journal = Journal(str(tmp_path / "router_journal.jsonl"))
    router = FleetRouter(scfg, journal=router_journal)
    for rid, rep in replicas.items():
        router.connect_replica(rid, rep.host, rep.port)
    names = _ring_names(router.wire())
    assert len(names) == 6
    fleet = FleetContinuousService(
        config, {"acme": "flow", "globex": "flow"},
        out_dir=str(tmp_path / "fleet"), router=router,
        coscheduler=True, warmup_refreshes=2, device=CPU)
    try:
        killed = _drive_with_kill(fleet, lambda r: replicas[r].kill(),
                                  np.random.default_rng(5))
        assert killed is not None, "no refit was ever active during the feed"
    finally:
        payload = fleet.close()
        versions = {t: router._tenants[t]["version"]
                    for t in ("acme", "globex")}
        router.close()
        for rep in replicas.values():
            rep.stop()
        router_journal.close()
    _check_after_kill(payload, versions)
    for svc in fleet.services.values():
        assert svc.events_scored == svc.events_offered
        assert svc.score_failures == 0
        assert svc.events_offered + svc.events_unserved == svc.events
    with open(tmp_path / "router_journal.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    assert any(r.get("kind") == "failover" for r in records)
    # Every link this router connected rode the rings.
    assert [r["shm"] for r in records if r.get("kind") == "wire"] == \
        [True, True, True]
    kinds = _journal_kinds(tmp_path / "fleet" / "run_journal.jsonl")
    assert {"cosched", "freshness"} <= kinds
    assert _wait_until(lambda: not _present(names), 30.0)


def test_spawned_fleet_survives_a_sigkilled_replica(tmp_path):
    """`replicated=2`: two `ml_ops replica --device cpu` processes behind
    the fleet's own router, on rings; acme's primary SIGKILLed while a
    refit is active.  Zero failed futures, versions converge, the
    replicas are stopped at close, and the killed replica's segments
    are gone."""
    fleet = FleetContinuousService(
        _fleet_config(tmp_path), {"acme": "flow", "globex": "flow"},
        out_dir=str(tmp_path / "fleet"), replicated=2,
        coscheduler=True, warmup_refreshes=2, device=CPU)
    router = fleet.router
    try:
        assert sorted(fleet.replica_procs) == ["r0", "r1"]
        links = router.wire()
        assert {r: (w["format"], w["shm"]) for r, w in links.items()} == \
            {r: ("columnar", True) for r in ("r0", "r1")}
        names = _ring_names(links)
        assert len(names) == 4
        killed = _drive_with_kill(fleet, fleet.kill_replica,
                                  np.random.default_rng(6))
        assert killed is not None, "no refit was ever active during the feed"
        assert fleet.replica_procs[killed[0]].returncode is not None
    finally:
        payload = fleet.close()
    versions = {t: router._tenants[t]["version"]
                for t in ("acme", "globex")}
    _check_after_kill(payload, versions)
    assert all(p.poll() is not None for p in fleet.replica_procs.values())
    assert not os.path.exists(fleet._workdir)
    assert _wait_until(lambda: not _present(names), 30.0)


def test_cli_replicated_two_streams_on_cpu(tmp_path, capsys):
    """`ml_ops continuous --stream a --stream b --replicated 2 --device
    cpu`: rc 0, the payload's serving and router records, every event
    accounted for once, no failed future or refresh error."""
    rng = np.random.default_rng(13)
    paths = {}
    for t in ("acme", "globex"):
        paths[t] = tmp_path / f"{t}.csv"
        with open(paths[t], "w") as f:
            for h in range(4):
                for _ in range(160):
                    f.write(_flow_line(
                        rng, f"10.0.0.{int(rng.integers(0, 32))}",
                        f"10.1.0.{int(rng.integers(0, 16))}", 80, h=h)
                        + "\n")
    rc = cont.main(["--stream", f"acme=flow:{paths['acme']}",
                    "--stream", f"globex=flow:{paths['globex']}",
                    "--replicated", "2", "--data-dir", str(tmp_path),
                    "--slice-s", "3600", "--no-sleep", "--window-s", "7200",
                    "--refresh-s", "3600", "--device", "cpu"])
    assert rc == 0
    payload = _last_json(capsys.readouterr().out)
    assert payload["events"] == 1280
    assert payload["refresh_errors"] == 0
    assert payload["serving"]["failed_futures"] == 0
    assert sorted(payload["router"]["replicas"]) == ["r0", "r1"]
    for t, p in payload["tenants"].items():
        assert p["events"] == 640
    saved = json.load(open(tmp_path / "continuous_fleet"
                           / "fleet_continuous_metrics.json"))
    assert saved == payload
