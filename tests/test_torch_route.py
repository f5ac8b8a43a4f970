"""The port's replicated-serving CLI (oni_ml_tpu_torch/runner/route.py,
routed by `ml_ops replica` / `ml_ops route`) against the JAX package's,
on the CPU.

`route --dry-run synthetic:6x3` runs both CLIs: the summaries carry the
same keys and counts (the replica killed, the tenants it moved, the
failover and the drain).  One test spawns a real replica subprocess
with `--device cpu` and one runs the dry run as a module; the stream
test attaches the router to in-process replicas.  Every socket wait has
a timeout, and every router, replica and process is closed in a
finally.

Tolerances: the dry runs score on the float64 host path and check their
own parity bit for bit; the stream test's flagged lines carry the
port's float64 host scores, formatted %.6e, exactly."""

import io
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu_torch.config import ScoringConfig, ServingConfig
from oni_ml_tpu_torch.parallel.membership import (FileKVClient,
                                                  MembershipClient)
from oni_ml_tpu_torch.runner import ml_ops, route, serve
from oni_ml_tpu_torch.serving import (DnsEventFeaturizer, ModelRegistry,
                                      ReplicaLink, ReplicaServer,
                                      score_features)
from oni_ml_tpu_torch.sources import get as get_source

WAIT_S = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _shape(summary: dict) -> dict:
    """The dry-run summary less what depends on timing or the process:
    the router's pid in its id, the recovery time and how many hops were
    still in flight at the kill; and less the port's own `scoring` key
    (where the replicas scored, and the bound)."""
    fo = [{k: v for k, v in r.items()
           if k not in ("router", "recovery_s", "resent")}
          for r in summary["failovers"]]
    return {**{k: v for k, v in summary.items() if k != "scoring"},
            "failovers": fo}


def test_route_dry_run_matches_the_jax_cli(capsys):
    rc = ml_ops.main(["route", "--dry-run", "synthetic:6x3",
                      "--device", "cpu"])
    port = _last_json(capsys.readouterr().out)
    jrc = jml_ops.main(["route", "--dry-run", "synthetic:6x3"])
    jax = _last_json(capsys.readouterr().out)
    assert rc == jrc == 0
    assert port["route_dry_run"] == "ok"
    assert port["chaos_dropped"] == 0
    assert port["redeploy"]["drained"]["drained"] is True
    assert port["scoring"] == {"device": "cpu", "engine": "host",
                               "rtol": 0.0}
    assert _shape(port) == _shape(jax)
    assert [set(r) for r in port["failovers"]] == \
        [set(r) for r in jax["failovers"]]


def test_replica_subprocess_spawn_and_shutdown(tmp_path):
    """One real `ml_ops replica --device cpu` subprocess: the port-file
    handshake, KV registration and heartbeats, a protocol round trip
    whose stats name the device, and a clean shutdown over the wire."""
    kv_dir = str(tmp_path / "kv")
    proc, host, port = route._spawn_replica(
        "rsub", kv_dir, str(tmp_path), ["--device", "cpu",
                                        "--device-score-min", "none"])
    link = None
    try:
        link = ReplicaLink("rsub", host, port, op_timeout_s=WAIT_S,
                           on_score=lambda r, m: None,
                           on_down=lambda r, m: None)
        assert link.call({"op": "ping"})["ok"] is True
        stats = link.call({"op": "stats"})
        assert stats["device"] == "cpu" and stats["pid"] == proc.pid
        m = MembershipClient(FileKVClient(kv_dir))
        assert m.members()["rsub"]["meta"]["port"] == port
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and "rsub" not in m.alive(WAIT_S):
            time.sleep(0.05)
        assert "rsub" in m.alive(WAIT_S)
        link.call({"op": "shutdown"})
        assert proc.wait(timeout=WAIT_S) == 0
        assert "rsub" not in m.members()
    finally:
        if link is not None:
            link.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    with open(tmp_path / "rsub.log") as f:
        assert "REPLICA_READY rsub" in f.read()


def _write_day_dir(path, rows, model):
    """A completed DNS day directory as the port writes one: the results
    CSVs and the port's features.pkl."""
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


def test_route_stream_over_connected_replicas(tmp_path, monkeypatch,
                                              capsys):
    """Stream mode: a manifest of day dirs, the router attached with
    --connect to two in-process replicas on the CPU, the day's
    featurizer pushed to the replicas as its cuts and top domains; every
    routed event resolves once and the flagged lines are the events the
    port's host scorer puts under the threshold."""
    manifest = {"tenants": []}
    lines, flagged = [], []
    cfg = ServingConfig(device_score_min=None)
    for i, t in enumerate(("alpha", "beta")):
        rows, model, _ = serve._synthetic_day(seed=60 + i)
        day = str(tmp_path / t)
        _write_day_dir(day, rows, model)
        manifest["tenants"].append({"tenant": t, "day_dir": day,
                                    "dsource": "dns", "threshold": 0.02})
        fz = serve._load_featurizer(day, None)
        snap = ModelRegistry().load_day(
            day, get_source("dns").fallback(ScoringConfig()))
        scores = score_features(snap.model, fz(rows[:30]), "dns")
        for r, s in zip(rows[:30], scores):
            lines.append(f"{t}\t" + ",".join(r))
            if s < 0.02:
                flagged.append(f"{t}\t{s:.6e}\t" + ",".join(r))
    assert isinstance(fz, DnsEventFeaturizer) and flagged
    mpath = str(tmp_path / "fleet.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    reps = {f"r{i}": ReplicaServer(f"r{i}", cfg, device="cpu")
            for i in range(2)}
    try:
        connect = ",".join(f"{r}={s.host}:{s.port}" for r, s in reps.items())
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            "\n".join(lines) + "\nno-tab-line\n"))
        rc = ml_ops.main(["route", "--fleet", mpath, "--connect", connect,
                          "--device", "cpu"])
        cap = capsys.readouterr()
    finally:
        for rep in reps.values():
            rep.stop()
    assert rc == 0
    summary = _last_json(cap.err)
    assert summary["routed"] == summary["resolved"] == 60
    assert summary["skipped"] == 1 and summary["errors"] == 0
    assert summary["hop_ms"]["count"] == 60
    assert set(summary["replica_stats"]) == {"r0", "r1"}
    assert all(s["device"] == "cpu"
               for s in summary["replica_stats"].values())
    assert sorted(cap.out.splitlines()) == sorted(flagged)
    assert summary["flagged"] == len(flagged)


def test_route_dry_run_as_a_module():
    """The acceptance command itself, `python -m
    oni_ml_tpu_torch.runner.ml_ops route --dry-run synthetic:6x3 --device
    cpu`, exits 0 with an ok summary."""
    out = subprocess.run(
        [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", "route",
         "--dry-run", "synthetic:6x3", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=WAIT_S)
    assert out.returncode == 0, out.stderr
    assert _last_json(out.stdout)["route_dry_run"] == "ok"
