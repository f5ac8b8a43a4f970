"""The port's flight recorder (oni_ml_tpu_torch/telemetry) against the JAX
package's, on the CPU: the same span tree gives the same Chrome trace
and journal span records, the same registry the same OpenMetrics text,
the run journal's record kinds the same records, the heartbeat's miss ->
subprocess probe -> BackendLost path the same journal; the roofline
record keeps the JAX record's fields, with `utilization: null` on the
CPU and the shares of the analytic count on an H100 fingerprint; the EM
drivers' host-sync spans, chunk-dispatch counter and roofline records
and the crossover's journal record; and `--profile` / `--heartbeat`
leave a day's outputs byte-equal.  No test waits on a real thread for
more than about a second."""

import json
import os

import numpy as np
import pytest

from oni_ml_tpu.telemetry import exporter as jexporter
from oni_ml_tpu.telemetry import heartbeat as jheartbeat
from oni_ml_tpu.telemetry import journal as jjournal
from oni_ml_tpu.telemetry import roofline as jroofline
from oni_ml_tpu.telemetry import spans as jspans
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.models import train_corpus
from oni_ml_tpu_torch.ops import sparse_estep as tsparse
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.telemetry import (
    BackendLost,
    HeartbeatMonitor,
    Journal,
    Recorder,
    RunJournal,
    exporter,
    heartbeat,
    maybe_span,
    roofline,
    spans,
    use_recorder,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "inputs", "flow.csv")
H100 = "cuda:nvidia_h100_80gb_hbm3:1"


def _fake_clock(monkeypatch, module):
    ticks = iter(range(10**6, 10**9, 1_000))
    monkeypatch.setattr(module, "now_ns", lambda: next(ticks))


def _span_tree(rec, span):
    """The same nested spans, counters, histograms and gauges."""
    with span("stage.lda", fdate="20160122"):
        with span("em.host_sync", it=3) as sp:
            sp.annotate(steps=16)
        rec.counter("em.chunk_dispatches").add(2)
        with span("em.host_sync", it=19):
            pass
    try:
        with span("stage.score"):
            raise ValueError("boom")
    except ValueError:
        pass
    rec.histogram("score.chunk_s").observe(0.25)
    rec.histogram("score.chunk_s").observe(0.0)
    rec.gauge("roofline.em.run_chunk.hbm_pct", 1.5)


@pytest.mark.parametrize("journaled", [False, True])
def test_chrome_trace_and_span_records_match_reference(tmp_path, monkeypatch,
                                                       journaled):
    out = {}
    for name, mod, jmod in (("port", spans, Journal),
                            ("jax", jspans, jjournal.Journal)):
        _fake_clock(monkeypatch, mod)
        path = str(tmp_path / f"{name}.jsonl")
        j = jmod(path) if journaled else None
        rec = mod.Recorder(journal=j)
        with mod.use_recorder(rec):
            _span_tree(rec, mod.maybe_span)
        if j is not None:
            j.close()
        trace = rec.chrome_trace()
        for ev in trace["traceEvents"]:
            if ev["ph"] == "M":
                ev["args"]["name"] = "<package>"
        # A span record's mono_ns is its start on the (fake) span clock.
        journal = [{k: v for k, v in r.items() if k != "t"}
                   for r in Journal.replay(path)] if journaled else None
        out[name] = (trace, rec.snapshot(), journal)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    if journaled:
        assert len(out["port"][2]) == 4 and out["port"][2] == out["jax"][2]
        assert out["port"][2][-1]["args"]["error"].startswith("ValueError")


def test_maybe_span_is_free_without_recorder():
    assert spans.current_recorder() is None
    with maybe_span("x") as sp:
        assert sp is None


def test_openmetrics_text_matches_reference():
    port, ref = Recorder(), jspans.Recorder()
    for rec in (port, ref):
        rec.counter("em.chunk_dispatches").add(7)
        rec.counter("heartbeat.misses").add(1)
        for v in (0.001, 0.004, 0.25, 3.0, 0.0, float("nan")):
            rec.histogram("heartbeat.probe_latency_s").observe(v)
        rec.gauge("roofline.score.device.filtered.hbm_pct", 12.5)
        rec.gauge("roofline.em.run_chunk.flops_pct", 0.031)
    text = exporter.render_openmetrics(port)
    assert text == jexporter.render_openmetrics(ref)
    assert text.endswith("# EOF\n") and "em_chunk_dispatches_total 7" in text


def test_run_journal_records_match_reference(tmp_path):
    """The record kinds the port added (dispatch, heartbeat,
    backend_lost, phase, annotations) and likelihood_points: the same
    records as the JAX RunJournal, and sync() makes them durable."""
    got = {}
    for name, jmod in (("port", Journal), ("jax", jjournal.Journal)):
        path = str(tmp_path / f"{name}.jsonl")
        rj = (RunJournal if name == "port" else jjournal.RunJournal)(
            jmod(path))
        rj.run_start(force=False, fdate="20160122", dsource="flow")
        rj.em_likelihood(1, -10.5, 1.0)
        rj.em_likelihood(2, -10.25, 0.0238)
        rj.dispatch_stats({"dispatches": 3, "survivors": 9}, stage="score")
        rj.heartbeat(True, latency_s=0.0012)
        rj.heartbeat(False, misses=1, timeout_s=60.0)
        rj.backend_lost(reason="2 consecutive liveness probes missed")
        rj.phase("score_device", ok=True, wall_s=1.5)
        rj.annotation("estep_crossover", engine="sparse")
        rj.journal.sync()
        rj.run_end(ok=False)
        rj.close()
        records = Journal.replay(path)
        got[name] = [{k: v for k, v in r.items() if k not in ("t", "mono_ns")}
                     for r in records]
        assert (RunJournal.likelihood_points(records)
                == jjournal.RunJournal.likelihood_points(records)
                == [(1, -10.5, 1.0), (2, -10.25, 0.0238)])
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_roofline():
    roofline.reset()
    jroofline.reset()
    yield
    roofline.reset()
    jroofline.reset()


def test_roofline_record_cpu_matches_reference_fields(fresh_roofline):
    """On the CPU: the JAX record's fields, achieved rates from the
    registered count, utilization null (the JAX record's rates from the
    same per-dispatch cost, injected into its registry, agree)."""
    flops, nbytes = 4.0e9, 2.5e9
    roofline.register_cost("em.run_chunk", flops=flops, nbytes=nbytes,
                           device="cpu")
    with jroofline._LOCK:
        jroofline._COSTS["em.run_chunk"] = {
            "flops": flops, "bytes": nbytes, "shape": "",
            "backend": "cpu:x86_64:8", "source": "cost_analysis"}
    rec = roofline.roofline_record("em.run_chunk", 2.0, dispatches=3)
    ref = jroofline.roofline_record("em.run_chunk", 2.0, dispatches=3)
    assert set(ref) <= set(rec)
    assert rec["backend"].startswith("cpu:")
    assert rec["cost_source"] == "analytic"
    for key in ("flops", "bytes", "flops_per_s", "bytes_per_s", "wall_s",
                "dispatches", "kind", "phase", "entry"):
        assert rec[key] == ref[key], key
    assert rec["utilization"] is None and rec["peaks"] is None
    assert roofline.peaks_for("cpu:x86_64:8") is None
    assert roofline.peaks_for("cuda:nvidia_a100-sxm4-80gb:1") is None
    # Without a registered cost: wall time only.
    bare = roofline.roofline_record("stage.pre", 1.0)
    assert bare["cost_source"] == "unregistered" and bare["flops"] is None


def test_roofline_record_h100_shares(fresh_roofline, tmp_path):
    """On an H100 fingerprint: the shares of the analytic count over the
    published peaks (67 TFLOP/s float32, 3.35 TB/s), the larger one the
    roofline share; emit journals it, sets the gauges and keeps it for
    the runner."""
    assert roofline.peaks_for(H100) is roofline.H100_SXM
    cost = tsparse.em_iteration_cost(48_000, 1_000_000, 5_568, 20, 7)
    roofline.register_cost("em.run_chunk", flops=cost["flops"],
                           nbytes=cost["bytes"], backend=H100)
    path = str(tmp_path / "j.jsonl")
    j = Journal(path)
    rec_ = Recorder(journal=j)
    n0 = roofline.emit_count()
    with use_recorder(rec_):
        rec = roofline.emit("em.run_chunk", 0.02, dispatches=10)
    j.close()
    wall = 0.02
    util = rec["utilization"]
    assert util["flops_pct"] == pytest.approx(
        100 * 10 * cost["flops"] / wall / 67e12)
    assert util["hbm_pct"] == pytest.approx(
        100 * 10 * cost["bytes"] / wall / 3.35e12)
    assert util["roofline_pct"] == pytest.approx(
        max(util["flops_pct"], util["hbm_pct"]))
    least, by = roofline.bound_s(10 * cost["flops"], 10 * cost["bytes"])
    assert rec["bound_s"] == pytest.approx(least) and rec["bound_by"] == by
    assert 0 < util["roofline_pct"] < 100
    assert "H100 SXM5" in rec["peaks"]["provenance"]
    assert roofline.emitted_records(since=n0) == [rec]
    journaled = [r for r in Journal.replay(path) if r["kind"] == "roofline"]
    assert len(journaled) == 1 and journaled[0]["utilization"] == util
    assert rec_.gauges["roofline.em.run_chunk.roofline_pct"] == \
        util["roofline_pct"]


def test_em_iteration_cost_uses_reference_flop_counts():
    """The EM count reads the JAX package's effective_flops and
    dense_equiv_flops: the same numbers for the same shapes."""
    cost = tsparse.em_iteration_cost(1024, 40_000, 5_568, 20, 6.0)
    assert cost["flops"] == jsparse.effective_flops(1, 40_000, 20, 6.0)
    assert cost["dense_equiv_flops"] == jsparse.dense_equiv_flops(
        1024, 5_568, 20, 6.0)
    assert cost["bytes"] == 8 * 40_000 + 8 * 5_568 * 20 + 8 * 1024 * 20


def test_kernel_costs_count_from_shapes():
    """The kernels' bound counts chip_smoke.py reads from the package: a
    function of the shapes and of the work the inputs need (live tokens,
    non-zero cells, each block's iterations), written out here for one
    small case of each."""
    from oni_ml_tpu_torch.ops import dense_estep, pallas_estep

    b, l, k, v, block = 4, 8, 3, 10, 2
    live, iters = np.array([8, 5, 0, 3]), np.array([2, 2, 1, 1])
    flops, nbytes = tsparse.kernel_cost(b, l, k, v, live, iters, block,
                                        warm=True)
    assert flops == 4 * k * (8 * 3 + 5 * 3 + 0 + 3 * 2)
    assert nbytes == (v * k * 4 + b * l * 8 + b * 4 + 4 + b * k * 4
                      + b * k * 4 + b * l * k * 4 + b * 8 + 2 * 4)
    flops, nbytes = pallas_estep.kernel_cost(b, l, k, live, iters, block,
                                             warm=False)
    assert flops == sum(it * (4 * k * n + (k + 1) * 40)
                        for it, n in zip(iters, live))
    assert nbytes == (k * b * l * 4 + b * l * 4 + b * 4 + 4 + b * k * 4
                      + 2 * 4)
    w = dense_estep.padded_width(v)
    flops, nbytes = dense_estep.kernel_cost(
        b, w, k, nnz_doc=live, nnz_block=np.array([13, 3]),
        block_iters=np.array([2, 1]), block=block, warm=False)
    assert flops == 4 * k * (13 * 2 + 3 * 1 + 16)
    assert nbytes == (b * w * 4 + 2 * k * w * 4 + b * 4 + b * k * 4 + b * 8
                      + 2 * 4)
    flops, nbytes = tsparse.scatter_cost(100, 20, 3, v, k)
    assert flops == 100 * k
    assert nbytes == 100 * (k * 4 + 4) + 20 * 8 + 3 * (v * k * 4 + 4)


# ---------------------------------------------------------------------------
# heartbeat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deep", [None, 0, 2])
def test_heartbeat_miss_escalation_matches_reference(tmp_path, deep):
    """Fake probes: two misses escalate to the subprocess probe; a dead
    one (None or no device) declares the loss, journaled, and check()
    raises BackendLost; one that sees devices vetoes it.  The journal's
    records equal the JAX monitor's under the same fakes."""
    got = {}
    for name, mod, jmod, rjmod in (
            ("port", heartbeat, Journal, RunJournal),
            ("jax", jheartbeat, jjournal.Journal, jjournal.RunJournal)):
        path = str(tmp_path / f"{name}.jsonl")
        rj = rjmod(jmod(path))
        hb = mod.HeartbeatMonitor(
            interval_s=0.01, timeout_s=0.1, max_misses=2, journal=rj,
            probe=lambda t: None, deep_probe=lambda t: deep)
        assert hb.beat_once() is False
        hb.check()
        assert hb.beat_once() is False
        lost = deep is None or deep == 0
        assert hb.lost.is_set() is lost
        if lost:
            with pytest.raises(mod.BackendLost):
                hb.check()
        rj.close()
        got[name] = [{k: v for k, v in r.items() if k not in ("t", "mono_ns")}
                     for r in Journal.replay(path)]
    assert got["port"] == got["jax"]
    if deep is None or deep == 0:
        assert got["port"][-1]["kind"] == "backend_lost"
        assert "subprocess probe also unresponsive" in \
            got["port"][-1]["reason"]


def test_heartbeat_thread_beats_at_start_and_stops():
    """The monitor's thread probes once as it starts, then every
    interval; stop() joins it; a dead probe declares the loss."""
    beats = []
    hb = HeartbeatMonitor(interval_s=0.02, timeout_s=0.1,
                          probe=lambda t: beats.append(1) or 0.001,
                          deep_probe=None).start()
    hb.stop()
    assert beats and not hb.lost.is_set()
    assert not hb._thread.is_alive()
    fired = []
    hb = HeartbeatMonitor(interval_s=0.01, timeout_s=0.1, max_misses=1,
                          probe=lambda t: None, deep_probe=None,
                          on_lost=fired.append).start()
    assert hb.lost.wait(timeout=1.0)
    hb.stop()
    assert fired and "missed" in fired[0]
    with pytest.raises(BackendLost):
        hb.check()


def test_heartbeat_real_probes_on_cpu():
    """The production probes: an add on the CPU answers with a latency;
    the subprocess probe reports this machine's CUDA device count (0
    here)."""
    lat = heartbeat.device_add_probe(timeout_s=30.0, device="cpu")
    assert lat is not None and lat > 0
    assert heartbeat.subprocess_probe(timeout_s=60.0) == 0


# ---------------------------------------------------------------------------
# EM and crossover instrumentation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_corpus():
    rng = np.random.default_rng(3)
    triples = [(f"d{d}", f"w{int(w)}", int(c))
               for d in range(40)
               for w, c in zip(rng.choice(60, 8, replace=False),
                               rng.integers(1, 4, 8))]
    return Corpus.from_word_counts(triples)


@pytest.mark.parametrize("chunk", [1, 128])
def test_em_host_sync_spans_counter_and_roofline(small_corpus, tmp_path,
                                                 fresh_roofline, chunk):
    """Under a recorder, each host sync of either EM driver is an
    em.host_sync span, each chunk dispatch counts in
    em.chunk_dispatches, and the loop leaves one roofline record with
    the analytic cost of the iterations run; outside a recorder the fit
    is bit-equal and records nothing."""
    cfg = LDAConfig(num_topics=4, em_max_iters=6, em_tol=0.0,
                    fused_em_chunk=chunk, host_sync_every=4,
                    estep_engine="sparse")
    path = str(tmp_path / "j.jsonl")
    j = Journal(path)
    rec = Recorder(journal=j)
    n0 = roofline.emit_count()
    with use_recorder(rec):
        res = train_corpus(small_corpus, cfg, device="cpu")
    j.close()
    plain = train_corpus(small_corpus, cfg, device="cpu")
    np.testing.assert_array_equal(res.log_beta, plain.log_beta)
    np.testing.assert_array_equal(res.gamma, plain.gamma)
    records = Journal.replay(path)
    syncs = [r for r in records if r.get("name") == "em.host_sync"]
    assert len(syncs) == res.stats["host_syncs"]
    emitted = roofline.emitted_records(since=n0)
    assert len(emitted) == 1
    phase = "em.e_step" if chunk == 1 else "em.run_chunk"
    rl = emitted[0]
    assert rl["phase"] == phase and rl["em_iters"] == 6
    assert rl["cost_source"] == "analytic" and rl["flops"] > 0
    assert rl["count"] == "upper"
    assert rl["utilization"] is None                 # the CPU: no peaks
    if chunk > 1:
        assert rec.counters["em.chunk_dispatches"].value == 2
        assert [r["kind"] for r in records].count("roofline") == 1
    assert roofline.emit_count() == n0 + 1          # the plain fit: none


def test_crossover_journal_record_matches_reference(tmp_path, monkeypatch):
    """engine_crossover journals the resolved crossover through the
    active recorder, as the JAX package's does (pinned by
    ONI_ML_TPU_ESTEP_ENGINE here: no card)."""
    monkeypatch.setenv("ONI_ML_TPU_ESTEP_ENGINE", "sparse")
    got = {}
    for name, smod, jmod, fn in (
            ("port", spans, Journal, tsparse.engine_crossover),
            ("jax", jspans, jjournal.Journal, jsparse.engine_crossover)):
        path = str(tmp_path / f"{name}.jsonl")
        j = jmod(path)
        with smod.use_recorder(smod.Recorder(journal=j)):
            fn(20, 5568, 1024, 128)
        j.close()
        got[name] = [{k: v for k, v in r.items() if k not in ("t", "mono_ns")}
                     for r in Journal.replay(path)]
    assert got["port"] == got["jax"]
    assert got["port"][0]["kind"] == "estep_crossover"


# ---------------------------------------------------------------------------
# the runner: --profile and --heartbeat change no result
# ---------------------------------------------------------------------------


def test_profile_and_heartbeat_leave_outputs_unchanged(tmp_path, capsys):
    """The golden flow day through the CLI on the CPU, plain and with
    `--heartbeat 0.05 --profile DIR`: final.*, the results CSV and
    likelihood.dat byte-equal; the journal holds stage spans, EM host
    syncs and heartbeats; metrics.json the EM roofline record; DIR a
    Chrome trace."""
    common = ["20160122", "flow", "1.1", "--flow-path", GOLDEN,
              "--device", "cpu", "--em-max-iters", "8"]
    prof = tmp_path / "prof"
    assert ml_ops.main(common + ["--data-dir", str(tmp_path / "a")]) == 0
    assert ml_ops.main(common + ["--data-dir", str(tmp_path / "b"),
                                 "--heartbeat", "0.05",
                                 "--profile", str(prof)]) == 0
    capsys.readouterr()
    a, b = tmp_path / "a" / "20160122", tmp_path / "b" / "20160122"
    for name in ("final.beta", "final.gamma", "final.other",
                 "likelihood.dat", "flow_results.csv", "doc_results.csv",
                 "word_results.csv"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    records = Journal.replay(str(b / "run_journal.jsonl"))
    names = {r.get("name") for r in records if r["kind"] == "span"}
    assert {"stage.pre", "stage.corpus", "stage.lda", "stage.score",
            "em.host_sync"} <= names
    beats = [r for r in records if r["kind"] == "heartbeat"]
    assert beats and all(r["ok"] for r in beats)
    with open(b / "metrics.json") as f:
        metrics = {r["stage"]: r for r in json.load(f)}
    phases = [r["phase"] for r in metrics["roofline"]["records"]]
    assert "em.run_chunk" in phases
    with open(prof / "20160122.flow.trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_backend_lost_exits_cleanly(tmp_path, capsys, monkeypatch):
    """A device that stops answering: the run stops at the next stage
    boundary with exit 3 and one JSON line, the loss journaled."""
    monkeypatch.setattr(ml_ops, "device_add_probe", lambda t, device: None)
    monkeypatch.setattr(heartbeat, "subprocess_probe", lambda t: None)
    real = ml_ops.HeartbeatMonitor

    def monitor(**kw):
        kw["deep_probe"] = None
        kw["max_misses"] = 1
        hb = real(**kw)
        return hb

    monkeypatch.setattr(ml_ops, "HeartbeatMonitor", monitor)

    def slow_pre(ctx):
        ctx.heartbeat.lost.wait(1.0)
        return {}

    monkeypatch.setitem(ml_ops._STAGE_FNS, ml_ops.Stage.PRE, slow_pre)
    rc = ml_ops.main(["20160122", "flow", "--flow-path", GOLDEN,
                      "--device", "cpu", "--data-dir", str(tmp_path),
                      "--heartbeat", "0.01"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 3
    assert json.loads(out[-1])["error"] == "backend_lost"
    kinds = [r["kind"] for r in
             Journal.replay(str(tmp_path / "20160122" / "run_journal.jsonl"))]
    assert "backend_lost" in kinds and kinds[-1] == "run_end"
