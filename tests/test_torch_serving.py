"""The port's streaming scoring service (oni_ml_tpu_torch/serving,
runner/serve.py, the serving parts of scoring/score.py, plans/,
sources/, models/online_lda.py and telemetry/exporter.py) against the
JAX package's, on the CPU: the same inputs, made from seeds with numpy,
through both.

Tolerances: the host scorer is float64 in the same k order on both
sides, so host scores are bit-equal; the device path's float32 gather
and multiply-add is within rel 1e-6 of the host at K <= 20.  A refresh
step runs float32 E-steps whose fixed point stops at var_tol, summed in
another order (the online tests' bounds: rel 2e-4 + abs 1e-4; measured
5e-7 on p and 4e-7 on theta).  The golden-day serve compares each
package on its own runner's model: their EM runs drift apart (ROADMAP
Queue 3; the scores 2.4e-6 relative after 5 iterations), so the flagged
events and their order are compared exactly and their scores within
rel 1e-4."""

import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
from oni_ml_tpu import plans as jplans
from oni_ml_tpu.config import DataplaneConfig as JDataplaneConfig
from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.config import OnlineLDAConfig as JOnlineLDAConfig
from oni_ml_tpu.config import PipelineConfig as JPipelineConfig
from oni_ml_tpu.config import ScoringConfig as JScoringConfig
from oni_ml_tpu.config import ServingConfig as JServingConfig
from oni_ml_tpu.config import TelemetryConfig as JTelemetryConfig
from oni_ml_tpu.features import dns as jdns
from oni_ml_tpu.features import flow as jflow
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.models.online_lda import OnlineLDATrainer as JTrainer
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu.runner import serve as jserve
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.scoring import score as jscore
from oni_ml_tpu.serving import DnsEventFeaturizer as JDnsEventFeaturizer
from oni_ml_tpu.serving import batcher as jbatcher
from oni_ml_tpu.serving import ModelRegistry as JModelRegistry
from oni_ml_tpu.serving import RefreshLoop as JRefreshLoop
from oni_ml_tpu.serving import event_documents as jevent_documents
from oni_ml_tpu.serving import featurizer_from_features as jfeaturizer_from
from oni_ml_tpu.serving import score_features as jscore_features
from oni_ml_tpu.serving import validate_model as jvalidate_model
from oni_ml_tpu.sources import get as jget_source
from oni_ml_tpu.telemetry import render_openmetrics as jrender
from oni_ml_tpu.telemetry.spans import Recorder as JRecorder
from oni_ml_tpu_torch import plans
from oni_ml_tpu_torch.config import (LDAConfig, OnlineLDAConfig,
                                     PipelineConfig, ScoringConfig,
                                     ServingConfig)
from oni_ml_tpu_torch.features import native_dns, native_flow
from oni_ml_tpu_torch.features.dns import load_top_domains
from oni_ml_tpu_torch.models.online_lda import OnlineLDATrainer
from oni_ml_tpu_torch.plans import PlanStore, use_store
from oni_ml_tpu_torch.plans.warmup import warmup_serving
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.runner import serve
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.scoring import score as tscore
from oni_ml_tpu_torch.serving import (BatchScorer, DnsEventFeaturizer,
                                      MetricsEmitter, ModelRegistry,
                                      RefreshLoop, event_documents,
                                      featurizer_from_features,
                                      score_features, validate_model)
from oni_ml_tpu_torch.sources import get as get_source
from oni_ml_tpu_torch.telemetry import (MetricsServer, render_openmetrics,
                                        write_openmetrics)
from oni_ml_tpu_torch.telemetry import roofline
from oni_ml_tpu_torch.telemetry.spans import Recorder

CPU = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_FLOW = os.path.join(HERE, "golden", "inputs", "flow.csv")
GOLDEN_DNS = os.path.join(HERE, "golden", "inputs", "dns.csv")
TOP = os.path.join(HERE, "golden", "inputs", "top1m.csv")
RTOL_DEVICE = 1e-6
RTOL_LAM, ATOL_LAM = 2e-4, 1e-4
RTOL_GOLDEN_SCORE = 1e-4


@pytest.fixture(scope="module")
def day():
    """(raw DNS rows, model, cuts) of the synthetic day, the port's and
    the JAX package's: the same draws."""
    return serve._synthetic_day(), jserve._synthetic_day()


def _perturbed(model, seed: int = 7):
    """A validly normalized variant of `model`: a stand-in refresh."""
    rng = np.random.default_rng(seed)
    theta = model.theta * rng.uniform(0.5, 1.5, model.theta.shape)
    theta[:-1] /= theta[:-1].sum(1, keepdims=True)
    p = model.p * rng.uniform(0.5, 1.5, model.p.shape)
    p[:-1] /= p[:-1].sum(0, keepdims=True)
    return type(model)(ip_index=model.ip_index, theta=theta,
                       word_index=model.word_index, p=p)


def test_synthetic_day_matches_jax(day):
    (rows, model, cuts), (jrows, jmodel, jcuts) = day
    assert rows == jrows
    assert model.ip_index == jmodel.ip_index
    assert model.word_index == jmodel.word_index
    np.testing.assert_array_equal(model.theta, jmodel.theta)
    np.testing.assert_array_equal(model.p, jmodel.p)
    for a, b in zip(cuts, jcuts):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# registry and validation
# ---------------------------------------------------------------------------


BAD_MODELS = {
    "topic_count": lambda m: (m.theta, m.p[:, :-1]),
    "ip_rows": lambda m: (m.theta[:-1], m.p),
    "negative": lambda m: (-m.theta, m.p),
    "nan": lambda m: (np.full_like(m.theta, np.nan), m.p),
    "theta_denormalized": lambda m: (m.theta * 37.0, m.p),
    "p_denormalized": lambda m: (m.theta, m.p * 37.0),
    "not_2d": lambda m: (m.theta.ravel(), m.p),
}


@pytest.mark.parametrize("case", sorted(BAD_MODELS))
def test_validate_model_refuses_what_jax_refuses(day, case):
    (_, model, _), (_, jmodel, _) = day
    theta, p = BAD_MODELS[case](model)
    with pytest.raises(ValueError) as port_err:
        validate_model(ScoringModel(model.ip_index, theta,
                                    model.word_index, p))
    with pytest.raises(ValueError) as jax_err:
        jvalidate_model(JScoringModel(jmodel.ip_index, theta,
                                      jmodel.word_index, p))
    assert str(port_err.value) == str(jax_err.value)
    # A refused publish leaves the active snapshot as it was.
    reg = ModelRegistry()
    reg.publish(model, source="good")
    with pytest.raises(ValueError):
        reg.publish(ScoringModel(model.ip_index, theta, model.word_index, p),
                    source="bad")
    assert reg.active().model is model and reg.version == 1
    assert validate_model(model) is model


def test_registry_hot_swap_and_load_day(day, tmp_path):
    (_, model, _), _ = day
    reg = ModelRegistry()
    with pytest.raises(RuntimeError):
        reg.active()
    s1 = reg.publish(model, source="t1")
    s2 = reg.publish(_perturbed(model), source="t2")
    assert (s1.version, s2.version, reg.version) == (1, 2, 2)
    assert reg.previous() is s1 and reg.active() is s2
    golden = os.path.join(HERE, "golden", "expected", "dns")
    snap = ModelRegistry().load_day(golden, fallback=0.1)
    jsnap = JModelRegistry().load_day(golden, fallback=0.1)
    assert snap.source == golden and snap.version == 1
    assert snap.model.ip_index == jsnap.model.ip_index
    assert snap.model.word_index == jsnap.model.word_index
    np.testing.assert_array_equal(snap.model.theta, jsnap.model.theta)
    np.testing.assert_array_equal(snap.model.p, jsnap.model.p)
    with pytest.raises(FileNotFoundError):
        ModelRegistry().load_day(str(tmp_path), fallback=0.1)


# ---------------------------------------------------------------------------
# featurizers from a day's features: native and Python containers
# ---------------------------------------------------------------------------


def _proxy_lines(n=400, seed=3):
    spec = get_source("proxy")
    return [",".join(spec.columns)] + spec.synth_benign(n, seed=seed)


def _containers(kind, tmp_path, monkeypatch):
    """(port container, JAX container, raw event lines) of one day."""
    if kind.startswith("flow"):
        if kind == "flow_python":
            monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
        port = native_flow.featurize_flow_file(GOLDEN_FLOW)
        with open(GOLDEN_FLOW) as f:
            lines = f.read().splitlines()
        return port, jflow.featurize_flow(lines), lines[1:]
    if kind.startswith("dns"):
        if kind == "dns_python":
            monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
        top = load_top_domains(TOP)
        port = native_dns.featurize_dns_sources([GOLDEN_DNS], top_domains=top)
        with open(GOLDEN_DNS) as f:
            lines = f.read().splitlines()
        jrows = [ln.split(",") for ln in lines]
        return port, jdns.featurize_dns(
            jrows, top_domains=jdns.load_top_domains(TOP)), lines
    lines = _proxy_lines()
    return (get_source("proxy").featurize(lines, skip_header=True),
            jget_source("proxy").featurize(lines, skip_header=True),
            lines[1:])


@pytest.mark.parametrize("kind", ["flow_native", "flow_python", "dns_native",
                                  "dns_python", "proxy"])
def test_featurizer_from_features_matches_jax(kind, tmp_path, monkeypatch):
    port, jfeats, lines = _containers(kind, tmp_path, monkeypatch)
    if kind.endswith("native"):
        assert type(port).__name__.startswith("Native")
    elif kind.endswith("python"):
        assert not type(port).__name__.startswith("Native")
    top = (load_top_domains(TOP) if kind.startswith("dns") else frozenset())
    fz = featurizer_from_features(port, top_domains=top)
    jfz = jfeaturizer_from(jfeats, top_domains=top)
    assert fz.dsource == jfz.dsource
    assert len(fz.cuts) == len(jfz.cuts)
    for a, b in zip(fz.cuts, jfz.cuts):
        np.testing.assert_array_equal(a, b)
    # A micro-batch featurized with the day's cuts builds the day's
    # words, as the JAX featurizer does.
    batch = lines[5:25]
    got = fz([fz.validate(ln) for ln in batch])
    ref = jfz([jfz.validate(ln) for ln in batch])
    spec, jspec = get_source(fz.dsource), jget_source(jfz.dsource)
    assert spec.event_pairs(got) == jspec.event_pairs(ref)
    assert spec.event_documents(got) == jspec.event_documents(ref)
    assert event_documents(got, fz.dsource) == \
        jevent_documents(ref, jfz.dsource)
    with pytest.raises(ValueError):
        fz.validate("not,enough,columns")
    if fz.dsource == "dns":
        assert fz.admit(batch[0]) == jfz.admit(batch[0])
        with pytest.raises(ValueError):
            fz.admit("a,b")


# ---------------------------------------------------------------------------
# scoring: host bit-equal, device path within rel 1e-6, the dispatch rule
# ---------------------------------------------------------------------------


def _flow_model(feats, seed=11, k=20):
    """A model over a flow day's IPs and words (Dirichlet draws, with
    some IPs and words left out so the fallback rows score too)."""
    rng = np.random.default_rng(seed)
    n = feats.num_raw_events
    ips = sorted({feats.sip(i) for i in range(n)}
                 | {feats.dip(i) for i in range(n)})[:-2]
    vocab = sorted(set(feats.src_word[:n]) | set(feats.dest_word[:n]))[:-1]
    theta = rng.dirichlet(np.ones(k), size=len(ips))
    p = rng.dirichlet(np.ones(len(vocab)), size=k).T
    return (ScoringModel.from_results(ips, theta, vocab, p, 0.05),
            JScoringModel.from_results(ips, theta, vocab, p, 0.05))


@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_score_features_host_bit_equal_device_close(day, dsource):
    if dsource == "flow":
        with open(GOLDEN_FLOW) as f:
            lines = f.read().splitlines()
        cuts = get_source("flow").cuts_of(jflow.featurize_flow(lines))
        lines = lines[1:]
        fz = get_source("flow").event_featurizer(cuts)
        jfz = jget_source("flow").event_featurizer(cuts)
        feats, jfeats = fz(lines), jfz(lines)
        model, jmodel = _flow_model(feats)
    else:
        (rows, model, cuts), (_, jmodel, _) = day
        feats, jfeats = DnsEventFeaturizer(cuts)(rows), \
            JDnsEventFeaturizer(cuts)(rows)
    host = score_features(model, feats, dsource, device_min=None)
    ref = jscore_features(jmodel, jfeats, dsource, device_min=None)
    assert host.dtype == np.float64
    np.testing.assert_array_equal(host, ref)
    dev = score_features(model, feats, dsource, device_min=1, device=CPU)
    np.testing.assert_allclose(dev, host, rtol=RTOL_DEVICE, atol=0)
    assert not np.array_equal(dev, host)  # the float32 path really ran


@pytest.mark.parametrize("pin", ["100", "0", "-5"])
def test_use_device_path_decisions_match_jax(monkeypatch, pin):
    monkeypatch.setattr(tscore, "_CALIBRATION", {})
    monkeypatch.setattr(jscore, "_CALIBRATION", None)
    monkeypatch.setenv("ONI_ML_TPU_SCORE_BREAK_EVEN", pin)
    for device_min in (None, 0, "auto", 1, 64, 4096):
        for n in (0, 1, 63, 64, 99, 100, 5000):
            assert tscore.use_device_path(n, device_min, CPU) == \
                jscore.use_device_path(n, device_min), (device_min, n)
    cal = tscore.dispatch_calibration(device=CPU)
    assert cal == jscore.dispatch_calibration()
    assert cal["source"] == "env"


def test_dispatch_calibration_measures_records_and_reuses(monkeypatch,
                                                         tmp_path):
    """A measurement records itself to the plan cache; the next process
    (the in-process cache cleared) reads it back, with no new sweep."""
    monkeypatch.setattr(tscore, "_CALIBRATION", {})
    monkeypatch.delenv("ONI_ML_TPU_SCORE_BREAK_EVEN", raising=False)
    store = PlanStore(str(tmp_path / "plans.jsonl"))
    with use_store(store):
        sweeps = plans.counters_snapshot()["autotune_sweeps"]
        cal = tscore.dispatch_calibration(device=CPU)
        assert cal["source"] == "measured"
        assert plans.counters_snapshot()["autotune_sweeps"] == sweeps + 1
        assert cal["dispatch_s"] > 0 and cal["host_event_s"] > 0
        assert cal["device_event_s"] >= 0
        be = cal["break_even"]
        assert be is None or be >= 1
        tscore._CALIBRATION.clear()
        again = tscore.dispatch_calibration(device=CPU)
        assert again == {**cal, "source": "plan"}
        assert plans.counters_snapshot()["autotune_sweeps"] == sweeps + 1
        # Keyed by the device: a CUDA run would not read the CPU's entry.
        entry = store.lookup("dispatch_calibration",
                             plans.device_fingerprint(CPU))
        assert entry is not None and entry.value["break_even"] == be
        assert entry.backend.startswith("cpu:")
        # A hand-edited entry the validator refuses is measured again.
        store.record("dispatch_calibration", plans.device_fingerprint(CPU),
                     "*", {"break_even": "auto"})
        tscore._CALIBRATION.clear()
        assert tscore.dispatch_calibration(device=CPU)["source"] == "measured"


def test_batched_scores_dispatch(day):
    (_, model, _), _ = day
    rng = np.random.default_rng(5)
    n = 64
    ip = rng.integers(0, model.theta.shape[0], n).astype(np.int32)
    w = rng.integers(0, model.p.shape[0], n).astype(np.int32)
    host = tscore.batched_scores(model, ip, w)
    np.testing.assert_array_equal(host, tscore._batched_scores(model, ip, w))
    np.testing.assert_array_equal(
        host, tscore.batched_scores(model, ip, w, device_min=n + 1,
                                    device=CPU))
    at = tscore.batched_scores(model, ip, w, device_min=n, device=CPU)
    np.testing.assert_allclose(at, host, rtol=RTOL_DEVICE, atol=0)
    np.testing.assert_array_equal(model.ip_rows(["10.0.0.1", "nope"]),
                                  [model.ip_index["10.0.0.1"],
                                   len(model.ip_index)])


# ---------------------------------------------------------------------------
# the flush triggers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,wait", [(None, None), (512, None),
                                        (None, 5.0), (512, 5.0)])
def test_trigger_sources_match_jax_without_a_plan(day, batch, wait):
    """The triggers come from ServingConfig, labelled "config" where they
    differ from the shipped default: the JAX package's labels when its
    plan cache is off."""
    (rows, model, cuts), (jrows, jmodel, jcuts) = day
    kw = {"device_score_min": None}
    if batch is not None:
        kw["max_batch"] = batch
    if wait is not None:
        kw["max_wait_ms"] = wait
    reg = ModelRegistry()
    reg.publish(model, source="t")
    scorer = BatchScorer(reg, DnsEventFeaturizer(cuts), ServingConfig(**kw),
                         device=CPU)
    scorer.close()
    jreg = JModelRegistry()
    jreg.publish(jmodel, source="t")
    with jplans.use_store(jplans.NullStore()):
        jscorer = jbatcher.BatchScorer(jreg, JDnsEventFeaturizer(jcuts),
                                       JServingConfig(**kw))
    jscorer.close()
    assert scorer.plan == jscorer.plan
    assert (scorer.max_batch, scorer.max_wait_ms) == (
        batch or 4096, wait or 50.0)


def test_batch_scorer_resolves_triggers_and_hands_the_store_to_its_worker(
        day, tmp_path):
    """The triggers are the config's, whatever the plan cache holds (the
    JAX package's entries for its flush-trigger knobs included), and the
    worker thread runs under the caller's plan store."""
    (rows, model, cuts), _ = day
    path = str(tmp_path / "plans.jsonl")
    jstore = jplans.PlanStore(path)
    jstore.record("serve_max_batch", jplans.host_fingerprint(), "*", 2048)
    jstore.close()
    store = PlanStore(path)
    seen = []
    reg = ModelRegistry()
    reg.publish(model, source="t")
    with use_store(store):
        scorer = BatchScorer(
            reg, DnsEventFeaturizer(cuts),
            ServingConfig(max_batch=8, max_wait_ms=60_000.0,
                          device_score_min=None),
            on_batch=lambda s, f, sc: seen.append(plans.current_store()),
            device=CPU)
    try:
        assert scorer.plan == {
            "max_batch": {"value": 8, "source": "config"},
            "max_wait_ms": {"value": 60_000.0, "source": "config"}}
        [f.result(timeout=30.0) for f in scorer.submit_many(rows[:16])]
    finally:
        scorer.close()
    assert seen == [store, store]
    with use_store(store):
        s2 = BatchScorer(reg, DnsEventFeaturizer(cuts),
                         ServingConfig(device_score_min=None), device=CPU)
    s2.close()
    assert s2.plan["max_batch"] == {"value": 4096, "source": "default"}


# ---------------------------------------------------------------------------
# the micro-batcher
# ---------------------------------------------------------------------------


def _scorer(day, registry=None, on_batch=None, **cfg_kw):
    (rows, model, cuts), _ = day
    reg = registry or ModelRegistry()
    if reg.version == 0:
        reg.publish(model, source="test")
    metrics = MetricsEmitter(to_stdout=False)
    cfg_kw.setdefault("device_score_min", None)
    scorer = BatchScorer(reg, DnsEventFeaturizer(cuts),
                         ServingConfig(**cfg_kw), metrics=metrics,
                         on_batch=on_batch, device=CPU)
    return rows, reg, metrics, scorer


def test_flush_on_max_batch(day):
    rows, _, metrics, scorer = _scorer(day, max_batch=8,
                                       max_wait_ms=60_000.0)
    try:
        results = [f.result(timeout=30.0)
                   for f in scorer.submit_many(rows[:16])]
        assert len(results) == 16
        assert {r["trigger"] for r in metrics.records} == {"max_batch"}
        assert all(r["events"] == 8 for r in metrics.records)
    finally:
        scorer.close()


def test_flush_on_max_wait(day):
    rows, _, metrics, scorer = _scorer(day, max_batch=10_000,
                                       max_wait_ms=40.0)
    try:
        results = [f.result(timeout=30.0)
                   for f in scorer.submit_many(rows[:3])]
        assert len(results) == 3
        assert [r["trigger"] for r in metrics.records] == ["max_wait"]
        assert metrics.records[0]["latency_ms"] >= 40.0
    finally:
        scorer.close()


def test_flush_on_empty_queue_is_noop(day):
    rows, _, metrics, scorer = _scorer(day, max_batch=4,
                                       max_wait_ms=60_000.0)
    try:
        scorer.flush()
        time.sleep(0.05)
        [f.result(timeout=30.0) for f in scorer.submit_many(rows[:4])]
        assert [r["trigger"] for r in metrics.records] == ["max_batch"]
    finally:
        scorer.close()


def test_metrics_records_match_jax_keys(day):
    """The port's flush records carry the JAX package's keys, and the
    same scores on the host path."""
    (rows, model, cuts), (_, jmodel, jcuts) = day
    from oni_ml_tpu.config import ServingConfig as JServingConfig
    from oni_ml_tpu.serving import BatchScorer as JBatchScorer
    from oni_ml_tpu.serving import MetricsEmitter as JMetricsEmitter

    _, _, metrics, scorer = _scorer(day, max_batch=16, max_wait_ms=20.0)
    jreg = JModelRegistry()
    jreg.publish(jmodel, source="test")
    jmetrics = JMetricsEmitter(to_stdout=False)
    jscorer = JBatchScorer(jreg, JDnsEventFeaturizer(jcuts),
                           JServingConfig(max_batch=16, max_wait_ms=20.0,
                                          device_score_min=None),
                           metrics=jmetrics)
    try:
        got = [f.result(timeout=30.0) for f in scorer.submit_many(rows)]
        ref = [f.result(timeout=30.0) for f in jscorer.submit_many(rows)]
    finally:
        scorer.close()
        jscorer.close()
    assert got == ref
    assert {frozenset(r) for r in metrics.records} == \
        {frozenset(r) for r in jmetrics.records}
    assert all(r["scorer"] == "host" for r in metrics.records)
    snap = metrics.snapshot()
    assert snap["counters"]["serve.events"] == len(rows)
    assert set(snap["histograms"]) == set(jmetrics.snapshot()["histograms"])


def test_submit_rejects_malformed_events(day):
    rows, _, _, scorer = _scorer(day, max_batch=4, max_wait_ms=20.0)
    try:
        with pytest.raises(ValueError):
            scorer.submit("not,enough,columns")
        assert len([f.result(timeout=30.0)
                    for f in scorer.submit_many(rows[:4])]) == 4
        assert scorer.events_scored == 4
    finally:
        scorer.close()


def test_close_drains_queue(day):
    rows, _, _, scorer = _scorer(day, max_batch=7, max_wait_ms=60_000.0)
    futures = scorer.submit_many(rows)   # 96 events, not a multiple of 7
    scorer.close()
    assert scorer.events_scored == len(rows)
    assert all(f.done() for f in futures)
    with pytest.raises(RuntimeError):
        scorer.submit(rows[0])


def test_submit_backpressure_blocks_not_grows(day):
    rows, _, _, scorer = _scorer(day, max_batch=2, max_wait_ms=5.0,
                                 queue_max=4)
    depth = []
    orig = scorer._take_batch

    def spy():
        out = orig()
        with scorer._cond:
            depth.append(len(scorer._pending) + len(out[0]))
        return out

    scorer._take_batch = spy
    try:
        results = [f.result(timeout=60.0)
                   for f in scorer.submit_many(rows[:24])]
        assert len(results) == 24 and scorer.events_scored == 24
    finally:
        scorer.close()
    assert max(depth) <= 4


def test_exactly_once_under_concurrent_hot_swap(day):
    (rows, model, cuts), _ = day
    reg = ModelRegistry()
    reg.publish(model, source="v1")
    _, _, metrics, scorer = _scorer(day, registry=reg, max_batch=8,
                                    max_wait_ms=10.0)
    stop = threading.Event()
    published = []

    def swapper():
        i = 0
        while not stop.is_set():
            published.append(
                reg.publish(_perturbed(model, seed=i), f"swap{i}").version)
            i += 1
            time.sleep(0.005)

    t = threading.Thread(target=swapper)
    t.start()
    try:
        futures = [scorer.submit(r) for r in rows * 3]
        results = [f.result(timeout=60.0) for f in futures]
    finally:
        stop.set()
        t.join(timeout=30.0)
        scorer.close()
    assert not t.is_alive()
    assert len(results) == len(rows) * 3
    assert scorer.events_scored == len(rows) * 3
    assert all(np.isfinite(s) for s, _ in results)
    versions = {v for _, v in results}
    assert versions <= {1, *published} and published
    per_batch = {r["batch"]: r["model_version"] for r in metrics.records}
    assert len(per_batch) == scorer.batches_flushed
    # The events scored on version 1 got the day model's host scores.
    first = [(r, s) for r, (s, v) in zip(rows * 3, results) if v == 1]
    if first:
        feats = DnsEventFeaturizer(cuts)([r for r, _ in first])
        np.testing.assert_array_equal(score_features(model, feats, "dns"),
                                      [s for _, s in first])


def test_on_batch_error_does_not_kill_worker(day):
    calls = []

    def exploding(snapshot, feats, scores):
        calls.append(len(scores))
        raise ValueError("consumer bug")

    rows, _, metrics, scorer = _scorer(day, on_batch=exploding, max_batch=8,
                                       max_wait_ms=20.0)
    try:
        [f.result(timeout=30.0) for f in scorer.submit_many(rows[:8])]
        [f.result(timeout=30.0) for f in scorer.submit_many(rows[8:16])]
    finally:
        scorer.close()
    assert calls == [8, 8]
    assert scorer.events_scored == 16
    assert sum("on_batch_error" in r for r in metrics.records) == 2
    assert metrics.snapshot()["counters"]["serve.errors"] == 2


def test_a_failing_device_flush_fails_its_futures(day, monkeypatch):
    """No fallback: a device-path flush that raises fails its events'
    futures, so events_scored falls short of the submitted count."""
    def broken(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tscore, "device_scores", broken)
    rows, _, metrics, scorer = _scorer(day, max_batch=8, max_wait_ms=20.0,
                                       device_score_min=1)
    try:
        futures = scorer.submit_many(rows[:8])
        for f in futures:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=30.0)
        # The worker lives on.
        assert scorer.submit(rows[0]) is not None
    finally:
        scorer.close()
    assert scorer.events_scored == 0
    assert [r["error"] for r in metrics.records if "error" in r][0] == \
        "RuntimeError('device lost')"


@pytest.mark.parametrize("bad", [{"max_batch": 0}, {"queue_max": 0},
                                 {"max_wait_ms": 0.0}])
def test_batch_scorer_rejects_degenerate_config(day, bad):
    (_, model, cuts), _ = day
    reg = ModelRegistry()
    reg.publish(model, source="v1")
    with pytest.raises(ValueError):
        BatchScorer(reg, DnsEventFeaturizer(cuts), ServingConfig(**bad),
                    device=CPU)


# ---------------------------------------------------------------------------
# from_topic_probs and the refresh loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_terms", [None, "grown"])
def test_from_topic_probs_lambda_exact(day, num_terms):
    (_, model, _), _ = day
    p = np.asarray(model.p[:-1], np.float64)
    v = p.shape[0]
    nt = None if num_terms is None else v + 3
    cfg = OnlineLDAConfig(num_topics=model.num_topics)
    tr = OnlineLDATrainer.from_topic_probs(cfg, p, total_docs=100,
                                           num_terms=nt, device=CPU)
    jtr = JTrainer.from_topic_probs(
        JOnlineLDAConfig(num_topics=model.num_topics), p, total_docs=100,
        num_terms=nt)
    lam = tr.lam.numpy()
    assert lam.dtype == np.float32
    np.testing.assert_array_equal(lam, np.asarray(jtr.lam))
    assert tr.num_terms == (v if nt is None else nt) and tr.step_count == 0
    beta = lam.astype(np.float64) / lam.sum(-1, keepdims=True)
    np.testing.assert_allclose(beta.T[:v], p, atol=2e-3)


@pytest.mark.parametrize("case", ["shape", "negative", "nan", "shrink"])
def test_from_topic_probs_refusals_match_jax(day, case):
    (_, model, _), _ = day
    p = np.asarray(model.p[:-1], np.float64)
    kw = {}
    if case == "shape":
        p = p[:, :-1]
    elif case == "negative":
        p = -p
    elif case == "nan":
        p = np.full_like(p, np.nan)
    else:
        kw["num_terms"] = p.shape[0] - 1
    with pytest.raises(ValueError):
        OnlineLDATrainer.from_topic_probs(
            OnlineLDAConfig(num_topics=model.num_topics), p, total_docs=10,
            device=CPU, **kw)
    with pytest.raises(ValueError):
        JTrainer.from_topic_probs(
            JOnlineLDAConfig(num_topics=model.num_topics), p, total_docs=10,
            **kw)


def test_from_topic_probs_resume_wins_over_seed(day, tmp_path):
    from oni_ml_tpu_torch.models.online_lda import save_stream_checkpoint

    (_, model, _), _ = day
    p = np.asarray(model.p[:-1], np.float64)
    cfg = OnlineLDAConfig(num_topics=model.num_topics)
    ckpt = str(tmp_path / "stream.npz")
    lam_ckpt = np.full((cfg.num_topics, p.shape[0]), 3.25)
    save_stream_checkpoint(ckpt, lam_ckpt, cfg.alpha, step=5,
                           history=[(-1.0, 0.1)] * 5)
    tr = OnlineLDATrainer.from_topic_probs(cfg, p, total_docs=100,
                                           checkpoint_path=ckpt, device=CPU)
    assert tr.step_count == 5
    np.testing.assert_array_equal(tr.lam.numpy(), lam_ckpt)


@pytest.mark.parametrize("dense_em", ["auto", "on", "off"])
def test_refresh_matches_jax(day, dense_em):
    """One refresh on the same model and evidence: p and theta within
    the online bounds of the JAX package's refresh (its dense E-step
    where the densified batch fits); the port on the CPU through the
    per-batch plain E-step ("auto", "off") or the dense one ("on")."""
    (rows, model, cuts), (_, jmodel, jcuts) = day
    reg, jreg = ModelRegistry(), JModelRegistry()
    snap = reg.publish(model, source="day0")
    jsnap = jreg.publish(jmodel, source="day0")
    loop = RefreshLoop(reg, OnlineLDAConfig(num_topics=model.num_topics,
                                            dense_em=dense_em),
                       every=2, device=CPU)
    jloop = JRefreshLoop(jreg, JOnlineLDAConfig(num_topics=model.num_topics),
                         every=2)
    feats = DnsEventFeaturizer(cuts)(rows[:48])
    ips, words = event_documents(feats, "dns")
    assert loop.observe(snap, ips, words) is None
    assert jloop.observe(jsnap, ips, words) is None
    new = loop.observe(snap, ips, words)
    jnew = jloop.observe(jsnap, ips, words)
    assert (new.version, new.source) == (jnew.version, jnew.source) == \
        (2, "refresh-step1")
    assert reg.active() is new and loop.refreshes == 1
    assert loop.last_refresh_s > 0
    m, jm = new.model, jnew.model
    assert m.ip_index is model.ip_index and m.word_index is model.word_index
    validate_model(m)
    np.testing.assert_allclose(m.p, jm.p, rtol=RTOL_LAM, atol=ATOL_LAM)
    np.testing.assert_allclose(m.theta, jm.theta, rtol=RTOL_LAM,
                               atol=ATOL_LAM)
    assert not np.allclose(m.p[:-1], model.p[:-1])   # the topics moved
    np.testing.assert_array_equal(m.p[-1], model.p[-1])  # fallback kept
    # The batch it trained on: B and L padded to multiples of 8.
    loop.observe(new, ips, words)
    batch, got_ips = loop._build_batch()
    jloop.observe(jnew, ips, words)
    jbatch, jgot_ips = jloop._build_batch()
    assert got_ips == jgot_ips
    for name in ("word_idx", "counts", "doc_index", "doc_mask"):
        np.testing.assert_array_equal(getattr(batch, name),
                                      getattr(jbatch, name))
    assert batch.word_idx.shape[0] % 8 == 0 and batch.word_idx.shape[1] % 8 == 0


def test_refresh_skips_unseen_evidence_and_empty_cadence(day):
    (_, model, _), _ = day
    reg = ModelRegistry()
    snap = reg.publish(model, source="day0")
    loop = RefreshLoop(reg, every=1, device=CPU)
    assert loop.observe(snap, [], []) is None and reg.version == 1
    ip, word = next(iter(model.ip_index)), next(iter(model.word_index))
    new = loop.observe(snap, [ip, "10.99.99.99", ip],
                       [word, word, "not_a_word"])
    assert new is not None and new.version == 2
    fallback_row = len(model.ip_index)
    np.testing.assert_array_equal(new.model.theta[fallback_row],
                                  model.theta[fallback_row])
    with pytest.raises(ValueError):
        RefreshLoop(reg, OnlineLDAConfig(num_topics=model.num_topics + 1),
                    device=CPU)


# ---------------------------------------------------------------------------
# the CLI: dry run, golden day against the JAX package, refused flags
# ---------------------------------------------------------------------------


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_dry_run_cli_on_cpu_matches_jax(capsys):
    """Both dry runs at one --max-batch and a --max-wait-ms far past the
    run: only size and close trigger a flush, so `batches` and
    `triggers` do not hang on the wall clock."""
    flush = ["--max-batch", "32", "--max-wait-ms", "600000"]
    assert ml_ops.main(["serve", "--dry-run", "--device", "cpu",
                        "--device-score-min", "1000000", *flush]) == 0
    port = _last_json(capsys.readouterr().out)
    assert jml_ops.main(["serve", "--dry-run", "--no-compilation-cache",
                         "--device-score-min", "1000000", *flush]) == 0
    ref = _last_json(capsys.readouterr().out)
    assert port["serve_dry_run"] == "ok" and port["device"] == "cpu"
    for key in ("events", "events_scored", "batches", "triggers",
                "refresh_swaps", "model_versions_served",
                "final_model_version"):
        assert port[key] == ref[key], key


def test_dry_run_honors_flags(capsys):
    assert ml_ops.main(["serve", "--dry-run", "--device", "cpu",
                        "--max-batch", "8", "--refresh-every", "1"]) == 0
    summary = _last_json(capsys.readouterr().out)
    assert summary["serve_dry_run"] == "ok"
    assert summary["batches"] == 12          # 96 events / max_batch 8
    assert summary["refresh_swaps"] >= 2


@pytest.mark.parametrize("flag", [["--fleet", "synthetic"],
                                  ["--hot-tenants", "4"],
                                  ["--warm-tenants", "4"],
                                  ["--residency-policy", "lru"],
                                  ["--residency-spill", "d"],
                                  ["--stack-precision", "bf16"],
                                  ["--no-compilation-cache"]])
def test_unported_flags_are_refused_naming_the_roadmap(flag, capsys):
    """--no-compilation-cache is still refused, naming ROADMAP Queue 1
    item 4.  The fleet's flags (item 7's fleet, now ported) run: each
    under the fleet dry run on the CPU, which passes."""
    if flag[0] == "--no-compilation-cache":
        with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 4"):
            serve.main(["--dry-run", "--device", "cpu", *flag])
        return
    fleet = [] if flag[0] == "--fleet" else ["--fleet", "synthetic"]
    assert serve.main(["--dry-run", "--device", "cpu",
                       "--device-score-min", "1000000", *fleet, *flag]) == 0
    summary = _last_json(capsys.readouterr().out)
    assert summary["serve_fleet_dry_run"] == "ok"
    assert summary["device"] == "cpu"


HEADER_CASES = [
    ("tstart,year,month,day,hour,min,sec,tdur,sip,dip,sport,dport,proto,"
     "flag,fwd,stos,ipkt,ibyt,opkt,obyt,in,out,sas,das,dtos,dir,rip", "flow"),
    ("2016-01-22 00:00:00,2016,1,22,5,38,2,0.0,10.0.0.2,10.1.0.3,46720,53,"
     "TCP,,0,0,69,26614,0,0,0,0,0,0,0,0,0", "flow"),
    ("frame_time,unix_tstamp,frame_len,ip_dst,dns_qry_name,dns_qry_class,"
     "dns_qry_type,dns_qry_rcode", "dns"),
    ("t,1454000000,100,10.0.0.1,a.example.com,1,1,0", "dns"),
    ("short", "flow"),
    ("garbage,x,y,z,notanumber,5", "flow"),
    ("", "dns"),
]


@pytest.mark.parametrize("line,dsource", HEADER_CASES + [
    (",".join(get_source("proxy").columns), "proxy"),
    (_proxy_lines(1)[1], "proxy")])
def test_header_detection_matches_jax(line, dsource):
    assert serve._looks_like_header(line, dsource) == \
        jserve._looks_like_header(line, dsource)


@pytest.fixture(scope="module")
def golden_days(tmp_path_factory):
    """The golden flow day through each package's runner on the CPU
    (the port from the JAX initial beta, 5 EM iterations each)."""
    root = tmp_path_factory.mktemp("serve_golden")
    mp = pytest.MonkeyPatch()
    mp.setenv("ONI_ML_TPU_PLAN_CACHE", str(root / "plans.jsonl"))
    try:
        jml_ops.run_pipeline(JPipelineConfig(
            data_dir=str(root / "jax"), flow_path=GOLDEN_FLOW,
            lda=JLDAConfig(num_topics=20, em_max_iters=5,
                           estep_engine="sparse", fused_em_chunk=1),
            scoring=JScoringConfig(threshold=1e-20),
            telemetry=JTelemetryConfig(journal=False),
            dataplane=JDataplaneConfig(enabled=False)), "20160122", "flow")
        jday = root / "jax" / "20160122"
        from oni_ml_tpu_torch.io import formats

        v = len(formats.read_words_dat(str(jday / "words.dat")))
        init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), 20, v))
        ml_ops.run_pipeline(PipelineConfig(
            data_dir=str(root / "port"), flow_path=GOLDEN_FLOW,
            lda=LDAConfig(num_topics=20, em_max_iters=5,
                          estep_engine="sparse"),
            scoring=ScoringConfig(threshold=1e-20)), "20160122", "flow",
            device=CPU, initial_log_beta=init, emit=lambda *a, **k: None)
    finally:
        mp.undo()
    return root / "port" / "20160122", jday


def _serve_out(main, argv, monkeypatch, capsys):
    with open(GOLDEN_FLOW) as f:
        monkeypatch.setattr("sys.stdin", io.StringIO(f.read()))
    assert main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    flagged = [r for r in lines if isinstance(r.get("flagged"), list)]
    records = [r for r in lines if r.get("stage") == "serve"]
    return flagged, records


def test_golden_day_serve_matches_jax(golden_days, monkeypatch, capsys,
                                      tmp_path):
    port_day, jax_day = golden_days
    common = ["--threshold", "1.1", "--max-batch", "16",
              "--device-score-min", "1000000", "--no-plans"]
    flagged, recs = _serve_out(
        ml_ops.main, ["serve", "--day-dir", str(port_day), "--device", "cpu",
                      "--openmetrics", str(tmp_path / "om.txt"), *common],
        monkeypatch, capsys)
    jflagged, jrecs = _serve_out(
        jml_ops.main, ["serve", "--day-dir", str(jax_day),
                       "--no-compilation-cache", *common],
        monkeypatch, capsys)
    assert len(flagged) == len(jflagged) == 61
    assert [r["flagged"] for r in flagged] == [r["flagged"] for r in jflagged]
    assert [r["model_version"] for r in flagged] == \
        [r["model_version"] for r in jflagged]
    np.testing.assert_allclose([r["score"] for r in flagged],
                               [r["score"] for r in jflagged],
                               rtol=RTOL_GOLDEN_SCORE)

    def keys(records):
        out = []
        for r in records:
            k = set(r)
            if r.get("event") == "plans":
                # The JAX package's compilation cache has no counterpart;
                # the port names its calibration and plan counters.
                k -= {"compilation_cache", "dispatch_calibration",
                      "plan_counters"}
            out.append(frozenset(k))
        return out

    assert keys(recs) == keys(jrecs)
    end = [r for r in recs if r.get("event") == "stream_end"][0]
    assert end["submitted"] == end["events_scored"] == 61
    assert end["header_skipped"] == 1
    assert (tmp_path / "om.txt").read_text().endswith("# EOF\n")


def test_serve_stream_with_refresh_on_the_cpu_day(golden_days, monkeypatch,
                                                  capsys, tmp_path):
    """The port's CLI with refresh on: every event scored once, at least
    two model versions served, a refresh record per swap, the metrics
    file holding each record, a journal, and the host-only roofline."""
    port_day, _ = golden_days
    metrics_path = tmp_path / "m.jsonl"
    journal = tmp_path / "serve_journal.jsonl"
    flagged, recs = _serve_out(
        ml_ops.main, ["serve", "--day-dir", str(port_day), "--device", "cpu",
                      "--threshold", "1.1", "--max-batch", "8",
                      "--refresh-every", "2", "--metrics", str(metrics_path),
                      "--journal", str(journal)], monkeypatch, capsys)
    refreshes = [r for r in recs if r.get("event") == "model_refresh"]
    assert len(refreshes) >= 2 and all(r["refresh_s"] > 0 for r in refreshes)
    assert len({r["model_version"] for r in flagged}) >= 2
    end = [r for r in recs if r.get("event") == "stream_end"][0]
    assert end["events_scored"] == end["submitted"] == len(flagged) == 61
    assert end["final_model_version"] == 1 + len(refreshes)
    assert not any("error" in r or "on_batch_error" in r for r in recs)
    plans_rec = [r for r in recs if r.get("event") == "plans"][0]
    assert plans_rec["dispatch_calibration"]["source"] in ("measured", "plan")
    with open(metrics_path) as f:
        assert [json.loads(ln) for ln in f] == recs
    from oni_ml_tpu_torch.telemetry import Journal

    kinds = {r.get("kind") for r in Journal.replay(str(journal))}
    assert {"serve", "roofline"} <= kinds


def test_serve_refuses_another_days_features(golden_days, tmp_path):
    port_day, jax_day = golden_days
    with pytest.raises(SystemExit, match="holds flow features"):
        serve.main(["--day-dir", str(port_day), "--dsource", "dns",
                    "--device", "cpu", "--input", GOLDEN_DNS])
    import pickle

    with pytest.raises(pickle.UnpicklingError):
        serve.main(["--day-dir", str(jax_day), "--device", "cpu",
                    "--input", GOLDEN_FLOW])


# ---------------------------------------------------------------------------
# warm-up, roofline and the OpenMetrics endpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_min,want", [
    (None, []), (1, [1, 2, 4, 8, 16]), (5, [8, 16]), (100, [])])
def test_warmup_serving_sizes(day, device_min, want):
    (_, model, _), _ = day
    got = warmup_serving(model, 12, device_min, device=CPU)
    assert got["warmed"] == len(want)
    if want:
        assert got["sizes"] == want and got["wall_s"] >= 0
    else:
        assert got == {"warmed": 0, "reason": "host path pinned"}


def test_serve_roofline_records(day):
    rec = Recorder()
    metrics = MetricsEmitter(to_stdout=False, recorder=rec)
    refresh = serve._make_serve_roofline(metrics, None, k=5)
    assert refresh() is None
    metrics.emit({"stage": "serve", "events": 100, "scorer": "host",
                  "score_ms": 2.0})
    host = refresh()
    assert host["entry"] == "serve.micro_batch.host" and host["flops"] is None
    for n in (100, 300):
        metrics.emit({"stage": "serve", "events": n, "scorer": "device",
                      "score_ms": 1.0})
    dev = refresh()
    assert dev["entry"] == "serve.micro_batch" and dev["dispatches"] == 2
    flops, nbytes = roofline.micro_batch_cost(400, 5)
    assert dev["flops"] == pytest.approx(flops)
    assert dev["bytes"] == pytest.approx(nbytes)
    assert dev["wall_s"] == pytest.approx(2e-3)
    assert nbytes == 400 * (8 + 40 + 4) and flops == 400 * 10


def test_openmetrics_text_endpoint_and_file_match_jax(tmp_path):
    rec, jrec = Recorder(), JRecorder()
    for r in (rec, jrec):
        r.counter("serve.events").add(96)
        for v in (1.5, 3.0, 40.0):
            r.histogram("serve.latency_ms").observe(v)
        r.gauge("roofline.serve.micro_batch.flops_per_s", 1.25e9)
    calls = []
    text = render_openmetrics(rec, refresh=lambda: calls.append(1))
    assert calls == [1]
    assert text == jrender(jrec)
    write_openmetrics(str(tmp_path / "om.txt"), rec)
    assert (tmp_path / "om.txt").read_text() == text
    server = MetricsServer(rec, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            assert r.read().decode() == text
            assert r.headers["Content-Type"].startswith(
                "application/openmetrics-text")
    finally:
        server.close()
