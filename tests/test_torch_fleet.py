"""The port's multi-tenant serving fleet (oni_ml_tpu_torch/serving/
fleet.py, tenants.py, the fleet's metrics and runner/serve.py's --fleet)
against the JAX package's, on the CPU: the same seeded days and tenants
through both.

Tolerances: the host scorer is float64 in the same k order on both
sides, so packed host-path scores are bit-equal to the JAX fleet's and
to each tenant scored alone; device-path dispatches (float32 gathers and
multiply-adds) are within rel 1e-6 of the host's."""

import json
import os
import pickle
import threading
import time
import urllib.request

import numpy as np
import pytest

from oni_ml_tpu.config import ServingConfig as JServingConfig
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu.runner import serve as jserve
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.serving import DnsEventFeaturizer as JDnsEventFeaturizer
from oni_ml_tpu.serving import FleetRegistry as JFleetRegistry
from oni_ml_tpu.serving import FleetScorer as JFleetScorer
from oni_ml_tpu.serving import FlowEventFeaturizer as JFlowEventFeaturizer
from oni_ml_tpu.serving import TenantSpec as JTenantSpec
from oni_ml_tpu.serving import demux_scores as jdemux_scores
from oni_ml_tpu.serving import parse_manifest as jparse_manifest
from oni_ml_tpu_torch.config import OnlineLDAConfig, ServingConfig
from oni_ml_tpu_torch.models.convert import (scoring_model_from_reference,
                                             stacked_snapshot_from_reference)
from oni_ml_tpu_torch.runner import ml_ops, serve
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.serving import (AdmissionRejected, DnsEventFeaturizer,
                                      FleetRegistry, FleetScorer,
                                      FlowEventFeaturizer, MetricsEmitter,
                                      RefreshLoop, TenantSpec, demux_scores,
                                      event_documents, load_manifest,
                                      parse_manifest, score_features)
from oni_ml_tpu_torch.telemetry import Journal, MetricsServer
from oni_ml_tpu_torch.telemetry.spans import Recorder

CPU = "cpu"
RTOL_DEVICE = 1e-6
TENANTS = ("t0", "t1", "t2")


@pytest.fixture(scope="module")
def days():
    """Three synthetic DNS days (distinct seeds, so distinct models; one
    K, so one pack group), each as (port day, JAX day): the same draws."""
    return {f"t{i}": (serve._synthetic_day(seed=42 + i),
                      jserve._synthetic_day(seed=42 + i))
            for i in range(3)}


def _perturbed(model, seed: int = 7):
    return serve._perturbed_model(model, seed)


def _fleet(days, tenants=("t0", "t1"), **cfg_kw):
    """A port FleetRegistry + FleetScorer over `tenants` on the CPU,
    host-pinned unless cfg_kw says otherwise."""
    fleet = FleetRegistry()
    featurizers = {}
    for t in tenants:
        rows, model, cuts = days[t][0]
        fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
        fleet.publish(t, model, source=f"day-{t}")
        featurizers[t] = DnsEventFeaturizer(cuts)
    cfg_kw.setdefault("device_score_min", None)
    metrics = MetricsEmitter(to_stdout=False)
    scorer = FleetScorer(fleet, featurizers, ServingConfig(**cfg_kw),
                         metrics=metrics, device=CPU)
    return fleet, featurizers, metrics, scorer


def _jfleet(days, tenants=("t0", "t1"), **cfg_kw):
    fleet = JFleetRegistry()
    featurizers = {}
    for t in tenants:
        rows, model, cuts = days[t][1]
        fleet.add_tenant(JTenantSpec(tenant=t, dsource="dns"))
        fleet.publish(t, model, source=f"day-{t}")
        featurizers[t] = JDnsEventFeaturizer(cuts)
    cfg_kw.setdefault("device_score_min", None)
    scorer = JFleetScorer(fleet, featurizers, JServingConfig(**cfg_kw))
    return fleet, featurizers, scorer


def _interleaved(scorer, days, tenants, n, side=0):
    futs = {t: [] for t in tenants}
    for i in range(n):
        for t in tenants:
            futs[t].append(scorer.submit(t, days[t][side][0][i]))
    scorer.flush()
    out = {t: [f.result(30.0) for f in fs] for t, fs in futs.items()}
    scorer.close()
    return out


def _alone(days, t, n, device_min=None):
    rows, model, cuts = days[t][0]
    fz = DnsEventFeaturizer(cuts)
    feats = fz([fz.validate(r) for r in rows[:n]])
    return score_features(model, feats, "dns", device_min=device_min,
                          device=CPU)


# ---------------------------------------------------------------------------
# specs and manifests
# ---------------------------------------------------------------------------

BAD_SPECS = {
    "dots": {"tenant": "bad.dots", "dsource": "dns"},
    "dash": {"tenant": "acme-eu", "dsource": "dns"},
    "empty": {"tenant": "", "dsource": "dns"},
    "dsource": {"tenant": "a", "dsource": "http"},
    "admission": {"tenant": "a", "dsource": "dns", "admission": "drop"},
    "queue_max": {"tenant": "a", "dsource": "dns", "queue_max": -1},
    "weight": {"tenant": "a", "dsource": "dns", "weight": 0.0},
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_tenant_spec_rejections_match_jax(case):
    with pytest.raises(ValueError) as port:
        TenantSpec(**BAD_SPECS[case])
    with pytest.raises(ValueError) as ref:
        JTenantSpec(**BAD_SPECS[case])
    assert str(port.value) == str(ref.value)


BAD_MANIFESTS = {
    "duplicate": {"tenants": [{"tenant": "a", "dsource": "dns"},
                              {"tenant": "a", "dsource": "dns"}]},
    "unknown_key": {"tenants": [{"tenant": "a", "dsourc": "dns"}]},
    "zero": {"tenants": []},
    "not_a_dict": ["a"],
    "entry_not_object": {"tenants": ["a"]},
}


@pytest.mark.parametrize("case", sorted(BAD_MANIFESTS))
def test_manifest_rejections_match_jax(case):
    with pytest.raises(ValueError) as port:
        parse_manifest(BAD_MANIFESTS[case])
    with pytest.raises(ValueError) as ref:
        jparse_manifest(BAD_MANIFESTS[case])
    assert str(port.value) == str(ref.value)


def test_manifest_roundtrip(tmp_path):
    path = str(tmp_path / "fleet.json")
    with open(path, "w") as f:
        json.dump({"tenants": [
            {"tenant": "alpha", "day_dir": "/d/a", "dsource": "flow",
             "weight": 2.0},
            {"tenant": "beta", "day_dir": "/d/b", "dsource": "dns",
             "queue_max": 64, "admission": "reject", "refresh_every": 3},
        ]}, f)
    specs = load_manifest(path)
    assert [s.tenant for s in specs] == ["alpha", "beta"]
    assert (specs[0].weight, specs[1].admission, specs[1].queue_max,
            specs[1].refresh_every) == (2.0, "reject", 64, 3)


# ---------------------------------------------------------------------------
# FleetRegistry: per-tenant hot-swap and stacked snapshots
# ---------------------------------------------------------------------------


def test_registry_per_tenant_versions_monotonic(days):
    fleet = FleetRegistry()
    for t in ("t0", "t1"):
        fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
    m0, m1 = days["t0"][0][1], days["t1"][0][1]
    fleet.publish("t0", m0, "a")
    fleet.publish("t1", m1, "b")
    fleet.publish("t0", _perturbed(m0), "a2")
    assert (fleet.version("t0"), fleet.version("t1")) == (2, 1)
    assert fleet.previous("t0").version == 1
    assert fleet.previous("t0").model is m0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_stacked_snapshot_offsets_and_contents_match_jax(days, precision):
    fleet = FleetRegistry(stack_precision=precision)
    jfleet = JFleetRegistry(stack_precision=precision)
    for t in TENANTS:
        fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
        jfleet.add_tenant(JTenantSpec(tenant=t, dsource="dns"))
        fleet.publish(t, days[t][0][1], t)
        jfleet.publish(t, days[t][1][1], t)
    stack, jstack = fleet.stack_for("t0"), jfleet.stack_for("t0")
    assert stack.tenants == jstack.tenants == TENANTS
    assert stack.ip_base == jstack.ip_base
    assert stack.word_base == jstack.word_base
    assert (stack.stack_version, stack.capacity, stack.precision) == \
        (jstack.stack_version, jstack.capacity, jstack.precision)
    np.testing.assert_array_equal(stack.model.theta, jstack.model.theta)
    np.testing.assert_array_equal(stack.model.p, jstack.model.p)
    marker = getattr(stack.model, "_device_dtype", None)
    assert marker == getattr(jstack.model, "_device_dtype", None)
    assert marker == ("bfloat16" if precision == "bf16" else None)
    # Each tenant's slice, its fallback row included, is its own model.
    for t in TENANTS:
        m = days[t][0][1]
        i0, w0 = stack.ip_base[t], stack.word_base[t]
        np.testing.assert_array_equal(
            stack.model.theta[i0:i0 + m.theta.shape[0]], m.theta)
        np.testing.assert_array_equal(stack.model.p[w0:w0 + m.p.shape[0]],
                                      m.p)
    # The JAX stack carried across is the port's, field for field.
    conv = stacked_snapshot_from_reference(jstack)
    assert (conv.k, conv.tenants, conv.ip_base, conv.word_base,
            conv.precision) == (stack.k, stack.tenants, stack.ip_base,
                                stack.word_base, stack.precision)
    np.testing.assert_array_equal(conv.model.theta, stack.model.theta)
    assert getattr(conv.model, "_device_dtype", None) == marker
    assert {t: s.version for t, s in conv.members.items()} == \
        {t: s.version for t, s in stack.members.items()}


def test_scoring_model_from_reference_round_trips(days):
    jmodel = days["t1"][1][1]
    model = scoring_model_from_reference(jmodel)
    assert isinstance(model, ScoringModel)
    assert model.ip_index == jmodel.ip_index
    assert model.word_index == jmodel.word_index
    np.testing.assert_array_equal(model.theta, jmodel.theta)
    np.testing.assert_array_equal(model.p, jmodel.p)


def test_stack_double_buffered_install(days):
    fleet = FleetRegistry()
    for t in ("t0", "t1"):
        fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
        fleet.publish(t, days[t][0][1], t)
    before = fleet.stack_for("t0")
    theta_before = before.model.theta.copy()
    fleet.publish("t0", _perturbed(days["t0"][0][1]), "swap")
    after = fleet.stack_for("t0")
    assert after is not before
    assert after.stack_version > before.stack_version
    np.testing.assert_array_equal(before.model.theta, theta_before)
    m1 = days["t1"][0][1]
    w0 = after.word_base["t1"]
    np.testing.assert_array_equal(after.model.p[w0:w0 + m1.p.shape[0]], m1.p)
    assert (after.version_of("t0"), after.version_of("t1")) == (2, 1)


def test_registry_errors(days):
    fleet = FleetRegistry()
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"))
    with pytest.raises(ValueError, match="already added"):
        fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"))
    with pytest.raises(KeyError, match="unknown tenant"):
        fleet.active("nope")
    with pytest.raises(RuntimeError, match="no model published"):
        fleet.active("t0")
    with pytest.raises(RuntimeError, match="no published model"):
        fleet.tenant_k("t0")
    with pytest.raises(ValueError, match="stack_precision"):
        FleetRegistry(stack_precision="f16")


def test_fleet_publish_journal_and_counter(days, tmp_path):
    jpath = str(tmp_path / "fleet.jsonl")
    journal = Journal(jpath)
    rec = Recorder()
    fleet = FleetRegistry(journal=journal, recorder=rec)
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"))
    m = days["t0"][0][1]
    fleet.publish("t0", m, "day-one")
    fleet.publish("t0", _perturbed(m), "refresh")
    journal.close()
    records = [r for r in Journal.replay(jpath)
               if r["kind"] == "fleet_publish"]
    assert [r["version"] for r in records] == [1, 2]
    assert (records[0]["tenant"], records[0]["source"], records[0]["k"]) \
        == ("t0", "day-one", m.num_topics)
    assert rec.counters["serve.t0.publishes"].value == 2


def test_refresh_loop_over_fleet_view(days):
    """The refresh loop binds to a tenant's view: its publish bumps that
    tenant's version and rebuilds the stack."""
    fleet = FleetRegistry()
    rows, model, cuts = days["t0"][0]
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"))
    fleet.publish("t0", model, "day")
    loop = RefreshLoop(fleet.view("t0"),
                       OnlineLDAConfig(num_topics=model.num_topics),
                       every=1, device=CPU)
    fz = DnsEventFeaturizer(cuts)
    ips, words = event_documents(fz([fz.validate(r) for r in rows[:16]]),
                                 "dns")
    new = loop.observe(fleet.active("t0"), ips, words)
    assert new is not None and new.version == 2 == fleet.version("t0")
    assert fleet.stack_for("t0").version_of("t0") == 2


# ---------------------------------------------------------------------------
# packed scoring against the JAX fleet and against tenants alone
# ---------------------------------------------------------------------------


def test_packed_host_scores_bit_equal_to_jax_and_to_alone(days):
    _, _, metrics, scorer = _fleet(days, tenants=TENANTS)
    got = _interleaved(scorer, days, TENANTS, 64)
    _, _, jscorer = _jfleet(days, tenants=TENANTS)
    ref = _interleaved(jscorer, days, TENANTS, 64, side=1)
    for t in TENANTS:
        assert got[t] == ref[t]              # scores and versions
        np.testing.assert_array_equal([s for s, _ in got[t]],
                                      _alone(days, t, 64))
    agg = [r for r in metrics.records if "tenant" not in r
           and isinstance(r.get("tenants"), int)]
    assert any(r["tenants"] == 3 and r["segments"] == 1 for r in agg)


def test_packed_device_path_within_rel_of_host_and_jax(days):
    """device_score_min 1: every K-group dispatch on the device (here
    the CPU's plain ops): float32, within rel 1e-6 of the host's float64
    and of the JAX fleet's device path."""
    _, _, metrics, scorer = _fleet(days, tenants=TENANTS,
                                   device_score_min=1)
    got = _interleaved(scorer, days, TENANTS, 48)
    _, _, jscorer = _jfleet(days, tenants=TENANTS, device_score_min=1)
    ref = _interleaved(jscorer, days, TENANTS, 48, side=1)
    for t in TENANTS:
        s = np.array([v for v, _ in got[t]])
        np.testing.assert_allclose(s, _alone(days, t, 48), rtol=RTOL_DEVICE)
        np.testing.assert_allclose(s, [v for v, _ in ref[t]],
                                   rtol=RTOL_DEVICE)
    agg = [r for r in metrics.records if "segments" in r]
    assert agg and all(r["scorer"] == "device" for r in agg)


def test_mixed_k_tenants_get_separate_stacks(days):
    """Tenants of another K form their own pack group: more dispatches,
    the same scores (those of the JAX fleet, bit for bit)."""
    rows0, m0, cuts0 = days["t0"][0]
    rows1, m1, cuts1 = days["t1"][0]
    rng = np.random.default_rng(0)
    ips = sorted(m1.ip_index, key=m1.ip_index.get)
    vocab = sorted(m1.word_index, key=m1.word_index.get)
    k2 = m1.num_topics + 1
    jm1b = JScoringModel.from_results(
        ips, rng.dirichlet(np.ones(k2), size=len(ips)),
        vocab, rng.dirichlet(np.ones(len(vocab)), size=k2).T, fallback=0.1)
    m1b = scoring_model_from_reference(jm1b)
    out = []
    for reg_cls, spec_cls, fz_cls, scorer_cls, cfg, models, kw in (
            (FleetRegistry, TenantSpec, DnsEventFeaturizer, FleetScorer,
             ServingConfig, (m0, m1b), {"device": CPU}),
            (JFleetRegistry, JTenantSpec, JDnsEventFeaturizer, JFleetScorer,
             JServingConfig, (days["t0"][1][1], jm1b), {})):
        fleet = reg_cls()
        for t, m in zip(("t0", "t1"), models):
            fleet.add_tenant(spec_cls(tenant=t, dsource="dns"))
            fleet.publish(t, m, t)
        assert fleet.stack_for("t0").tenants == ("t0",)
        assert fleet.stack_for("t1").tenants == ("t1",)
        metrics = MetricsEmitter(to_stdout=False)
        scorer = scorer_cls(fleet, {"t0": fz_cls(cuts0), "t1": fz_cls(cuts1)},
                            cfg(device_score_min=None),
                            **({"metrics": metrics} if kw else {}), **kw)
        futs0 = [scorer.submit("t0", r) for r in rows0[:8]]
        futs1 = [scorer.submit("t1", r) for r in rows1[:8]]
        scorer.flush()
        out.append(([f.result(30.0)[0] for f in futs0],
                    [f.result(30.0)[0] for f in futs1]))
        scorer.close()
        if kw:
            agg = [r for r in metrics.records
                   if "segments" in r and "tenant" not in r]
            assert any(r["segments"] == 2 and r["tenants"] == 2
                       for r in agg)
    assert out[0] == out[1]
    np.testing.assert_array_equal(out[0][0], _alone(days, "t0", 8))


def _flow_day():
    """A small flow day through both packages' featurizers (the same
    rows), with one random K=5 model over its IPs and words."""
    from oni_ml_tpu_torch.features.flow import featurize_flow
    from oni_ml_tpu_torch.sources import get

    lines = get("flow").synth_benign(48, 5)
    feats = featurize_flow(lines)
    ips = sorted({feats.sip(i) for i in range(feats.num_events)}
                 | {feats.dip(i) for i in range(feats.num_events)})
    vocab = sorted(set(feats.src_word) | set(feats.dest_word))
    rng = np.random.default_rng(3)
    k = 5
    jmodel = JScoringModel.from_results(
        ips, rng.dirichlet(np.ones(k), size=len(ips)),
        vocab, rng.dirichlet(np.ones(len(vocab)), size=k).T, fallback=0.05)
    cuts = (feats.time_cuts, feats.ibyt_cuts, feats.ipkt_cuts)
    return lines, jmodel, cuts


def test_flow_tenant_pairs_min_combined_match_jax(days):
    """A flow tenant's two pairs per event (src block, then dst block)
    min-combine at demux; a flow and a DNS tenant of one K pack into one
    dispatch; every score equals the JAX fleet's."""
    lines, jflow_model, cuts = _flow_day()
    flow_model = scoring_model_from_reference(jflow_model)
    out = []
    for side in (0, 1):
        rows_dns, dns_model, dns_cuts = days["t0"][side]
        if side == 0:
            fleet, spec = FleetRegistry(), TenantSpec
            fzs = {"fl": FlowEventFeaturizer(cuts),
                   "dn": DnsEventFeaturizer(dns_cuts)}
        else:
            fleet, spec = JFleetRegistry(), JTenantSpec
            fzs = {"fl": JFlowEventFeaturizer(cuts),
                   "dn": JDnsEventFeaturizer(dns_cuts)}
        fleet.add_tenant(spec(tenant="fl", dsource="flow"))
        fleet.add_tenant(spec(tenant="dn", dsource="dns"))
        fleet.publish("fl", flow_model if side == 0 else jflow_model, "fl")
        fleet.publish("dn", dns_model, "dn")
        metrics = MetricsEmitter(to_stdout=False)
        if side == 0:
            scorer = FleetScorer(fleet, fzs, ServingConfig(
                device_score_min=None), metrics=metrics, device=CPU)
        else:
            scorer = JFleetScorer(fleet, fzs,
                                  JServingConfig(device_score_min=None))
        f_futs = [scorer.submit("fl", ln) for ln in lines[:16]]
        d_futs = [scorer.submit("dn", r) for r in rows_dns[:16]]
        scorer.flush()
        out.append(([f.result(30.0)[0] for f in f_futs],
                    [f.result(30.0)[0] for f in d_futs]))
        scorer.close()
        if side == 0:
            agg = [r for r in metrics.records if "tenant" not in r
                   and isinstance(r.get("tenants"), int)]
            assert any(r["tenants"] == 2 and r["segments"] == 1
                       for r in agg)
    assert out[0] == out[1]
    ffz = FlowEventFeaturizer(cuts)
    np.testing.assert_array_equal(
        out[0][0], score_features(flow_model, ffz(lines[:16]), "flow",
                                  device_min=None, device=CPU))


def test_scorer_label_tracks_actual_dispatch(days, monkeypatch):
    """The flush's `scorer` label follows the per-group packed pair
    count's dispatch decision."""
    from oni_ml_tpu_torch.serving import fleet as fleet_mod

    for threshold, want in ((40, "host"), (20, "device")):
        monkeypatch.setattr(fleet_mod, "use_device_path",
                            lambda n, dmin, dev, th=threshold: n >= th)
        _, _, metrics, scorer = _fleet(days, fleet_max_batch=32,
                                       fleet_max_wait_ms=60_000.0)
        futs = [scorer.submit(t, days[t][0][0][i])
                for i in range(16) for t in ("t0", "t1")]
        [f.result(30.0) for f in futs]
        scorer.close()
        agg = [r for r in metrics.records
               if "tenant" not in r and "segments" in r]
        assert agg and all(r["scorer"] == want for r in agg)
        assert all(r["segments_device"] == (r["segments"] if want == "device"
                                            else 0) for r in agg)


def test_demux_scores_matches_jax():
    s = np.array([0.4, 0.9, 0.7, 0.2, 0.8, 0.1])
    for mult in (1, 2, 3):
        np.testing.assert_array_equal(demux_scores(s, mult),
                                      jdemux_scores(s, mult))
    np.testing.assert_array_equal(demux_scores(s, 2), [0.2, 0.8, 0.1])


def test_no_cross_tenant_score_leakage(days):
    rows, m0, cuts = days["t0"][0]
    m1 = _perturbed(m0, seed=11)
    fleet = FleetRegistry()
    for t, m in (("a", m0), ("b", m1)):
        fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
        fleet.publish(t, m, t)
    fz = DnsEventFeaturizer(cuts)
    scorer = FleetScorer(fleet, {"a": fz, "b": fz},
                         ServingConfig(device_score_min=None), device=CPU)
    fa = [scorer.submit("a", r) for r in rows[:32]]
    fb = [scorer.submit("b", r) for r in rows[:32]]
    scorer.flush()
    sa = np.array([f.result(30.0)[0] for f in fa])
    sb = np.array([f.result(30.0)[0] for f in fb])
    scorer.close()
    feats = fz([fz.validate(r) for r in rows[:32]])
    np.testing.assert_array_equal(sa, score_features(m0, feats, "dns"))
    np.testing.assert_array_equal(sb, score_features(m1, feats, "dns"))
    assert not np.array_equal(sa, sb)


def test_a_failing_tenant_fails_only_its_futures(days):
    """A tenant whose featurizer raises fails its own futures, counted
    and emitted as an error record; the other tenant scores (the host
    engine, so every segment goes through the featurizer)."""
    fleet, featurizers, metrics, scorer = _fleet(days,
                                                 featurize_engine="host")

    class Broken(DnsEventFeaturizer):
        def __call__(self, rows):
            raise RuntimeError("featurizer down")

    scorer._lanes["t1"].featurizer = Broken(days["t1"][0][2])
    f0 = [scorer.submit("t0", r) for r in days["t0"][0][0][:8]]
    f1 = [scorer.submit("t1", r) for r in days["t1"][0][0][:8]]
    scorer.flush()
    np.testing.assert_array_equal([f.result(30.0)[0] for f in f0],
                                  _alone(days, "t0", 8))
    with pytest.raises(RuntimeError, match="featurizer down"):
        f1[0].result(30.0)
    scorer.close()
    assert scorer.counts["failures"] == 1
    errs = [r for r in metrics.records if "error" in r]
    assert [r["tenant"] for r in errs] == ["t1"]
    assert metrics.recorder.counters["serve.t1.errors"].value == 1


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_admission_reject_sheds_load(days, tmp_path):
    jpath = str(tmp_path / "admit.jsonl")
    journal = Journal(jpath)
    rows, model, cuts = days["t0"][0]
    fleet = FleetRegistry()
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns", queue_max=4,
                                admission="reject"))
    fleet.publish("t0", model, "day")
    metrics = MetricsEmitter(to_stdout=False)
    scorer = FleetScorer(fleet, {"t0": DnsEventFeaturizer(cuts)},
                         ServingConfig(device_score_min=None,
                                       fleet_max_batch=1 << 14,
                                       fleet_max_wait_ms=60_000.0),
                         metrics=metrics, journal=journal, device=CPU)
    futs = [scorer.submit("t0", r) for r in rows[:4]]
    with pytest.raises(AdmissionRejected) as ei:
        scorer.submit("t0", rows[4])
    assert (ei.value.tenant, ei.value.depth, ei.value.capacity) == \
        ("t0", 4, 4)
    scorer.flush()
    [f.result(30.0) for f in futs]
    stats = {s["tenant"]: s for s in scorer.tenant_stats()}
    assert (stats["t0"]["rejected"], stats["t0"]["scored"]) == (1, 4)
    assert metrics.recorder.counters["serve.t0.admission_rejects"].value == 1
    scorer.close()
    journal.close()
    recs = [r for r in Journal.replay(jpath)
            if r["kind"] == "admission_reject"]
    assert recs and (recs[0]["tenant"], recs[0]["capacity"]) == ("t0", 4)


def test_admission_block_backpressures(days):
    rows, model, cuts = days["t0"][0]
    fleet = FleetRegistry()
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns", queue_max=4))
    fleet.publish("t0", model, "day")
    scorer = FleetScorer(fleet, {"t0": DnsEventFeaturizer(cuts)},
                         ServingConfig(device_score_min=None,
                                       fleet_max_batch=2,
                                       fleet_max_wait_ms=5.0), device=CPU)
    futs = [scorer.submit("t0", r) for r in rows[:24]]
    assert len([f.result(60.0) for f in futs]) == 24
    scorer.close()
    assert scorer.events_scored == 24


def test_unknown_tenant_and_malformed_event(days):
    _, _, _, scorer = _fleet(days)
    with pytest.raises(KeyError, match="unknown tenant"):
        scorer.submit("ghost", days["t0"][0][0][0])
    with pytest.raises(ValueError):
        scorer.submit("t0", "not,enough,columns")
    scorer.close()


def test_hot_swap_isolation_under_sustained_load(days):
    """Tenant A republishes repeatedly while tenant B streams: B sees no
    failed future, keeps version 1 and its own model's scores bit for
    bit; A's versions stay monotonic."""
    fleet, featurizers, metrics, scorer = _fleet(
        days, fleet_max_batch=32, fleet_max_wait_ms=5.0)
    n_pub = 12
    stop = threading.Event()
    published = []

    def publisher():
        for i in range(n_pub):
            snap = fleet.publish("t0", _perturbed(days["t0"][0][1],
                                                  seed=100 + i),
                                 source=f"swap-{i}")
            published.append(snap.version)
            time.sleep(0.002)
        stop.set()

    pub = threading.Thread(target=publisher, daemon=True)
    futs_a, futs_b = [], []
    rows0, rows1 = days["t0"][0][0], days["t1"][0][0]
    pub.start()
    i = 0
    while not stop.is_set() or i < 64:
        futs_a.append(scorer.submit("t0", rows0[i % len(rows0)]))
        futs_b.append(scorer.submit("t1", rows1[i % len(rows1)]))
        i += 1
        time.sleep(0.0005)
    scorer.flush()
    pub.join(timeout=30.0)
    res_a = [f.result(30.0) for f in futs_a]
    res_b = [f.result(30.0) for f in futs_b]
    scorer.close()
    assert published == list(range(2, n_pub + 2))
    versions_a = [v for _, v in res_a]
    assert all(b >= a for a, b in zip(versions_a, versions_a[1:]))
    assert {v for _, v in res_b} == {1}
    fz = featurizers["t1"]
    feats = fz([fz.validate(rows1[j % len(rows1)])
                for j in range(len(res_b))])
    np.testing.assert_array_equal(
        [s for s, _ in res_b],
        score_features(days["t1"][0][1], feats, "dns"))
    assert not any(r.get("tenant") == "t1" and "error" in r
                   for r in metrics.records)


# ---------------------------------------------------------------------------
# metrics and knobs
# ---------------------------------------------------------------------------


def test_per_tenant_metric_namespaces_and_endpoint(days):
    _, _, metrics, scorer = _fleet(days)
    futs = [scorer.submit(t, days[t][0][0][i])
            for i in range(16) for t in ("t0", "t1")]
    scorer.flush()
    [f.result(30.0) for f in futs]
    scorer.close()
    rec = metrics.recorder
    for t in ("t0", "t1"):
        assert rec.counters[f"serve.{t}.events"].value == 16
        assert rec.histograms[f"serve.{t}.latency_ms"].count >= 1
    assert rec.counters["serve.events"].value == 32
    server = MetricsServer(rec, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            text = r.read().decode()
    finally:
        server.close()
    for series in ("serve_t0_latency_ms", "serve_t1_latency_ms",
                   "serve_t0_events_total", "serve_latency_ms"):
        assert series in text


@pytest.mark.parametrize("cfg,want", [
    ({}, {"max_batch": (4096, "default"), "max_wait_ms": (50.0, "default"),
          "featurize_engine": ("device", "default"),
          "featurize_block": (2048, "default"),
          "featurize_break_even": (1, "default")}),
    ({"fleet_max_batch": 64, "fleet_max_wait_ms": 5.0,
      "featurize_engine": "fused", "featurize_block": 512,
      "featurize_break_even": 32},
     {"max_batch": (64, "config"), "max_wait_ms": (5.0, "config"),
      "featurize_engine": ("fused", "config"),
      "featurize_block": (512, "config"),
      "featurize_break_even": (32, "config")}),
    ({"featurize_engine": "host"},
     {"featurize_engine": ("host", "config"),
      "featurize_break_even": (1, "engine")}),
])
def test_fleet_knob_sources(days, tmp_path, monkeypatch, cfg, want):
    """Each knob's value and source: config where it differs from the
    default, else the default (this test's plan store is empty; the
    plan-sourced values are tests/test_torch_plans.py's)."""
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "p.jsonl"))
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE_BREAK_EVEN", raising=False)
    _, _, _, scorer = _fleet(days, tenants=("t0",), **cfg)
    scorer.close()
    for knob, (value, source) in want.items():
        assert scorer.plan[knob] == {"value": value, "source": source}


# ---------------------------------------------------------------------------
# CLI: the fleet dry run and a live manifest stream
# ---------------------------------------------------------------------------


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("fleet_arg", ["synthetic", "synthetic:3"])
def test_fleet_dry_run_cli_matches_jax(capsys, fleet_arg):
    assert ml_ops.main(["serve", "--dry-run", "--fleet", fleet_arg,
                        "--device", "cpu"]) == 0
    port = _last_json(capsys.readouterr().out)
    assert jml_ops.main(["serve", "--dry-run", "--fleet", fleet_arg]) == 0
    ref = _last_json(capsys.readouterr().out)
    assert port["serve_fleet_dry_run"] == ref["serve_fleet_dry_run"] == "ok"
    assert set(port) - {"device"} == set(ref)
    assert port["device"] == "cpu"
    for key in ("tenants", "events", "events_scored", "versions_served",
                "first_flush_events"):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("argv,match", [
    (["--dry-run", "--fleet", "synthetic:1"], "N >= 2"),
    (["--dry-run", "--fleet", "synthetic:four"], "integer"),
    (["--dry-run", "--fleet", "/tmp/m.json"], "synthetic"),
    (["--fleet", "synthetic"], "dry-run"),
])
def test_fleet_cli_refusals_match_jax(argv, match):
    with pytest.raises(SystemExit, match=match) as port:
        ml_ops.main(["serve", *argv, "--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        jml_ops.main(["serve", *argv])
    assert str(port.value) == str(ref.value)


def _write_day_dir(path, rows, model):
    """A completed DNS day directory as the port writes one: the
    results CSVs and the port's features.pkl."""
    from oni_ml_tpu_torch.features.dns import featurize_dns
    from oni_ml_tpu_torch.io import formats

    os.makedirs(path, exist_ok=True)
    ips = sorted(model.ip_index, key=model.ip_index.get)
    vocab = sorted(model.word_index, key=model.word_index.get)
    formats.write_doc_results(os.path.join(path, "doc_results.csv"), ips,
                              model.theta[:-1])
    formats.write_word_results(os.path.join(path, "word_results.csv"), vocab,
                               np.log(np.asarray(model.p[:-1], np.float64)).T)
    with open(os.path.join(path, "features.pkl"), "wb") as f:
        pickle.dump(featurize_dns(rows), f)


@pytest.fixture()
def manifest(tmp_path):
    manifest = {"tenants": []}
    lines = []
    for i, t in enumerate(("alpha", "beta")):
        rows, model, _ = serve._synthetic_day(seed=60 + i)
        day = str(tmp_path / t)
        _write_day_dir(day, rows, model)
        manifest["tenants"].append({"tenant": t, "day_dir": day,
                                    "dsource": "dns"})
        lines += [f"{t}\t" + ",".join(r) for r in rows[:24]]
    mpath = str(tmp_path / "fleet.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    ipath = str(tmp_path / "events.csv")
    with open(ipath, "w") as f:
        f.write("\n".join(lines) + "\n")
    return mpath, ipath, lines


def test_fleet_live_stream_from_manifest(manifest, tmp_path, capsys):
    mpath, ipath, lines = manifest
    rc = ml_ops.main(["serve", "--fleet", mpath, "--input", ipath,
                      "--no-plans", "--device", "cpu", "--max-batch", "12",
                      "--refresh-every", "2",
                      "--openmetrics", str(tmp_path / "om.txt")])
    out = capsys.readouterr().out
    assert rc == 0
    recs = [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")]
    end = next(r for r in recs if r.get("event") == "stream_end")
    assert end["submitted"] == end["events_scored"] == 48
    assert end["batches"] >= 4          # --max-batch sets the fleet's
    assert end["fleet_counts"]["failures"] == 0
    plans_rec = next(r for r in recs if r.get("event") == "plans")
    assert plans_rec["knobs"]["max_batch"] == {"value": 12,
                                               "source": "config"}
    assert {s["tenant"]: s["scored"] for s in end["tenant_stats"]} == \
        {"alpha": 24, "beta": 24}
    refreshes = [r for r in recs if r.get("event") == "model_refresh"]
    assert {r["tenant"] for r in refreshes} == {"alpha", "beta"}
    assert end["final_versions"] == {
        t: 1 + sum(r["tenant"] == t for r in refreshes)
        for t in ("alpha", "beta")}
    assert not any("error" in r or "on_batch_error" in r for r in recs)
    assert (tmp_path / "om.txt").read_text().endswith("# EOF\n")
    # A stream whose every line is rejected (untagged lines into a
    # two-tenant fleet) exits 1.
    bad = str(tmp_path / "untagged.csv")
    with open(bad, "w") as f:
        f.write("\n".join(ln.split("\t", 1)[1] for ln in lines[:8]) + "\n")
    assert ml_ops.main(["serve", "--fleet", mpath, "--input", bad,
                        "--no-plans", "--device", "cpu"]) == 1
    capsys.readouterr()


def test_fleet_live_stream_with_residency(manifest, tmp_path, capsys,
                                          monkeypatch):
    """--hot-tenants 1 over two tenants: both page through the one hot
    slot, every event scored once.

    The pager promotes off the scoring worker, and close() drains a lane
    that is not hot yet through the solo fallback.  So a stream that
    ends before the second tenant's queued promotion lands would score
    that tenant without paging it in, and the promotion count would
    depend on the pager's timing.  close() is held here until the worker
    has taken every queued event, which it does only from hot lanes."""
    orig_close = FleetScorer.close

    def close_after_paging(self, timeout=None):
        deadline = time.monotonic() + 60.0
        while (any(self.pending(t) for t in list(self._lanes))
               and time.monotonic() < deadline):
            time.sleep(0.005)
        return orig_close(self, timeout)

    monkeypatch.setattr(FleetScorer, "close", close_after_paging)
    mpath, ipath, _ = manifest
    rc = ml_ops.main(["serve", "--fleet", mpath, "--input", ipath,
                      "--no-plans", "--device", "cpu", "--max-batch", "8",
                      "--hot-tenants", "1", "--warm-tenants", "1",
                      "--residency-policy", "lfu", "--residency-spill",
                      str(tmp_path / "spill"), "--stack-precision", "bf16"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert rc == 0
    end = next(r for r in recs if r.get("event") == "stream_end")
    assert end["submitted"] == end["events_scored"] == 48
    res = end["residency"]
    assert res["policy"] == "lfu" and res["hot_capacity"] == 1
    assert res["promotions"] >= 2 and res["evictions"] >= 1
    knobs = next(r for r in recs if r.get("event") == "plans")["knobs"]
    assert knobs["hot_tenants"] == {"value": 1, "source": "config"}
