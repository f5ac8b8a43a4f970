"""The port's tiered residency (oni_ml_tpu_torch/serving/residency.py,
the capacity-tiered and bf16 stacks of serving/fleet.py and the
registry's unload/restore) against the JAX package's, on the CPU: the
same seeded tenants and the same admissions through both.

Tolerances: paging moves a model, never its arithmetic, so host-path
scores before and after a promotion (and after a cold reload) are
bit-equal to the tenant's own model; the spill round trip is bit-exact;
the victim sequence under LRU and LFU equals the JAX manager's; a bf16
stack's device scores are within 2^-7 relative of the f32 stack's
(bfloat16's 8 significand bits through a K-term float32 dot)."""

import os
import time

import numpy as np
import pytest
import torch

from oni_ml_tpu.config import ServingConfig as JServingConfig
from oni_ml_tpu.runner.serve import _synthetic_day as jsynthetic_day
from oni_ml_tpu.serving import DnsEventFeaturizer as JDnsEventFeaturizer
from oni_ml_tpu.serving import FleetRegistry as JFleetRegistry
from oni_ml_tpu.serving import FleetScorer as JFleetScorer
from oni_ml_tpu.serving import ResidencyManager as JResidencyManager
from oni_ml_tpu.serving import TenantSpec as JTenantSpec
from oni_ml_tpu.serving import load_spill as jload_spill
from oni_ml_tpu.serving import spill_model as jspill_model
from oni_ml_tpu_torch.config import ServingConfig
from oni_ml_tpu_torch.runner.serve import _synthetic_day
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.scoring.score import _device_model
from oni_ml_tpu_torch.serving import (TIER_COLD, TIER_HOT, TIER_WARM,
                                      DnsEventFeaturizer, FleetRegistry,
                                      FleetScorer, MetricsEmitter,
                                      ModelRegistry, ResidencyManager,
                                      TenantSpec, load_spill,
                                      resolve_hot_capacity, score_features,
                                      spill_model)
from oni_ml_tpu_torch.telemetry import Journal
from oni_ml_tpu_torch.telemetry.spans import Recorder

CPU = "cpu"
RTOL_BF16 = 2 ** -7


@pytest.fixture(scope="module")
def days():
    """Six synthetic DNS days (distinct seeds, one K): the port's draws
    (equal to the JAX package's, tests/test_torch_serving.py)."""
    return {f"t{i}": _synthetic_day(seed=42 + i) for i in range(6)}


def _tiered_fleet(days, tenants, *, hot=2, warm=0, policy="lru",
                  spill_dir="", stack_precision="f32",
                  device_score_min=None, journal=None, fleet_max_batch=64,
                  jax=False):
    """A capacity-tiered fleet with a ResidencyManager and a scorer over
    `tenants`, every tenant starting warm; the JAX package's with
    `jax=True`."""
    rec = Recorder()
    reg_cls, mgr_cls, spec_cls, fz_cls, scorer_cls, cfg_cls = (
        (JFleetRegistry, JResidencyManager, JTenantSpec,
         JDnsEventFeaturizer, JFleetScorer, JServingConfig) if jax else
        (FleetRegistry, ResidencyManager, TenantSpec, DnsEventFeaturizer,
         FleetScorer, ServingConfig))
    fleet = reg_cls(journal=journal, recorder=rec if not jax else None,
                    capacity_tiers=True, stack_precision=stack_precision)
    mgr = mgr_cls(fleet, hot_capacity=hot, warm_capacity=warm,
                  policy=policy, spill_dir=spill_dir, journal=journal,
                  recorder=rec if not jax else None)
    featurizers = {}
    for t in tenants:
        rows, model, cuts = (jsynthetic_day(seed=42 + int(t[1:])) if jax
                             else days[t])
        fleet.add_tenant(spec_cls(tenant=t, dsource="dns"), hot=False)
        fleet.publish(t, model, source=f"day-{t}")
        mgr.register(t)
        featurizers[t] = fz_cls(cuts)
    cfg = cfg_cls(device_score_min=device_score_min,
                  fleet_max_batch=fleet_max_batch)
    metrics = MetricsEmitter(to_stdout=False, recorder=rec)
    if jax:
        scorer = scorer_cls(fleet, featurizers, cfg, residency=mgr)
        mgr.set_pending_probe(lambda t: len(scorer._lanes[t].pending) > 0)
    else:
        scorer = scorer_cls(fleet, featurizers, cfg, metrics=metrics,
                            residency=mgr, device=CPU)
        mgr.set_pending_probe(lambda t: scorer.pending(t) > 0)
    return fleet, mgr, featurizers, metrics, scorer


def _score(scorer, days, tenant, n=8, timeout=30.0):
    futs = [scorer.submit(tenant, r) for r in days[tenant][0][:n]]
    scorer.flush()
    res = [f.result(timeout=timeout) for f in futs]
    return np.array([s for s, _ in res]), sorted({v for _, v in res})


def _expected(days, tenant, n=8, model=None):
    rows, m, cuts = days[tenant]
    fz = DnsEventFeaturizer(cuts)
    return score_features(model or m, fz([fz.validate(r) for r in rows[:n]]),
                          "dns", device_min=None, device=CPU)


def _wait_tier(mgr, tenant, tier, timeout=10.0):
    deadline = time.monotonic() + timeout
    while mgr.tier_of(tenant) != tier and time.monotonic() < deadline:
        time.sleep(0.01)
    return mgr.tier_of(tenant)


# ---------------------------------------------------------------------------
# checkpoints and the registry's unload / restore
# ---------------------------------------------------------------------------


def test_spill_round_trip_bit_exact_and_readable_by_jax(days, tmp_path):
    model = days["t0"][1]
    path = str(tmp_path / "t0.npz")
    assert spill_model(path, model) == os.path.getsize(path) > 0
    assert not os.path.exists(path + ".tmp")
    for back in (load_spill(path), jload_spill(path)):
        assert back.theta.dtype == np.float64
        np.testing.assert_array_equal(back.theta, model.theta)
        np.testing.assert_array_equal(back.p, model.p)
        assert back.ip_index == model.ip_index
        assert back.word_index == model.word_index
    # And a JAX spill loads into the port bit for bit.
    jpath = str(tmp_path / "j.npz")
    jspill_model(jpath, model)
    np.testing.assert_array_equal(load_spill(jpath).p, model.p)


def test_registry_unload_restore_preserves_version(days):
    model = days["t0"][1]
    reg = ModelRegistry()
    reg.publish(model, "day")
    reg.publish(model, "day2")
    snap = reg.unload()
    assert snap.version == 2 and not reg.loaded and reg.previous() is None
    with pytest.raises(RuntimeError, match="no model published"):
        reg.active()
    with pytest.raises(ValueError, match="restore version"):
        reg.restore(model, "ckpt", 1)
    reg.restore(model, "ckpt", 2)
    assert reg.loaded and reg.active().version == 2
    with pytest.raises(RuntimeError, match="unload first"):
        reg.restore(model, "ckpt", 2)
    assert reg.publish(model, "day3").version == 3


def test_unload_requires_eviction_first(days):
    fleet = FleetRegistry(capacity_tiers=True)
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"))
    fleet.publish("t0", days["t0"][1], "day")
    with pytest.raises(RuntimeError, match="stack-resident"):
        fleet.unload_tenant("t0")
    fleet.set_hot("t0", False)
    assert fleet.unload_tenant("t0").version == 1
    assert not fleet.loaded("t0")
    fleet.restore_tenant("t0", days["t0"][1], "ckpt", 1)
    assert fleet.loaded("t0")


# ---------------------------------------------------------------------------
# tier cycles, victims and failures
# ---------------------------------------------------------------------------


def test_full_tier_cycle_scores_bit_identical(days, tmp_path):
    """Scores after warm -> hot and after cold -> warm -> hot equal the
    tenant's own model's, bit for bit, at the same version."""
    tenants = tuple(f"t{i}" for i in range(6))
    fleet, mgr, _, _, scorer = _tiered_fleet(days, tenants, hot=2, warm=2,
                                             spill_dir=str(tmp_path))
    try:
        for _ in range(2):
            for t in tenants:
                got, versions = _score(scorer, days, t)
                np.testing.assert_array_equal(got, _expected(days, t))
                assert versions == [1]
        tiers = mgr.tiers()
        assert tiers[TIER_HOT] == 2 and tiers[TIER_COLD] >= 1
        stats = mgr.stats_snapshot()
        assert stats["promotions"] >= len(tenants)
        assert stats["evictions"] >= 1 and stats["cold_loads"] >= 1
        assert stats["failures"] == 0 and stats["spills"] >= 1
    finally:
        scorer.close()
        mgr.close()


# The admission sequence both managers see: t0 three times, t1, t2 (one
# eviction), t3 (another), t0, t4.
ADMISSIONS = ("t0", "t0", "t0", "t1", "t2", "t3", "t0", "t4")


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_victim_sequence_matches_jax(days, policy, tmp_path):
    """The same admissions through the port's and the JAX package's
    managers evict the same tenants in the same order."""
    seqs = []
    for jax in (False, True):
        journal = Journal(str(tmp_path / f"j{int(jax)}.jsonl"))
        fleet, mgr, _, _, scorer = _tiered_fleet(
            days, ("t0", "t1", "t2", "t3", "t4"), hot=2, policy=policy,
            journal=journal, jax=jax)
        try:
            for t in ADMISSIONS:
                _score(scorer, days, t)
            tiers = {t: mgr.tier_of(t) for t in ("t0", "t1", "t2", "t3",
                                                 "t4")}
        finally:
            scorer.close()
            mgr.close()
            journal.close()
        evicts = [r["tenant"] for r in Journal.replay(journal.path)
                  if r["kind"] == "residency_evict"]
        seqs.append((evicts, tiers))
    assert seqs[0] == seqs[1]
    # LRU evicts the oft-admitted t0 once; LFU keeps it hot throughout.
    assert seqs[0][0] == {"lru": ["t0", "t1", "t2", "t3"],
                          "lfu": ["t1", "t2", "t3"]}[policy]


@pytest.mark.parametrize("policy,victim", [("lru", "t0"), ("lfu", "t1")])
def test_lru_vs_lfu_victim_selection(days, policy, victim):
    fleet, mgr, _, _, scorer = _tiered_fleet(days, ("t0", "t1", "t2"),
                                             hot=2, policy=policy)
    try:
        for t in ("t0", "t0", "t0", "t1", "t2"):
            _score(scorer, days, t)
        assert mgr.tier_of("t2") == TIER_HOT
        assert mgr.tier_of(victim) == TIER_WARM
    finally:
        scorer.close()
        mgr.close()


def test_promotion_failure_is_tenant_scoped(days, tmp_path):
    """A cold tenant whose checkpoint vanished fails its own futures;
    another tenant keeps scoring."""
    fleet, mgr, _, _, scorer = _tiered_fleet(
        days, ("t0", "t1", "t2"), hot=1, warm=1, spill_dir=str(tmp_path))
    try:
        for t in ("t0", "t1", "t2"):
            _score(scorer, days, t)
        assert _wait_tier(mgr, "t0", TIER_COLD) == TIER_COLD
        for f in os.listdir(str(tmp_path)):
            os.remove(os.path.join(str(tmp_path), f))
        futs = [scorer.submit("t0", r) for r in days["t0"][0][:4]]
        scorer.flush()
        for f in futs:
            with pytest.raises(Exception):
                f.result(timeout=30.0)
        got, _ = _score(scorer, days, "t2")
        np.testing.assert_array_equal(got, _expected(days, "t2"))
        assert mgr.stats_snapshot()["failures"] >= 1
    finally:
        scorer.close()
        mgr.close()


def test_eviction_storm_isolation(days, tmp_path, monkeypatch):
    """A resident tenant's futures never fail and keep their scores while
    another tenant pages through a slow cold load."""
    from oni_ml_tpu_torch.serving import residency as residency_mod

    real_load = residency_mod.load_spill

    def slow_load(path):
        time.sleep(0.05)
        return real_load(path)

    monkeypatch.setattr(residency_mod, "load_spill", slow_load)
    fleet, mgr, _, metrics, scorer = _tiered_fleet(
        days, ("t0", "t1", "t2"), hot=2, warm=1, spill_dir=str(tmp_path),
        fleet_max_batch=8)
    try:
        want = _expected(days, "t0")
        for i in range(6):
            got, versions = _score(scorer, days, "t0")
            np.testing.assert_array_equal(got, want)
            _score(scorer, days, ("t1", "t2")[i % 2])
        assert not any(r.get("tenant") == "t0" and "error" in r
                       for r in metrics.records)
        assert mgr.stats_snapshot()["failures"] == 0
    finally:
        scorer.close()
        mgr.close()


def test_refreshed_model_survives_cold_demotion(days, tmp_path):
    """A day-dir tenant republished and then paged cold comes back as
    the refreshed model at the refreshed version (its live model is
    spilled, the stale day dir is not read)."""
    fleet, mgr, _, _, scorer = _tiered_fleet(days, ("t0", "t1"), hot=1,
                                             warm=4, spill_dir=str(tmp_path))
    try:
        with mgr._lock:
            st = mgr._state["t0"]
            st.day_source = (str(tmp_path / "no_such_day"), 0.1)
            st.day_version = fleet.version("t0")
        _score(scorer, days, "t0")
        m = days["t0"][1]
        rng = np.random.default_rng(9)
        theta = m.theta * rng.uniform(0.5, 1.5, m.theta.shape)
        theta[:-1] /= theta[:-1].sum(1, keepdims=True)
        refreshed = ScoringModel(ip_index=m.ip_index, theta=theta,
                                 word_index=m.word_index, p=m.p.copy())
        fleet.publish("t0", refreshed, "refresh")
        _score(scorer, days, "t1")
        assert mgr.tier_of("t0") == TIER_WARM
        mgr._demote_cold("t0")
        assert mgr.tier_of("t0") == TIER_COLD
        got, versions = _score(scorer, days, "t0")
        np.testing.assert_array_equal(got,
                                      _expected(days, "t0", model=refreshed))
        assert versions == [2]
    finally:
        scorer.close()
        mgr.close()


def test_publish_while_cold_is_adopted(days, tmp_path):
    fleet, mgr, _, _, scorer = _tiered_fleet(days, ("t0", "t1"), hot=1,
                                             warm=4, spill_dir=str(tmp_path))
    try:
        _score(scorer, days, "t0")
        _score(scorer, days, "t1")
        mgr._demote_cold("t0")
        fleet.publish("t0", days["t0"][1], "refresh-while-cold")
        got, versions = _score(scorer, days, "t0")
        np.testing.assert_array_equal(got, _expected(days, "t0"))
        assert versions == [2] and mgr.tier_of("t0") == TIER_HOT
        assert mgr.stats_snapshot()["failures"] == 0
    finally:
        scorer.close()
        mgr.close()


def test_never_published_warm_tenant_does_not_wedge_pager(days):
    fleet, mgr, _, _, scorer = _tiered_fleet(days, ("t0", "t1"), hot=1,
                                             warm=1)
    try:
        fleet.add_tenant(TenantSpec(tenant="ghost", dsource="dns"),
                         hot=False)
        mgr.register("ghost")
        mgr._post_enforce()
        time.sleep(0.1)
        got, _ = _score(scorer, days, "t0")
        np.testing.assert_array_equal(got, _expected(days, "t0"))
        assert mgr.tier_of("ghost") == TIER_WARM and mgr._pager.is_alive()
    finally:
        scorer.close()
        mgr.close()


def test_unmanaged_tenant_drains_promptly_with_residency(days):
    rec = Recorder()
    fleet = FleetRegistry(recorder=rec, capacity_tiers=True)
    mgr = ResidencyManager(fleet, hot_capacity=1, recorder=rec)
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"), hot=False)
    fleet.publish("t0", days["t0"][1], "t0")
    mgr.register("t0")
    fleet.add_tenant(TenantSpec(tenant="t1", dsource="dns"))
    fleet.publish("t1", days["t1"][1], "t1")
    fzs = {t: DnsEventFeaturizer(days[t][2]) for t in ("t0", "t1")}
    scorer = FleetScorer(fleet, fzs, ServingConfig(device_score_min=None),
                         metrics=MetricsEmitter(to_stdout=False,
                                                recorder=rec),
                         residency=mgr, device=CPU)
    try:
        futs = [scorer.submit("t1", r) for r in days["t1"][0][:8]]
        scorer.flush()
        np.testing.assert_array_equal(
            [f.result(timeout=5.0)[0] for f in futs], _expected(days, "t1"))
    finally:
        scorer.close()
        mgr.close()


def test_residency_miss_scores_solo_and_is_counted(days, monkeypatch):
    """A tenant evicted between the take and the score (here: its stack
    membership dropped under the scorer) scores alone on its own model,
    bit-equal to the packed scores, labelled with no stack version."""
    fleet = FleetRegistry()
    for t in ("t0", "t1"):
        fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
        fleet.publish(t, days[t][1], t)
    fleet.set_hot("t1", False)
    metrics = MetricsEmitter(to_stdout=False)
    scorer = FleetScorer(fleet, {t: DnsEventFeaturizer(days[t][2])
                                 for t in ("t0", "t1")},
                         ServingConfig(device_score_min=None),
                         metrics=metrics, device=CPU)
    got, _ = _score(scorer, days, "t1")
    scorer.close()
    np.testing.assert_array_equal(got, _expected(days, "t1"))
    assert scorer.counts["residency_misses"] >= 1
    recs = [r for r in metrics.records if r.get("tenant") == "t1"]
    assert recs and all(r["stack_version"] is None for r in recs)


# ---------------------------------------------------------------------------
# capacity tiers and bf16 stacks
# ---------------------------------------------------------------------------


def test_capacity_padding_matches_jax_and_never_changes_scores(days):
    plain, tiered = FleetRegistry(), FleetRegistry(capacity_tiers=True)
    jtiered = JFleetRegistry(capacity_tiers=True)
    for t in ("t0", "t1", "t2"):
        for reg, spec in ((plain, TenantSpec), (tiered, TenantSpec),
                          (jtiered, JTenantSpec)):
            reg.add_tenant(spec(tenant=t, dsource="dns"))
            reg.publish(t, days[t][1], t)
    s_plain, s_tiered = plain.stack_for("t0"), tiered.stack_for("t0")
    js = jtiered.stack_for("t0")
    assert s_tiered.capacity == js.capacity == 4
    assert tiered.tier(s_tiered.k) == jtiered.tier(js.k)
    assert s_tiered.model.theta.shape == js.model.theta.shape
    np.testing.assert_array_equal(s_tiered.model.theta, js.model.theta)
    np.testing.assert_array_equal(s_tiered.model.p, js.model.p)
    assert s_tiered.model.theta.shape[0] > s_plain.model.theta.shape[0]
    for t in ("t0", "t1", "t2"):
        m = days[t][1]
        i0, w0 = s_tiered.ip_base[t], s_tiered.word_base[t]
        np.testing.assert_array_equal(
            s_tiered.model.theta[i0:i0 + m.theta.shape[0]], m.theta)
        np.testing.assert_array_equal(s_tiered.model.p[w0:w0 + m.p.shape[0]],
                                      m.p)


def test_capacity_tier_shape_stable_across_churn(days):
    """Paging within a tier keeps the stacked shape; the tier only grows
    when the hot census first crosses a power of two."""
    fleet, mgr, _, _, scorer = _tiered_fleet(
        days, tuple(f"t{i}" for i in range(5)), hot=2)
    try:
        _score(scorer, days, "t0")
        one = fleet.stack_for("t0").model.theta.shape
        _score(scorer, days, "t1")          # census 2: the tier doubles
        shape = fleet.stack_for("t0").model.theta.shape
        assert shape[0] == 2 * one[0]
        for t in ("t2", "t3", "t4", "t0"):
            _score(scorer, days, t)
            assert fleet.stack_for(t).model.theta.shape == shape
        assert fleet.tier(fleet.tenant_k("t0"))["capacity"] == 2
    finally:
        scorer.close()
        mgr.close()


def test_bf16_stack_halves_device_bytes_and_meets_tolerance(days):
    """stack_precision "bf16": the stack's device copies are bfloat16
    (half the f32 stack's bytes), accumulation stays float32, and the
    device-path scores are within 2^-7 of the f32 stack's; the host path
    ignores the marker."""
    got, nbytes = {}, {}
    for precision in ("f32", "bf16"):
        fleet, mgr, _, _, scorer = _tiered_fleet(
            days, ("t0", "t1"), hot=2, stack_precision=precision,
            device_score_min=1)
        try:
            got[precision], _ = _score(scorer, days, "t0", n=16)
            theta, p = _device_model(fleet.stack_for("t0").model, CPU)
            want = torch.bfloat16 if precision == "bf16" else torch.float32
            assert theta.dtype == p.dtype == want
            nbytes[precision] = (theta.element_size() * theta.nelement()
                                 + p.element_size() * p.nelement())
        finally:
            scorer.close()
            mgr.close()
    assert nbytes["bf16"] * 2 == nbytes["f32"]
    f32, bf16 = got["f32"], got["bf16"]
    assert np.all(np.isfinite(bf16))
    assert not np.array_equal(f32, bf16)
    rel = np.abs(bf16 - f32) / np.maximum(np.abs(f32), 1e-300)
    assert rel.max() <= RTOL_BF16, rel.max()
    fleet, mgr, _, _, scorer = _tiered_fleet(days, ("t0",), hot=1,
                                             stack_precision="bf16")
    try:
        host, _ = _score(scorer, days, "t0", n=16)
        np.testing.assert_array_equal(host, _expected(days, "t0", n=16))
    finally:
        scorer.close()
        mgr.close()


# ---------------------------------------------------------------------------
# knobs, validation and the journal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hot,want", [(0, (0, "default")),
                                      (5, (5, "config"))])
def test_resolve_hot_capacity(hot, want):
    assert resolve_hot_capacity(ServingConfig(fleet_hot_tenants=hot)) == want


@pytest.mark.parametrize("kw,match", [({"policy": "fifo"}, "policy"),
                                      ({"hot_capacity": -1}, "capacities")])
def test_residency_manager_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as port:
        ResidencyManager(FleetRegistry(capacity_tiers=True), **kw)
    with pytest.raises(ValueError) as ref:
        JResidencyManager(JFleetRegistry(capacity_tiers=True), **kw)
    assert str(port.value) == str(ref.value)


def test_register_twice_refused(days):
    fleet = FleetRegistry(capacity_tiers=True)
    mgr = ResidencyManager(fleet, hot_capacity=2)
    try:
        fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"), hot=False)
        fleet.publish("t0", days["t0"][1], "d")
        mgr.register("t0")
        with pytest.raises(ValueError, match="already registered"):
            mgr.register("t0")
    finally:
        mgr.close()


def test_residency_journal_records_and_gauges(days, tmp_path):
    jpath = str(tmp_path / "residency.jsonl")
    journal = Journal(jpath)
    fleet, mgr, _, metrics, scorer = _tiered_fleet(
        days, ("t0", "t1", "t2"), hot=1, warm=1,
        spill_dir=str(tmp_path / "spill"), journal=journal)
    try:
        for t in ("t0", "t1", "t2", "t0"):
            _score(scorer, days, t)
    finally:
        scorer.close()
        mgr.close()
        journal.close()
    records = list(Journal.replay(jpath))
    promotes = [r for r in records
                if r["kind"] == "residency_promote" and r.get("ok")]
    evicts = [r for r in records if r["kind"] == "residency_evict"]
    hot_legs = [r for r in promotes if "stall_s" in r]
    assert hot_legs and evicts
    assert all(r["stall_s"] >= 0 and r["capacity"] >= r["census"]
               for r in hot_legs)
    assert any(r.get("tier_to") == TIER_COLD
               and isinstance(r.get("spill_bytes"), int) for r in evicts)
    rec = metrics.recorder
    assert rec.gauges["residency.hot"] <= 1
    assert rec.counters["residency.promotions"].value >= 4
    assert {"residency.warm", "residency.cold"} <= set(rec.gauges)


def test_pager_runs_under_its_creators_plan_store_and_recorder(days,
                                                               tmp_path):
    """The pager thread gets the plan store and Recorder of the thread
    that built the manager (context variables do not cross a thread
    start)."""
    from oni_ml_tpu_torch.plans import PlanStore, current_store, use_store
    from oni_ml_tpu_torch.telemetry.spans import current_recorder, \
        use_recorder

    seen = {}
    store = PlanStore(str(tmp_path / "plans.jsonl"))
    rec = Recorder()
    fleet = FleetRegistry(capacity_tiers=True)
    with use_store(store), use_recorder(rec):
        mgr = ResidencyManager(fleet, hot_capacity=1, recorder=rec)
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"), hot=False)
    fleet.publish("t0", days["t0"][1], "d")
    real = fleet.set_hot_many

    def spy(changes):
        seen["store"], seen["recorder"] = current_store(), current_recorder()
        real(changes)

    fleet.set_hot_many = spy
    try:
        mgr.register("t0")
        mgr.ensure_hot("t0")
    finally:
        mgr.close()
    assert seen == {"store": store, "recorder": rec}
