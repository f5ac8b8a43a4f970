"""The port's measured plans (oni_ml_tpu_torch/plans, the probes under
oni_ml_tpu_torch/tools) against the JAX package's (oni_ml_tpu/plans,
tools/plan_cache.py) on the CPU: the knob registry, the autotune
harness, the resolution rule, the pre workers, the serving triggers and
their guards, the lda record's plan sources, the three-run day, the
seed layer and the export format.

Every value compared here is an int, a float from a fake clock, a
string or a source name, so every comparison is exact.  The JAX side
runs as tests/test_plans.py runs it (CPU, its own hermetic plan cache
from tests/conftest.py, each test's store in tmp_path)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from oni_ml_tpu import plans as jplans
from oni_ml_tpu_torch import plans
from oni_ml_tpu_torch.ops import _cuda

from test_features import flow_row

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX package's doc-block knobs, which the port leaves out: on the
# card the block is a rule of the kernels' geometry and the stop group.
BLOCK_KNOBS = {"dense_estep_block", "dense_estep_block_w", "sparse_estep_bb"}
PKGS = {"port": plans, "jax": jplans}


def _store(pkg, tmp_path, name="plans.jsonl"):
    return pkg.PlanStore(str(tmp_path / name), seeds=False)


def _fp(pkg, knob):
    return pkg.fingerprint(pkg.KNOBS[knob].scope)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_names_defaults_scopes_and_candidates_match_jax():
    assert set(plans.KNOBS) == set(jplans.KNOBS) - BLOCK_KNOBS
    for name, knob in plans.KNOBS.items():
        ref = jplans.KNOBS[name]
        assert (knob.default, knob.scope, knob.candidates) == \
            (ref.default, ref.scope, ref.candidates), name


VALUES = [0, 1, 2, -1, 8, 4096, 1.5, 10.0, 0.0, True, False, None, "8",
          "auto", [], {}, {"engine": "dense"}, {"engine": "sparse"},
          {"engine": "xla"}, {"engine": "fused"}, {"engine": "host"},
          {"break_even": None}, {"break_even": 12}, {"break_even": 1.5},
          {"break_even": "auto"}, {"break_even": True}]


@pytest.mark.parametrize("name", sorted(set(jplans.KNOBS) - BLOCK_KNOBS))
def test_validator_verdicts_match_jax(name):
    for value in VALUES:
        assert plans.KNOBS[name].valid(value) == \
            jplans.KNOBS[name].valid(value), (name, value)
    # host_sync_every: 0 is not in the plan space.
    assert not plans.KNOBS["host_sync_every"].valid(0)


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------


def _clock(step):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


AUTOTUNE_CASES = {
    "budget_hit": dict(knob="score_device_chunk", step=10.0,
                       kw=dict(budget_s=25.0, mode="max")),
    "budget_zero": dict(knob="score_device_chunk", step=100.0,
                        kw=dict(budget_s=0.0)),
    "unbounded_min": dict(knob="serve_max_batch", step=1.0,
                          kw=dict(mode="min")),
    "unbounded_max": dict(knob="fused_em_chunk", step=1.0,
                          kw=dict(mode="max", shape="k20.v8")),
    "candidates": dict(knob="pre_workers", step=3.0,
                       kw=dict(candidates=(4, 1, 2), budget_s=5.0,
                               unit="events/sec")),
}


def _measure(c):
    # Not monotone: the winner sits inside the space.
    return float((c * 7919) % 1009)


@pytest.mark.parametrize("case", sorted(AUTOTUNE_CASES))
def test_autotune_matches_jax(case, tmp_path):
    spec = AUTOTUNE_CASES[case]
    out = {}
    for name, pkg in PKGS.items():
        st = _store(pkg, tmp_path / name)
        measured = []

        def measure(c):
            measured.append(c)
            return _measure(c)

        with pkg.use_store(st):
            before = pkg.counters["autotune_sweeps"]
            res = pkg.autotune(spec["knob"], measure,
                               clock=_clock(spec["step"]), **spec["kw"])
            assert pkg.counters["autotune_sweeps"] == before + 1
        entry = st.lookup(spec["knob"], _fp(pkg, spec["knob"]),
                          spec["kw"].get("shape", "*"))
        rec = {k: v for k, v in entry.record.items()
               if k not in ("seq", "t", "mono_ns", "backend")}
        out[name] = (res._replace(wall_s=round(res.wall_s, 6)), measured,
                     rec)
    assert out["port"] == out["jax"]
    res = out["port"][0]
    if case == "budget_zero":
        assert len(res.measurements) == 1 and res.truncated
    if case == "budget_hit":
        assert res.truncated and len(res.measurements) == 3


def test_autotune_refuses_what_jax_refuses():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="mode"):
            pkg.autotune("serve_max_batch", float, mode="best",
                         record=False)
        with pytest.raises(ValueError, match="candidate space"):
            pkg.autotune("estep_engine", float, record=False)


# ---------------------------------------------------------------------------
# resolve
# ---------------------------------------------------------------------------

# (knob, a config value that differs from the default, a valid plan
# value, another valid plan value, an invalid plan value)
RESOLVE_KNOBS = [("fused_em_chunk", 32, 64, 256, 0),
                 ("host_sync_every", 8, 32, 8, 0),
                 ("serve_max_wait_ms", 5.0, 25.0, 100.0, -1.0),
                 ("fleet_hot_tenants", 3, 8, 16, "8"),
                 ("pre_workers", 3, 2, 4, 0)]
PLAN_CASES = ["absent", "wildcard", "exact", "both", "invalid_exact",
              "invalid_only"]


def _write_plan(pkg, st, knob, case, good, other, bad):
    fp = _fp(pkg, knob)
    if case in ("wildcard", "both", "invalid_exact"):
        st.record(knob, fp, "*", good)
    if case in ("exact", "both"):
        st.record(knob, fp, "s1", other)
    if case in ("invalid_exact", "invalid_only"):
        st.record(knob, fp, "s1", bad)


@pytest.mark.parametrize("knob,cfg,good,other,bad", RESOLVE_KNOBS)
def test_resolve_matches_jax(knob, cfg, good, other, bad, tmp_path,
                             monkeypatch):
    got = {}
    for name, pkg in PKGS.items():
        rows = []
        default = pkg.KNOBS[knob].default
        for case in PLAN_CASES:
            st = _store(pkg, tmp_path / name / case)
            _write_plan(pkg, st, knob, case, good, other, bad)
            for config in (None, default, cfg):
                for shape in ("*", "s1"):
                    before = pkg.counters_snapshot()
                    with pkg.use_store(st):
                        value = pkg.resolve(knob, config, shape=shape)
                        off = pkg.resolve(knob, config, shape=shape,
                                          store=None)
                    with pkg.use_store(pkg.NullStore()):
                        null = pkg.resolve(knob, config, shape=shape)
                    monkeypatch.setenv("ONI_ML_TPU_PLANS", "0")
                    with pkg.use_store(st):
                        disabled = pkg.resolve(knob, config, shape=shape)
                    monkeypatch.delenv("ONI_ML_TPU_PLANS")
                    after = pkg.counters_snapshot()
                    deltas = {k: after[k] - before[k]
                              for k in ("plan_hits", "defaults", "config")}
                    rows.append((case, config, shape, value, off, null,
                                 disabled, deltas))
        got[name] = rows
    assert got["port"] == got["jax"]
    # Spot the rule itself on the port's rows.
    rows = {(r[0], r[1], r[2]): r[3] for r in got["port"]}
    assert rows[("both", cfg, "s1")] == (cfg, "config")
    assert rows[("both", None, "s1")] == (other, "plan")
    assert rows[("both", None, "*")] == (good, "plan")
    assert rows[("invalid_only", None, "s1")][1] == "default"


def test_host_knobs_never_ask_for_the_device(tmp_path, monkeypatch):
    """Host-scoped knobs (pre_workers, the serving triggers) key by the
    host: resolving them must not reach the device fingerprint (which
    may start CUDA)."""
    def boom(*a, **kw):
        raise AssertionError("a host knob asked for the device")

    monkeypatch.setattr(plans, "device_fingerprint", boom)
    st = _store(plans, tmp_path)
    with plans.use_store(st):
        for knob in ("pre_workers", "serve_max_batch", "serve_max_wait_ms",
                     "fleet_max_batch", "fleet_max_wait_ms"):
            assert plans.KNOBS[knob].scope == "host"
            plans.resolve(knob, None)
            plans.record_value(knob, 2)
            assert plans.lookup_value(knob) == 2


# ---------------------------------------------------------------------------
# pre workers
# ---------------------------------------------------------------------------


def test_pre_workers_resolution_matches_jax(tmp_path):
    from oni_ml_tpu.features.shards import resolve_pre_workers as jresolve
    from oni_ml_tpu_torch.features.shards import resolve_pre_workers

    got = {}
    for name, pkg, fn in (("port", plans, resolve_pre_workers),
                          ("jax", jplans, jresolve)):
        st = _store(pkg, tmp_path / name)
        rows = []
        with pkg.use_store(st):
            rows += [fn(3, with_source=True), fn(0, with_source=True)]
            st.record("pre_workers", pkg.host_fingerprint(), "*", 2,
                      source="probe")
            rows += [fn(0, with_source=True), fn(0)]
            # An absurd operator-edited entry degrades to untuned.
            st.record("pre_workers", pkg.host_fingerprint(), "*",
                      1_000_000, source="probe")
            rows.append(fn(0, with_source=True))
            auto = max(1, os.cpu_count() or 1)
            st.record("pre_workers", pkg.host_fingerprint(), "*",
                      4 * auto, source="probe")
            rows.append(fn(0, with_source=True))
        with pytest.raises(ValueError):
            fn(-1)
        got[name] = rows
    assert got["port"] == got["jax"]
    assert got["port"][2] == (2, "plan")
    assert got["port"][4][1] == "default"


# ---------------------------------------------------------------------------
# serving triggers
# ---------------------------------------------------------------------------


def _batchers(pkg_name, store_path, **cfg_kw):
    """(max_batch, plan) of a host-pinned BatchScorer of one package."""
    if pkg_name == "port":
        from oni_ml_tpu_torch.config import ServingConfig
        from oni_ml_tpu_torch.runner.serve import _synthetic_day
        from oni_ml_tpu_torch.serving import BatchScorer, ModelRegistry
        from oni_ml_tpu_torch.serving.events import DnsEventFeaturizer
        kw = {"device": "cpu"}
    else:
        from oni_ml_tpu.config import ServingConfig
        from oni_ml_tpu.runner.serve import _synthetic_day
        from oni_ml_tpu.serving import BatchScorer, ModelRegistry
        from oni_ml_tpu.serving.events import DnsEventFeaturizer
        kw = {}
    _rows, model, cuts = _synthetic_day(n_events=8)
    registry = ModelRegistry()
    registry.publish(model, source="test")
    scorer = BatchScorer(registry, DnsEventFeaturizer(cuts),
                         ServingConfig(device_score_min=None, **cfg_kw),
                         **kw)
    try:
        return scorer.max_batch, scorer.max_wait_ms, scorer.plan
    finally:
        scorer.close()


def test_batcher_triggers_and_guard_match_jax(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        st = _store(pkg, tmp_path / name)
        fp = pkg.host_fingerprint()
        rows = []
        with pkg.use_store(st):
            rows.append(_batchers(name, st.path))
            st.record("serve_max_batch", fp, "*", 16, source="probe")
            st.record("serve_max_wait_ms", fp, "*", 25.0, source="probe")
            rows.append(_batchers(name, st.path))
            rows.append(_batchers(name, st.path, max_batch=4))
            # Above queue_max: unreachable, so the default.
            st.record("serve_max_batch", fp, "*", 1 << 20, source="probe")
            rows.append(_batchers(name, st.path))
        got[name] = rows
    assert got["port"] == got["jax"]
    assert got["port"][1][2]["max_batch"] == {"value": 16, "source": "plan"}
    assert got["port"][2][2]["max_batch"]["source"] == "config"
    assert got["port"][3][2]["max_batch"]["source"] == "default"


def _fleet_sequence(pkg_name, plan_batch, tmp_path):
    """A dynamic fleet of one tenant (queue 8) that grows a second
    (queue 8) and a third (queue 8): max_batch and its source after
    each, with a plan fleet_max_batch of `plan_batch`; then a static
    fleet of two such tenants."""
    if pkg_name == "port":
        from oni_ml_tpu_torch.config import ServingConfig
        from oni_ml_tpu_torch.runner.serve import _synthetic_day
        from oni_ml_tpu_torch.serving import (DnsEventFeaturizer,
                                              FleetRegistry, FleetScorer,
                                              TenantSpec)
        pkg, kw = plans, {"device": "cpu"}
    else:
        from oni_ml_tpu.config import ServingConfig
        from oni_ml_tpu.runner.serve import _synthetic_day
        from oni_ml_tpu.serving import (DnsEventFeaturizer, FleetRegistry,
                                        FleetScorer, TenantSpec)
        pkg, kw = jplans, {}
    st = _store(pkg, tmp_path / pkg_name)
    st.record("fleet_max_batch", pkg.host_fingerprint(), "*", plan_batch,
              source="probe")
    cfg = ServingConfig(device_score_min=None, featurize_engine="host")
    days = {t: _synthetic_day(seed=40 + i)
            for i, t in enumerate(("t0", "t1", "t2"))}

    def spec(t):
        return TenantSpec(tenant=t, dsource="dns", queue_max=8)

    out = []
    with pkg.use_store(st):
        fleet = FleetRegistry()
        fleet.add_tenant(spec("t0"))
        fleet.publish("t0", days["t0"][1], source="day")
        scorer = FleetScorer(fleet, {"t0": DnsEventFeaturizer(days["t0"][2])},
                             cfg, dynamic=True, **kw)
        out.append((scorer.max_batch, scorer.plan["max_batch"]))
        for t in ("t1", "t2"):
            fleet.add_tenant(spec(t))
            fleet.publish(t, days[t][1], source="day")
            scorer.add_tenant(spec(t), DnsEventFeaturizer(days[t][2]))
            out.append((scorer.max_batch, scorer.plan["max_batch"]))
        scorer.close()
        static = FleetRegistry()
        for t in ("t0", "t1"):
            static.add_tenant(spec(t))
            static.publish(t, days[t][1], source="day")
        scorer = FleetScorer(static, {t: DnsEventFeaturizer(days[t][2])
                                      for t in ("t0", "t1")}, cfg, **kw)
        out.append((scorer.max_batch, scorer.plan["max_batch"],
                    scorer.max_wait_ms, scorer.plan["max_wait_ms"]))
        scorer.close()
    return out


@pytest.mark.parametrize("plan_batch", [12, 16, 24, 64])
def test_fleet_guard_and_its_reapplication_match_jax(plan_batch, tmp_path):
    port = _fleet_sequence("port", plan_batch, tmp_path)
    assert port == _fleet_sequence("jax", plan_batch, tmp_path)
    if plan_batch == 16:
        # 8 < 16: the default; 16 covers it: the plan; 24 still does.
        assert [s for _, s in port[:3]] == [
            {"value": 4096, "source": "default"},
            {"value": 16, "source": "plan"},
            {"value": 16, "source": "plan"}]


def test_fleet_featurize_block_and_engine_from_the_plan(tmp_path,
                                                        monkeypatch):
    """The device-scoped fleet knobs: featurize_block and the featurize
    engine resolve from this device's plan where the config leaves them
    at their defaults; fleet_hot_tenants likewise (config 0)."""
    from oni_ml_tpu_torch.config import ServingConfig
    from oni_ml_tpu_torch.serving.residency import resolve_hot_capacity
    from oni_ml_tpu_torch.sources.device import resolve_engine

    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    st = _store(plans, tmp_path)
    with plans.use_store(st):
        assert resolve_engine("auto", device="cpu") == ("device", "default")
        assert resolve_hot_capacity(ServingConfig(), "cpu") == (0, "default")
        fp = plans.device_fingerprint("cpu")
        st.record("featurize_engine", fp, "*", {"engine": "host"})
        st.record("fleet_hot_tenants", fp, "*", 4)
        assert resolve_engine("auto", device="cpu") == ("host", "plan")
        assert resolve_engine("fused", device="cpu") == ("fused", "config")
        assert resolve_hot_capacity(ServingConfig(), "cpu") == (4, "plan")
        assert resolve_hot_capacity(ServingConfig(fleet_hot_tenants=2),
                                    "cpu") == (2, "config")
        assert plans.resolve("featurize_block", 2048, device="cpu") == \
            (2048, "default")
        st.record("featurize_block", fp, "*", 4096)
        assert plans.resolve("featurize_block", 2048, device="cpu") == \
            (4096, "plan")


# ---------------------------------------------------------------------------
# the day: lda record sources, the three runs
# ---------------------------------------------------------------------------


def _flow_day_file(tmp_path) -> str:
    rng = np.random.default_rng(7)
    lines = [flow_row(hour=int(rng.integers(0, 24)),
                      minute=int(rng.integers(0, 60)),
                      second=int(rng.integers(0, 60)),
                      sip=f"10.0.0.{rng.integers(1, 9)}",
                      dip=f"172.16.0.{rng.integers(1, 9)}",
                      col10=str(rng.choice([80, 443, 55000])),
                      col11=str(rng.choice([80, 6000])),
                      ipkt=str(rng.integers(1, 100)),
                      ibyt=str(rng.integers(40, 10000)))
             for _ in range(60)]
    raw = tmp_path / "flow.csv"
    raw.write_text("\n".join(lines) + "\n")
    return str(raw)


def test_lda_record_plan_sources_match_jax(tmp_path):
    """A plan fused_em_chunk of 2 trains the day at 2 (source "plan");
    an explicit chunk of 4 wins over it ("config"); in both packages'
    days."""
    from oni_ml_tpu.config import LDAConfig as JLDAConfig
    from oni_ml_tpu.config import PipelineConfig as JPipelineConfig
    from oni_ml_tpu.config import PlansConfig as JPlansConfig
    from oni_ml_tpu.runner.ml_ops import run_pipeline as jrun_pipeline
    from oni_ml_tpu_torch.config import LDAConfig, PipelineConfig, PlansConfig
    from oni_ml_tpu_torch.runner.ml_ops import run_pipeline

    raw = _flow_day_file(tmp_path)
    port_path, jax_path = (str(tmp_path / f"{n}.jsonl")
                           for n in ("port", "jax"))
    st = plans.PlanStore(port_path, seeds=False)
    st.record("fused_em_chunk",
              plans.plan_backend("cpu", _cuda.estep_kernels()), "*", 2,
              source="probe")
    st.close()
    jst = jplans.PlanStore(jax_path, seeds=False)
    jst.record("fused_em_chunk", _fp(jplans, "fused_em_chunk"), "*", 2,
               source="probe")
    jst.close()

    def run(pkg, name, **lda_kw):
        lda = dict(em_max_iters=2, batch_size=64, **lda_kw)
        if pkg == "port":
            cfg = PipelineConfig(
                data_dir=str(tmp_path / "port" / name), flow_path=raw,
                pre_workers=1, lda=LDAConfig(**lda),
                plans=PlansConfig(cache_path=port_path,
                                  compilation_cache=False))
            recs = run_pipeline(cfg, "20160122", "flow", device="cpu",
                                force=True, emit=lambda *a, **k: None).records
        else:
            cfg = JPipelineConfig(
                data_dir=str(tmp_path / "jax" / name), flow_path=raw,
                pre_workers=1, lda=JLDAConfig(**lda),
                plans=JPlansConfig(cache_path=jax_path,
                                   compilation_cache=False))
            recs = jrun_pipeline(cfg, "20160122", "flow", force=True)
        return next(m for m in recs if m.get("stage") == "lda")["plans"]

    for pkg in ("port", "jax"):
        planned = run(pkg, "plan")
        assert planned["fused_em_chunk"] == {"value": 2, "source": "plan"}
        assert planned["host_sync_every"] == {"value": 16,
                                              "source": "default"}
        override = run(pkg, "config", fused_em_chunk=4)
        assert override["fused_em_chunk"] == {"value": 4, "source": "config"}


def _cli_day(raw, data_dir, plan_cache, *extra):
    env = dict(os.environ)
    env.pop("ONI_ML_TPU_PLAN_CACHE", None)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", "20160122",
         "flow", "1.1", "--flow-path", raw, "--data-dir", str(data_dir),
         "--device", "cpu", "--em-max-iters", "3", "--pre-workers", "1",
         "--plan-cache", plan_cache, *extra],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(data_dir, "20160122", "metrics.json")) as f:
        return {m["stage"]: m for m in json.load(f)}


DAY_FILES = ("word_counts.dat", "flow_results.csv", "doc_results.csv",
             "word_results.csv", "final.beta", "final.gamma", "final.other")


def test_three_run_day_zero_sweeps_and_plans_off_bytes(tmp_path):
    """Run 1 (plans on, a store holding a measured chunk) and run 2 (a
    fresh process on that store) run zero sweeps, the chunk from the
    plan; run 3 (--no-plans --no-compilation-cache, a fresh process)
    resolves from config and default, builds the host libraries it loads
    cold in a run-scoped directory, and writes run 2's bytes.  The pre
    stage's bytes equal the JAX day's on the same input; the model files
    are held to each other within the port (the JAX day's differ by the
    float32-order drift of ROADMAP Queue 3)."""
    from oni_ml_tpu.config import LDAConfig as JLDAConfig
    from oni_ml_tpu.config import PipelineConfig as JPipelineConfig
    from oni_ml_tpu.config import PlansConfig as JPlansConfig
    from oni_ml_tpu.runner.ml_ops import run_pipeline as jrun_pipeline

    raw = _flow_day_file(tmp_path)
    cache = str(tmp_path / "plans.jsonl")
    st = plans.PlanStore(cache, seeds=False)
    st.record("fused_em_chunk",
              plans.plan_backend("cpu", _cuda.estep_kernels()), "*", 32,
              source="probe")
    st.close()
    runs = [_cli_day(raw, tmp_path / "run1", cache),
            _cli_day(raw, tmp_path / "run2", cache),
            _cli_day(raw, tmp_path / "run3", cache, "--no-plans",
                     "--no-compilation-cache")]
    for rec in runs[:2]:
        assert rec["plans"]["enabled"] is True
        assert rec["plans"]["store"] == cache
        assert rec["plans"]["autotune_sweeps"] == 0
        assert rec["plans"]["compilation_cache"]["enabled"] is True
        assert rec["lda"]["plans"]["fused_em_chunk"] == {"value": 32,
                                                         "source": "plan"}
    off = runs[2]
    assert off["plans"]["enabled"] is False
    assert off["plans"]["autotune_sweeps"] == 0
    assert off["plans"]["plan_hits"] == 0
    cc = off["plans"]["compilation_cache"]
    assert cc["enabled"] is False and cc["builds"] >= 1
    assert cc["cache_hits"] == 0
    assert not os.path.exists(cc["dir"])      # removed after the run
    assert off["lda"]["plans"]["fused_em_chunk"] == {"value": 128,
                                                     "source": "default"}
    day2, day3 = (tmp_path / r / "20160122" for r in ("run2", "run3"))
    for name in DAY_FILES:
        assert (day2 / name).read_bytes() == (day3 / name).read_bytes(), name
    cfg = JPipelineConfig(
        data_dir=str(tmp_path / "jax"), flow_path=raw, pre_workers=1,
        lda=JLDAConfig(em_max_iters=3),
        plans=JPlansConfig(enabled=False, compilation_cache=False))
    jrun_pipeline(cfg, "20160122", "flow", force=True)
    assert (day2 / "word_counts.dat").read_bytes() == \
        (tmp_path / "jax" / "20160122" / "word_counts.dat").read_bytes()


# ---------------------------------------------------------------------------
# the seed layer and the export format
# ---------------------------------------------------------------------------

SEED_RECORDS = [
    {"schema": 1, "knob": "fused_em_chunk", "backend": "cpu:x", "shape": "*",
     "value": 64, "measurements": {"16": 1.0, "64": 2.0}},
    {"schema": 1, "knob": "score_device_chunk", "backend": "cpu:x",
     "shape": "*", "value": 8192, "source": "probe"},
    {"schema": 2, "knob": "pre_workers", "backend": "host:x", "shape": "*",
     "value": 2},
]


def test_seed_layer_matches_jax(tmp_path, monkeypatch):
    seed = tmp_path / "seeds" / "card.jsonl"
    seed.parent.mkdir()
    seed.write_text("".join(json.dumps(r) + "\n" for r in SEED_RECORDS))
    from oni_ml_tpu.plans import store as jstore_mod
    from oni_ml_tpu_torch.plans import store as store_mod

    got = {}
    for name, mod in (("port", store_mod), ("jax", jstore_mod)):
        monkeypatch.setattr(mod, "seed_paths", lambda: [str(seed)])
        st = mod.PlanStore(str(tmp_path / f"{name}.jsonl"))
        before = sorted((e.knob, e.shape, e.value, e.source)
                        for e in st.entries())
        dropped = st.dropped_records
        st.record("fused_em_chunk", "cpu:x", "*", 32, source="autotune")
        fresh = mod.PlanStore(str(tmp_path / f"{name}.jsonl"))
        after = fresh.lookup("fused_em_chunk", "cpu:x")
        unseeded = mod.PlanStore(str(tmp_path / f"{name}.jsonl"),
                                 seeds=False)
        got[name] = (before, dropped, (after.value, after.source),
                     unseeded.lookup("score_device_chunk", "cpu:x"))
        st.clear()
        assert os.path.exists(seed)            # seeds are code
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == ("fused_em_chunk", "*", 64, "seed")
    # The port ships no seed file.
    monkeypatch.undo()
    assert plans.seed_paths() == []


def _jax_plan_cache_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_plan_cache_tool", os.path.join(REPO, "tools", "plan_cache.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_format_matches_jax_plan_cache_tool(tmp_path, monkeypatch,
                                                   capsys):
    from oni_ml_tpu.plans import store as jstore_mod
    from oni_ml_tpu_torch.tools import plan_cache

    monkeypatch.setattr(jstore_mod, "seed_paths", lambda: [])
    paths = {n: str(tmp_path / f"{n}.jsonl") for n in ("port", "jax")}
    for name, pkg in PKGS.items():
        st = pkg.PlanStore(paths[name], seeds=False)
        st.record("fused_em_chunk", "cpu:x", "k20.v8", 64, source="probe",
                  measurements={16: 1.5, 64: 3.0}, unit="docs/sec")
        st.record("serve_max_batch", "host:x", "*", 1024, source="autotune",
                  mode="max", truncated=False)
        st.record("fused_em_chunk", "cpu:x", "k20.v8", 128, source="probe")
        st.close()
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", paths["jax"])
    assert _jax_plan_cache_tool().main(
        ["export", str(tmp_path / "jax_seed.jsonl")]) == 0
    assert plan_cache.main(["export", str(tmp_path / "port_seed.jsonl"),
                            "--plan-cache", paths["port"]]) == 0
    capsys.readouterr()
    port_lines = (tmp_path / "port_seed.jsonl").read_text().splitlines()
    jax_lines = (tmp_path / "jax_seed.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in port_lines] == \
        [json.loads(x) for x in jax_lines]
    assert len(port_lines) == 2
    # An exported file loads as a seed layer, entries intact.
    st = plans.PlanStore(str(tmp_path / "empty.jsonl"))
    monkeypatch.setattr("oni_ml_tpu_torch.plans.store.seed_paths",
                        lambda: [str(tmp_path / "port_seed.jsonl")])
    assert st.lookup("fused_em_chunk", "cpu:x", "k20.v8").value == 128


def test_plan_cache_show_and_clear(tmp_path, capsys):
    from oni_ml_tpu_torch.tools import plan_cache

    path = str(tmp_path / "p.jsonl")
    st = plans.PlanStore(path, seeds=False)
    st.record("pre_workers", plans.host_fingerprint(), "*", 2)
    st.record("fused_em_chunk",
              plans.plan_backend("cpu", _cuda.estep_kernels()), "*", 64)
    st.record("fused_em_chunk", "tpu:other:1", "*", 128)
    st.close()
    assert plan_cache.main(["show", "--plan-cache", path,
                            "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["host"] == plans.host_fingerprint()
    assert lines[0]["backend"] == plans.device_fingerprint("cpu")
    assert sorted((x["knob"], x["value"]) for x in lines[1:]) == [
        ("fused_em_chunk", 64), ("pre_workers", 2)]
    plan_cache.main(["show", "--plan-cache", path, "--all-backends",
                     "--no-device", "--knob", "fused_em_chunk"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert "backend" not in lines[0] and len(lines) == 3
    assert plan_cache.main(["clear", "--plan-cache", path]) == 0
    assert json.loads(capsys.readouterr().out)["existed"] is True
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# the probes, tiny, on the CPU
# ---------------------------------------------------------------------------

PROBES = {
    "em_chunk_probe": (["--k", "4", "--v", "64", "--b", "16", "--l", "8",
                        "--chunks", "2,4", "--rounds", "1"],
                       ["fused_em_chunk"]),
    "estep_probe": (["--k", "4", "--v", "256", "--b", "16",
                     "--densities", "5,60"], ["estep_engine"]),
    "score_probe": (["--events", "3000", "--chunks", "1024,4096",
                     "--reps", "1"],
                    ["score_device_chunk", "dispatch_calibration"]),
    "pre_probe": (["--events", "3000", "--workers", "1,2", "--reps", "1"],
                  ["pre_workers"]),
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_records_its_knobs_on_the_cpu(probe, tmp_path, capsys,
                                            monkeypatch):
    from oni_ml_tpu_torch.scoring import score as score_mod
    from oni_ml_tpu_torch.tools import plan_cache

    monkeypatch.delenv("ONI_ML_TPU_SCORE_BREAK_EVEN", raising=False)
    monkeypatch.setattr(score_mod, "_CALIBRATION", {})
    mod = importlib.import_module(f"oni_ml_tpu_torch.tools.{probe}")
    path = str(tmp_path / "probe.jsonl")
    argv, knobs = PROBES[probe]
    sweeps = plans.counters["autotune_sweeps"]
    assert mod.main([*argv, "--device", "cpu", "--plan-cache", path]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    last = lines[-1]
    assert last["probe"] == "plan_cache_update" and last["recorded"] is True
    assert last["store"] == path
    assert plans.counters["autotune_sweeps"] > sweeps
    assert len(lines) > 1
    plan_cache.main(["show", "--plan-cache", path, "--device", "cpu"])
    shown = {json.loads(x)["knob"]
             for x in capsys.readouterr().out.splitlines()[1:]}
    assert set(knobs) <= shown
    if probe == "em_chunk_probe":
        shapes = {e.shape for e in plans.PlanStore(path).entries()}
        assert shapes == {"k4.v64.b16.l8", "*"}


def test_pre_probe_measures_the_days_it_is_given(tmp_path, capsys):
    from oni_ml_tpu_torch.synth import write_flow_day
    from oni_ml_tpu_torch.tools import pre_probe

    flow = tmp_path / "flow.csv"
    with open(flow, "w") as f:
        write_flow_day(f, 3000, seed=3)
    assert pre_probe.main(["--flow-path", str(flow), "--workers", "1,2",
                           "--reps", "1", "--device", "cpu", "--plan-cache",
                           str(tmp_path / "p.jsonl")]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert {x["dsource"] for x in lines[:-1]} == {"flow"}
    assert [x["workers"] for x in lines[:-1]] == [1, 2]
    assert lines[-1]["recorded"] and lines[-1]["pre_workers"] in (1, 2)


def test_probe_budget_stops_new_candidates(tmp_path, capsys):
    from oni_ml_tpu_torch.tools import em_chunk_probe

    assert em_chunk_probe.main(
        ["--k", "4", "--v", "64", "--b", "16", "--l", "8", "--rounds", "1",
         "--budget-s", "0", "--device", "cpu", "--plan-cache",
         str(tmp_path / "p.jsonl")]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["truncated"] is True and list(last["measurements"]) == ["16"]
