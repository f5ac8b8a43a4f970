"""The port's continuous standing service (oni_ml_tpu_torch/runner/
continuous.py, `ml_ops continuous`) and the source hooks it runs on
(`event_time_s`, `derive_cuts`, `event_indices`), against the JAX
package's, on the CPU, at the JAX tests' sizes and seeds
(tests/test_streaming.py:370-532: K 4, batch 64, vocab floor 512,
180-220-event slices).

Tolerances: slicing, pacing order, event times, cuts and index arrays
are host arithmetic and equal.  A service run trains float32 EM on both
sides from the same initial beta (the JAX package's threefry draw
replaces the port's torch.Generator draw here), so its sequence of
(mode, published, drifted, version) is equal and each refresh's
held-out likelihood agrees within rel 1e-4."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from oni_ml_tpu.config import ContinuousConfig as JContinuousConfig
from oni_ml_tpu.config import PipelineConfig as JPipelineConfig
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.runner import continuous as jcont
from oni_ml_tpu.sources import get as jget_source
from oni_ml_tpu_torch.config import (ContinuousConfig, PipelineConfig,
                                     ServingConfig)
from oni_ml_tpu_torch.models import lda
from oni_ml_tpu_torch.runner import continuous as cont
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.runner.continuous import (ContinuousService,
                                                FleetContinuousService,
                                                IngestSlice, paced_slices)
from oni_ml_tpu_torch.serving.events import score_features
from oni_ml_tpu_torch.sources import get as get_source

CPU = "cpu"
RTOL_LL = 1e-4


def _flow_line(rng, sip, dip, dport, h=None):
    h = int(rng.integers(0, 24)) if h is None else h
    return (
        "2016-01-22 00:00:00,2016,1,22,"
        f"{h},{int(rng.integers(0, 60))},{int(rng.integers(0, 60))},0.0,"
        f"{sip},{dip},{int(rng.integers(1024, 60000))},{dport},TCP,,0,0,"
        f"{int(rng.integers(1, 100))},{int(rng.integers(40, 100000))},"
        "0,0,0,0,0,0,0,0,0"
    )


def _normal_slice(rng, idx, n=220, t_base=0.0):
    ports = (80, 443, 22, 53)
    lines = [
        _flow_line(rng, f"10.0.0.{int(rng.integers(0, 24))}",
                   f"10.1.0.{int(rng.integers(0, 12))}",
                   ports[int(rng.integers(0, len(ports)))])
        for _ in range(n)
    ]
    return IngestSlice(lines=lines, t0=t_base + idx * 600.0,
                       t1=t_base + (idx + 1) * 600.0, index=idx)


def _drifted_slice(rng, idx, n=220):
    """Uniform-random service ports explode the vocabulary, so the
    window's model scores its own held-out docs nats worse."""
    lines = [
        _flow_line(rng, f"10.0.0.{int(rng.integers(0, 24))}",
                   f"10.1.0.{int(rng.integers(0, 12))}",
                   int(rng.integers(1, 60000)))
        for _ in range(n)
    ]
    return IngestSlice(lines=lines, t0=idx * 600.0,
                       t1=(idx + 1) * 600.0, index=idx)


CC = dict(window_s=1800.0, refresh_every_s=1200.0, min_refresh_docs=8,
          drift_tol_nats=0.8, drift_min_history=2, vocab_floor=512,
          batch_size=64, holdout_frac=0.3)


def _config(tmp_path, serving=None, **cc_kw):
    config = PipelineConfig(data_dir=str(tmp_path),
                            continuous=ContinuousConfig(**{**CC, **cc_kw}))
    config = dataclasses.replace(
        config, lda=dataclasses.replace(config.lda, num_topics=4,
                                        em_max_iters=30))
    if serving is not None:
        config = dataclasses.replace(config, serving=serving)
    return config


def _jconfig(tmp_path, **cc_kw):
    config = JPipelineConfig(data_dir=str(tmp_path),
                             continuous=JContinuousConfig(**{**CC, **cc_kw}))
    return dataclasses.replace(
        config, lda=dataclasses.replace(config.lda, num_topics=4,
                                        em_max_iters=30))


@pytest.fixture()
def jax_init(monkeypatch):
    """The port's fresh EM init replaced by the JAX package's threefry
    draw for the same seed, so both services train from one beta."""
    def init(gen, k, v, device=CPU):
        draw = np.array(jlda.init_log_beta(jax.random.PRNGKey(0), k, v))
        return torch.as_tensor(draw).to(device)

    monkeypatch.setattr(lda, "init_log_beta", init)


# ---------------------------------------------------------------------------
# Slicing, pacing, interleaving
# ---------------------------------------------------------------------------


def _source_lines(dsource):
    lines = get_source(dsource).synth_benign(300, seed=2)
    rng = np.random.default_rng(4)
    lines = [lines[i] for i in rng.permutation(len(lines))]
    return ["header,row\n", *lines[:150], "garbage\n", "\n", *lines[150:]]


def _slices_key(slices):
    return [(s.lines, s.t0, s.t1, s.index) for s in slices]


@pytest.mark.parametrize("dsource", ["flow", "dns", "proxy"])
@pytest.mark.parametrize("slice_s", [600.0, 3600.0])
def test_slice_events_equal_jax(dsource, slice_s):
    lines = _source_lines(dsource)
    got = cont.slice_events(lines, dsource, slice_s)
    ref = jcont.slice_events(lines, dsource, slice_s)
    assert _slices_key(got) == _slices_key(ref)
    assert sum(s.events for s in got) == 300
    base = got[0].t0 - 7.0
    assert _slices_key(cont.slice_events(lines, dsource, slice_s,
                                         t_base=base)) == \
        _slices_key(jcont.slice_events(lines, dsource, slice_s,
                                       t_base=base))


def test_slice_events_rejects_bad_span_like_jax():
    for mod in (cont, jcont):
        with pytest.raises(ValueError, match="slice_s"):
            mod.slice_events([], "flow", 0.0)
        assert mod.slice_events([], "flow", 60.0) == []


def test_paced_and_interleaved_equal_jax():
    per = {t: cont.slice_events(_source_lines(d), d, 1800.0)
           for t, d in (("b", "flow"), ("a", "dns"))}
    jper = {t: jcont.slice_events(_source_lines(d), d, 1800.0)
            for t, d in (("b", "flow"), ("a", "dns"))}
    got = cont.interleave_streams(per)
    ref = jcont.interleave_streams(jper)
    assert [(t, s.lines, s.t1) for t, s in got] == \
        [(t, s.lines, s.t1) for t, s in ref]
    sleeps, jsleeps = [], []
    paced = list(cont.paced_tagged(got, 1e9, sleep=sleeps.append))
    jpaced = list(jcont.paced_tagged(ref, 1e9, sleep=jsleeps.append))
    assert [(t, s.t1) for t, s in paced] == [(t, s.t1) for t, s in jpaced]
    walls = [s.arrival_wall for _, s in paced]
    assert walls == sorted(walls) and walls[0] > 0
    one = list(cont.paced_slices(per["b"], float("inf")))
    assert [s.index for s in one] == [s.index for s in jper["b"]]
    for mod in (cont, jcont):
        with pytest.raises(ValueError, match="speed"):
            list(mod.paced_slices(per["b"], 0.0))
        with pytest.raises(ValueError, match="speed"):
            list(mod.paced_tagged(got, -1.0))


# ---------------------------------------------------------------------------
# The source hooks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dsource", ["flow", "dns", "proxy"])
def test_source_hooks_equal_jax(dsource):
    spec, jspec = get_source(dsource), jget_source(dsource)
    lines = spec.synth_benign(400, seed=6)
    assert [spec.event_time_s(ln) for ln in lines] == \
        [jspec.event_time_s(ln) for ln in lines]
    for bad in ("", "a,b"):
        for s in (spec, jspec):
            with pytest.raises((ValueError, IndexError)):
                s.event_time_s(bad)
    cuts = spec.derive_cuts(lines[:200])
    jcuts = jspec.derive_cuts(lines[:200])
    assert len(cuts) == len(jcuts)
    for c, jc in zip(cuts, jcuts):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(jc))
    assert spec.derive_cuts(list(lines[:200])) is cuts       # memoized
    feats = spec.featurize(lines, precomputed_cuts=cuts)
    jfeats = jspec.featurize(lines, precomputed_cuts=jcuts)
    pairs = feats.word_counts()
    ip_index = {ip: i for i, ip in enumerate(dict.fromkeys(
        p[0] for p in pairs[::2]))}
    word_index = {w: i for i, w in enumerate(dict.fromkeys(
        p[1] for p in pairs[1::2]))}
    got = spec.event_indices(feats, ip_index, word_index)
    ref = jspec.event_indices(jfeats, ip_index, word_index)
    assert len(got) == len(ref) == 2 * spec.pairs_per_event
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_flow_derive_cuts_reads_qtiles_like_jax(tmp_path):
    from oni_ml_tpu_torch.features.qtiles import write_flow_qtiles

    spec, jspec = get_source("flow"), jget_source("flow")
    lines = spec.synth_benign(200, seed=1)
    cuts = spec.derive_cuts(lines)
    path = str(tmp_path / "flow_qtiles")
    write_flow_qtiles(path, *cuts)
    got = spec.derive_cuts(lines[:10], str(path))
    ref = jspec.derive_cuts(lines[:10], str(path))
    for c, jc in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(jc))


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


def _service(tmp_path, **kw):
    return ContinuousService(_config(tmp_path), "flow",
                             out_dir=str(tmp_path / "cont"),
                             warmup_refreshes=2, device=CPU, **kw)


def test_drift_gate_vetoes_and_fleet_serves_prior_bits(tmp_path):
    """tests/test_streaming.py:419-501 in the port: a drifted window is
    vetoed, the fleet keeps scoring bit-identically on the prior version
    through the vetoed refresh, and a recovered window publishes."""
    rng = np.random.default_rng(7)
    svc = _service(tmp_path)
    try:
        idx = 0
        for _ in range(6):
            svc.ingest_slice(_normal_slice(rng, idx))
            svc.maybe_refresh(idx * 600.0 + 600.0)
            idx += 1
        assert svc.drift.publishes >= 2
        assert svc.drift.vetoes == 0
        v_before = svc.fleet.version(svc.tenant)
        snap_before = svc.fleet.active(svc.tenant)
        probe = [_flow_line(rng, "10.0.0.1", "10.1.0.2", 80)
                 for _ in range(16)]
        feats = svc.scorer._lanes[svc.tenant].featurizer(probe)
        scores_before = score_features(snap_before.model, feats, "flow")
        futs = [svc.scorer.submit(svc.tenant, ln) for ln in probe]
        svc.scorer.flush()
        resolved = [f.result(timeout=30.0) for f in futs]
        served_before = np.asarray([s for s, _ in resolved], np.float64)
        assert all(v == v_before for _, v in resolved)
        for _ in range(2):
            svc.ingest_slice(_drifted_slice(rng, idx))
            svc.maybe_refresh(idx * 600.0 + 600.0)
            idx += 1
        assert svc.drift.vetoes >= 1
        assert svc.fleet.version(svc.tenant) == v_before
        snap_after = svc.fleet.active(svc.tenant)
        assert snap_after.version == snap_before.version
        np.testing.assert_array_equal(
            scores_before, score_features(snap_after.model, feats, "flow"))
        futs = [svc.scorer.submit(svc.tenant, ln) for ln in probe]
        svc.scorer.flush()
        resolved = [f.result(timeout=30.0) for f in futs]
        assert all(v == v_before for _, v in resolved)
        np.testing.assert_array_equal(
            served_before, np.asarray([s for s, _ in resolved], np.float64))
        for _ in range(6):
            svc.ingest_slice(_normal_slice(rng, idx))
            svc.maybe_refresh(idx * 600.0 + 600.0)
            idx += 1
        assert svc.fleet.version(svc.tenant) > v_before
        payload = svc.close()
        records = [json.loads(ln) for ln in
                   open(tmp_path / "cont" / "run_journal.jsonl")]
        gates = [r for r in records if r.get("kind") == "publish_gate"]
        assert any(g["action"] == "vetoed" for g in gates)
        assert gates[-1]["action"] == "published"
        assert any(c["drifted"] for c in records
                   if c.get("kind") == "drift_check")
        assert any(r.get("kind") == "window_advance" for r in records)
        assert payload["vetoes"] >= 1 and payload["publishes"] >= 3
        assert payload["freshness_samples"] > 0
        # Exactly once: the probes went straight to the scorer.
        assert svc.events_scored == svc.events_offered + 32
        assert svc.events_offered + svc.events_unserved \
            + svc.events_rejected == svc.events
    finally:
        if svc.scorer is not None:
            svc.close()


def _e2e_slices():
    rng = np.random.default_rng(11)
    slices = [_normal_slice(rng, i, n=180) for i in range(7)]
    # A malformed event in a post-publish slice is shed and counted.
    slices[4].lines.append("not,a,flow,line")
    return slices


def test_continuous_end_to_end_payload_matches_jax(tmp_path, jax_init):
    """tests/test_streaming.py:504-532 on both packages: the same keys,
    the same (mode, published, drifted, version) sequence, held-out
    likelihood within rel 1e-4 at every refresh."""
    svc = _service(tmp_path)
    payload = svc.run(paced_slices(_e2e_slices(), float("inf")))
    jsvc = jcont.ContinuousService(
        _jconfig(tmp_path / "jax"), "flow",
        out_dir=str(tmp_path / "jax" / "cont"), warmup_refreshes=2)
    jpayload = jsvc.run(jcont.paced_slices(_e2e_slices(), float("inf")))
    assert set(payload) == set(jpayload)
    seq = [(r["mode"], r["published"], r["drifted"], r["version"])
           for r in payload["refresh_records"]]
    jseq = [(r["mode"], r["published"], r["drifted"], r["version"])
            for r in jpayload["refresh_records"]]
    assert seq == jseq and len(seq) >= 3
    np.testing.assert_allclose(
        [r["held_out_ll"] for r in payload["refresh_records"]],
        [r["held_out_ll"] for r in jpayload["refresh_records"]],
        rtol=RTOL_LL)
    for key in ("slices", "events", "events_rejected", "refreshes",
                "publishes", "vetoes", "vocab", "vocab_capacity",
                "tier_rebuilds", "evicted_chunks", "freshness_samples",
                "uncovered_slices"):
        assert payload[key] == jpayload[key], key
    assert set(payload["refresh_records"][0]) >= set(
        jpayload["refresh_records"][0])
    assert payload["events_rejected"] == 1
    assert payload["warm"]["fits"] + payload["fresh"]["fits"] \
        == payload["refreshes"]
    assert payload["retraces_after_warmup"] == 0
    out = tmp_path / "cont"
    for name in ("flagged_events.jsonl", "continuous_metrics.json",
                 "run_journal.jsonl"):
        assert os.path.exists(out / name), name
    assert svc.events_scored == svc.events_offered
    assert svc.score_failures == 0


def test_continuous_fresh_control_and_quality_gate(tmp_path):
    """The warm-vs-fresh control after the warm-up and the injection
    suite's gate on every publish candidate: an `injection` record, one
    `quality_gate` record per checked candidate."""
    config = _config(tmp_path, quality_gate=True, quality_min_history=1,
                     quality_events=400)
    svc = ContinuousService(config, "flow", out_dir=str(tmp_path / "q"),
                            warmup_refreshes=1, fresh_control=True,
                            device=CPU)
    payload = svc.run(paced_slices(_e2e_slices(), float("inf")))
    assert payload["quality_checks"] >= 1
    ctrl = payload["fresh_control"]
    assert ctrl is not None
    assert set(ctrl) == {"at_refresh", "warm_wall_s", "fresh_wall_s",
                         "warm_em_iters", "fresh_em_iters",
                         "warm_start_speedup", "held_out_ll_warm",
                         "held_out_ll_fresh", "held_out_ll_delta"}
    records = [json.loads(ln) for ln in
               open(tmp_path / "q" / "run_journal.jsonl")]
    kinds = [r.get("kind") for r in records]
    assert kinds.count("injection") == 1
    assert kinds.count("quality_gate") == payload["quality_checks"]
    assert all("quality_recall" in r for r in payload["refresh_records"]
               if r["published"] or r.get("quality_regressed"))


# ---------------------------------------------------------------------------
# The in-process fleet
# ---------------------------------------------------------------------------


def _fleet_config(tmp_path):
    return _config(tmp_path, serving=ServingConfig(
        fleet_max_batch=32, fleet_max_wait_ms=5.0, device_score_min=None))


@pytest.mark.parametrize("cosched", [True, False])
def test_fleet_two_tenants_with_and_without_cosched(tmp_path, cosched):
    """tests/test_cosched_fleet.py's per-tenant freshness run in the
    port: a tenant replaying yesterday beside one replaying today gets
    event-time freshness off its own clock, both publish through the
    shared co-scheduler (or its observe-only control), exactly once."""
    fleet = FleetContinuousService(
        _fleet_config(tmp_path), {"today": "flow", "yday": "flow"},
        out_dir=str(tmp_path / "fleet"), coscheduler=cosched,
        warmup_refreshes=2, device=CPU)
    rng = np.random.default_rng(3)
    lag = 86400.0
    try:
        for idx in range(6):
            if idx == 4:
                # The first refreshes land before the second boundary,
                # so none coalesces and both tenants pass the warm-up.
                fleet._rq.join()
            fleet.ingest("today", _normal_slice(rng, idx, n=120))
            fleet.ingest("yday", _normal_slice(rng, idx, n=120,
                                               t_base=-lag))
    finally:
        payload = fleet.close()
    assert payload["coalesced_refreshes"] == 0
    assert payload["refreshes"] == 4
    t_yday = payload["tenants"]["yday"]
    assert payload["tenants"]["today"]["freshness_samples"] > 0
    assert t_yday["freshness_samples"] > 0
    assert t_yday["freshness_event_p99_min"] < 120.0
    assert payload["cosched"]["enabled"] is cosched
    assert payload["cosched"]["train_chunks"] > 0
    assert payload["publishes"] >= 2
    assert payload["refresh_errors"] == 0
    assert payload["retraces_after_warmup"] == 0
    for svc in fleet.services.values():
        assert svc.events_scored == svc.events_offered
        assert svc.events_offered + svc.events_unserved \
            + svc.events_rejected == svc.events
    records = [json.loads(ln) for ln in
               open(tmp_path / "fleet" / "run_journal.jsonl")]
    assert {r.get("tenant") for r in records
            if r.get("kind") == "freshness"} == {"today", "yday"}
    assert not any(r.get("kind") == "refresh_abandon" for r in records)
    assert os.path.exists(tmp_path / "fleet"
                          / "fleet_continuous_metrics.json")


def test_fleet_refresh_abandon_is_counted_and_journaled(tmp_path):
    fleet = FleetContinuousService(
        _fleet_config(tmp_path), {"a": "flow"},
        out_dir=str(tmp_path / "fleet"), warmup_refreshes=2, device=CPU)
    svc = fleet.services["a"]
    real = svc.refresh
    calls = []

    def flaky(now_sim):
        calls.append(now_sim)
        if len(calls) == 1:
            raise RuntimeError("injected refresh failure")
        return real(now_sim)

    svc.refresh = flaky
    rng = np.random.default_rng(5)
    try:
        for idx in range(6):
            if idx == 4:
                # The failed refresh lands before the next boundary, so
                # the retry is not coalesced into it.
                fleet._rq.join()
            fleet.ingest("a", _normal_slice(rng, idx, n=120))
    finally:
        payload = fleet.close()
    assert payload["coalesced_refreshes"] == 0
    assert payload["refresh_errors"] == 1
    assert payload["publishes"] >= 1
    records = [json.loads(ln) for ln in
               open(tmp_path / "fleet" / "run_journal.jsonl")]
    abandons = [r for r in records if r.get("kind") == "refresh_abandon"]
    assert len(abandons) == 1 and "injected" in abandons[0]["error"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _write_day(path, seed, hours=4):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for h in range(hours):
            for _ in range(160):
                f.write(_flow_line(rng, f"10.0.0.{int(rng.integers(0, 32))}",
                                   f"10.1.0.{int(rng.integers(0, 16))}",
                                   80, h=h) + "\n")


CLI_FLAGS = ["--slice-s", "3600", "--no-sleep", "--window-s", "7200",
             "--refresh-s", "3600", "--device", "cpu"]


def test_cli_single_tenant_on_cpu(tmp_path, capsys):
    day = tmp_path / "day.csv"
    _write_day(day, 13)
    rc = ml_ops.main(["continuous", "flow", "--flow-path", str(day),
                      "--data-dir", str(tmp_path), *CLI_FLAGS])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    payload = json.load(open(tmp_path / "continuous"
                             / "continuous_metrics.json"))
    assert printed == payload
    assert payload["slices"] == 4 and payload["events"] == 640
    assert payload["refreshes"] >= 2


def test_cli_two_streams_on_cpu(tmp_path, capsys):
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    _write_day(a, 13)
    _write_day(b, 14)
    for extra in ([], ["--no-cosched"]):
        rc = cont.main(["--stream", f"acme=flow:{a}",
                        "--stream", f"globex=flow:{b}",
                        "--data-dir", str(tmp_path), *CLI_FLAGS, *extra])
        assert rc == 0
        payload = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        assert sorted(payload["tenants"]) == ["acme", "globex"]
        assert payload["events"] == 1280
        assert payload["refresh_errors"] == 0
        assert payload["cosched"]["enabled"] is (not extra)


@pytest.mark.parametrize("flags,item", [
    (["--multihost", "--stream", "acme=flow:x.csv"], "single-stream"),
])
def test_cli_refuses_unported_flags(tmp_path, capsys, flags, item):
    """`--multihost` is ported for the single-stream service
    (tests/test_torch_multihost.py runs it on one and two ranks); a
    fleet's coalescing refresh worker could let ranks disagree on which
    refreshes run, so `--multihost` with `--stream` is refused."""
    rc = ml_ops.main(["continuous", *flags, "--device", "cpu"])
    assert rc == 2
    out = capsys.readouterr().out
    assert item in out and flags[0] in out


def test_cli_input_errors(tmp_path, capsys):
    assert cont.main(["flow", "--flow-path", str(tmp_path / "none.csv"),
                      "--device", "cpu"]) == 2
    assert cont.main(["--device", "cpu"]) == 2
    with pytest.raises(ValueError, match="TENANT=DSOURCE:PATH"):
        cont.main(["--stream", "bad", "--device", "cpu"])
    assert "no input file" in capsys.readouterr().out
