"""The port's featurize plane (oni_ml_tpu_torch/sources/device.py,
ops/featurize_kernel.py and the FleetScorer's engines) against the JAX
package's, on the CPU: the same seeded days, cuts and models through
both.

Tolerances: device-gathered word and IP rows are byte-identical to the
host featurizer's and to the JAX package's device rows, over clean days
and adversarial fuzz, for flow, DNS and proxy; the "device" engine's
scores are bit-equal to the host engine's; fused scores (float32) are
within rel 1e-6 of the host's float64 and of the JAX fused program's,
and the threshold mask is the scores' own comparison."""

import os
import sys

import numpy as np
import pytest

from oni_ml_tpu.config import ServingConfig as JServingConfig
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.scoring.pipeline import \
    fused_featurize_scores as jfused_featurize_scores
from oni_ml_tpu.serving import FleetRegistry as JFleetRegistry
from oni_ml_tpu.serving import FleetScorer as JFleetScorer
from oni_ml_tpu.serving import TenantSpec as JTenantSpec
from oni_ml_tpu.sources import get as jget_source
from oni_ml_tpu.sources import device as jdevice
from oni_ml_tpu_torch import plans
from oni_ml_tpu_torch.config import ServingConfig
from oni_ml_tpu_torch.models.convert import scoring_model_from_reference
from oni_ml_tpu_torch.ops import featurize_kernel as fk
from oni_ml_tpu_torch.plans import PlanStore, use_store
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.scoring.pipeline import fused_featurize_scores
from oni_ml_tpu_torch.scoring.score import batched_scores
from oni_ml_tpu_torch.serving import (FleetRegistry, FleetScorer,
                                      MetricsEmitter, TenantSpec)
from oni_ml_tpu_torch.sources import get as get_source
from oni_ml_tpu_torch.sources.device import (DeviceBatch, Unlowerable,
                                             _CodeTable, cached_featurizer,
                                             compile_featurizer, device_batch,
                                             measure_break_even,
                                             resolve_break_even,
                                             resolve_engine)

CPU = "cpu"
SOURCES = ("flow", "dns", "proxy")
RTOL_FUSED = 1e-6
GARBAGE = ("", "junk", "nan", "NaN", "inf", "-inf", "-0.0", "0", "1e309",
           "999999", " 12 ", "0x10", "1_0", "7.5e-2", "-3.25",
           "0.30000000000000004", "  ", "None")
FUZZ_COLS = {"flow": (4, 5, 6, 8, 9, 10, 11, 16, 17),
             "dns": (1, 2, 3, 4, 6, 7), "proxy": (1, 2, 3, 4, 5, 6, 7)}


def _day(src: str, n: int = 300, seed: int = 1):
    """(port spec, JAX spec, cuts, port model, JAX model, rows): a clean
    synthetic day through the JAX source's generator and cut derivation,
    a random model over its vocabulary, the model carried across."""
    jspec = jget_source(src)
    lines = jspec.synth_benign(n, seed)
    cuts = jspec.derive_cuts(lines)
    feats = jspec.featurize(lines, precomputed_cuts=cuts)
    ips, words = jspec.event_documents(feats)
    ip_index = {v: i for i, v in enumerate(sorted(set(ips)))}
    word_index = {v: i for i, v in enumerate(sorted(set(words)))}
    rng = np.random.default_rng(seed)
    k = 4
    theta = rng.uniform(0.1, 1.0, (len(ip_index) + 1, k))
    theta[:-1] /= theta[:-1].sum(1, keepdims=True)
    p = rng.uniform(0.1, 1.0, (len(word_index) + 1, k))
    p[:-1] /= p[:-1].sum(0, keepdims=True)
    jmodel = JScoringModel(ip_index=ip_index, theta=theta,
                           word_index=word_index, p=p)
    rows = [ln.strip().split(",") for ln in lines]
    return (get_source(src), jspec, cuts,
            scoring_model_from_reference(jmodel), jmodel, rows)


def _fuzzed_rows(src: str, rows, seed: int = 7, frac: float = 0.6):
    """Column counts valid, values not: garbage numbers, -0.0 and nan,
    unseen categorical values, separator-laden strings."""
    rng = np.random.default_rng(seed)
    extra = GARBAGE + ("a_b", "x_y_z", "evil_METHOD", "q.a_b.example")
    out = []
    for r in rows:
        r = list(r)
        if rng.random() < frac:
            for _ in range(int(rng.integers(1, 4))):
                r[int(rng.choice(FUZZ_COLS[src]))] = str(rng.choice(extra))
        out.append(r)
    return out


def _host_pairs(spec, model, feats):
    pairs = spec.event_pairs(feats)
    ip = np.concatenate([model.ip_rows(k) for k, _ in pairs])
    w = np.concatenate([model.word_rows(ws) for _, ws in pairs])
    return ip.astype(np.int32), w.astype(np.int32)


def _serve_feats(spec, cuts, rows):
    """The host serving featurizer over pre-split rows: the oracle."""
    fz = spec.event_featurizer(cuts)
    return fz(rows) if spec.name == "dns" else fz([",".join(r) for r in rows])


def _check_rows(src, rows, spec, jspec, cuts, model, jmodel):
    """Port device rows == host rows == JAX device rows, byte for byte."""
    dev, info = compile_featurizer(spec, cuts, model)
    assert dev is not None, info["reason"]
    jdev, jinfo = jdevice.compile_featurizer(jspec, cuts, jmodel)
    assert {k: v for k, v in info.items()} == jinfo
    feats = _serve_feats(spec, cuts, rows)
    assert feats.num_raw_events == len(rows)
    ip_h, w_h = _host_pairs(spec, model, feats)
    w_d = dev.word_rows_local(rows)
    assert w_d.dtype == w_h.dtype and w_d.tobytes() == w_h.tobytes()
    assert w_d.tobytes() == jdev.word_rows_local(rows).tobytes()
    batch = DeviceBatch(dev, lambda raws: feats, rows, rows)
    ip_d, w_p, mult = batch.pair_rows()
    assert ip_d.tobytes() == ip_h.tobytes()
    assert w_p.tobytes() == w_h.tobytes()
    assert mult == spec.pairs_per_event == jspec.pairs_per_event
    jbatch = jdevice.DeviceBatch(jdev, lambda raws: feats, rows, rows)
    jip, jw, _ = jbatch.pair_rows(3, 5)
    ip3, w5, _ = batch.pair_rows(3, 5)
    assert ip3.tobytes() == jip.tobytes() and w5.tobytes() == jw.tobytes()
    return dev, batch


# ---------------------------------------------------------------------------
# parity: device rows byte-identical to the host's and the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", SOURCES)
def test_parity_clean_day(src):
    spec, jspec, cuts, model, jmodel, rows = _day(src)
    _check_rows(src, rows, spec, jspec, cuts, model, jmodel)


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("seed", [7, 23])
def test_parity_adversarial_fuzz(src, seed):
    spec, jspec, cuts, model, jmodel, rows = _day(src)
    _check_rows(src, _fuzzed_rows(src, rows, seed=seed), spec, jspec, cuts,
                model, jmodel)


def test_parity_flow_signed_zero_and_nan_ports():
    """str(-0.0) != str(0.0): the port intern pass uniques on float bits;
    NaN ports follow Python's min/max, not numpy's."""
    spec, jspec, cuts, model, jmodel, rows = _day("flow")
    probes = []
    for sport, dport in [("-0.0", "0.0"), ("0.0", "-0.0"), ("nan", "80"),
                         ("80", "nan"), ("nan", "nan"), ("-0.0", "-0.0"),
                         ("0", "0")]:
        r = list(rows[0])
        r[10], r[11] = sport, dport
        probes.append(r)
    _check_rows("flow", probes, spec, jspec, cuts, model, jmodel)


@pytest.mark.parametrize("src", SOURCES)
def test_malformed_row_shedding_matches_jax(src):
    """admit / validate refuse what the host featurizer would shed
    (wrong column counts), as the JAX featurizers do."""
    spec, jspec, cuts, _, _, rows = _day(src)
    fz, jfz = spec.event_featurizer(cuts), jspec.event_featurizer(cuts)
    good = ",".join(rows[0])
    assert fz.admit(good) == jfz.admit(good)
    assert fz.admit(good)[1] == rows[0]
    for bad in (good + ",extra", "only,three,cols", ""):
        for f in (fz.admit, fz.validate, jfz.admit):
            with pytest.raises(ValueError):
                f(bad)
        assert spec.featurize([bad], precomputed_cuts=cuts).num_raw_events \
            == 0


@pytest.mark.parametrize("src", ["flow", "dns"])
def test_golden_day_parity(src):
    """Device word rows byte-identical to the host's on the committed
    golden day against its committed model."""
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
    sys.path.insert(0, golden)
    from generate import (DNS_FALLBACK, FLOW_FALLBACK, load_dns_feats,
                          load_flow_feats)

    spec = get_source(src)
    feats, fallback = ((load_flow_feats(), FLOW_FALLBACK) if src == "flow"
                       else (load_dns_feats(), DNS_FALLBACK))
    model = ScoringModel.from_files(
        os.path.join(golden, "expected", src, "doc_results.csv"),
        os.path.join(golden, "expected", src, "word_results.csv"),
        fallback=fallback)
    cuts = tuple(np.asarray(c, np.float64)
                 for c in jget_source(src).cuts_of(feats))
    dev, info = compile_featurizer(spec, cuts, model)
    assert dev is not None, info["reason"]
    with open(os.path.join(golden, "inputs", f"{src}.csv")) as f:
        rows = [ln.split(",") for ln in f.read().splitlines() if ln.strip()]
    rows = [r for r in rows if len(r) == spec.num_columns][1:]
    _, w_h = _host_pairs(spec, model, _serve_feats(spec, cuts, rows))
    assert dev.word_rows_local(rows).tobytes() == w_h.tobytes()


# ---------------------------------------------------------------------------
# strict-parse gates and the code table
# ---------------------------------------------------------------------------


def _with_word(model, word, normalize=False):
    """`model` with one more vocabulary word (a copy of the last word's
    row); `normalize` rescales p's columns so the model publishes."""
    wi = dict(model.word_index)
    wi[word] = len(wi)
    p = np.vstack([model.p[:-1], model.p[-2:]])
    if normalize:
        p[:-1] /= p[:-1].sum(0, keepdims=True)
    return type(model)(ip_index=model.ip_index, theta=model.theta,
                       word_index=wi, p=p)


@pytest.mark.parametrize("src,word,lowered", [
    ("dns", "0_4_1_0_5_1_1_0_1", False),     # 9 segments: a separator
    ("proxy", "GET_junk", False),            # fails the template grammar
    ("flow", "not_a_flow_word", True),       # host-unproducible: skipped
])
def test_strict_parse_gates_match_jax(src, word, lowered):
    spec, jspec, cuts, model, jmodel, rows = _day(src)
    dev, info = compile_featurizer(spec, cuts, _with_word(model, word))
    jdev, jinfo = jdevice.compile_featurizer(jspec, cuts,
                                             _with_word(jmodel, word))
    assert info == jinfo
    assert info["lowered"] is lowered and (dev is not None) is lowered
    if lowered:
        odd = _with_word(model, word)
        _, w_h = _host_pairs(spec, odd, _serve_feats(spec, cuts, rows))
        assert dev.word_rows_local(rows).tobytes() == w_h.tobytes()


def test_sparse_code_table_mode_and_parity():
    """The serve dry run's DNS vocabulary (~5M packed codes for ~100
    words) takes the sorted-code probe; rows stay the host's."""
    from oni_ml_tpu_torch.runner.serve import _synthetic_day

    rows, model, cuts = _synthetic_day(seed=42)
    spec = get_source("dns")
    dev, info = compile_featurizer(spec, tuple(cuts), model)
    assert dev is not None, info["reason"]
    assert info["mode"] == "sparse" and info["code_space"] > info["lut"]
    _, w_h = _host_pairs(spec, model,
                         spec.event_featurizer(tuple(cuts))(rows))
    assert dev.word_rows_local(rows).tobytes() == w_h.tobytes()


def test_code_table_shapes_match_jax():
    for cls in (_CodeTable, jdevice._CodeTable):
        t = cls([(0, 1, 0), (1, 0, 1)], (2, 2), fallback_row=2)
        assert t.mode == "dense" and t.size == 8
        assert t.rows_of(np.array([1, 2, 3], np.int32)).tolist() == [0, 1, 2]
        big = cls([(0, 5, 0), (1, 7, 1)], (2, 1 << 30), fallback_row=2)
        assert big.mode == "sparse"
        codes = big.mask_invalid(np.array([5, (1 << 30) + 7, 12], np.int64),
                                 np.array([False, False, True]))
        assert big.rows_of(codes).tolist() == [0, 1, 2]
    with pytest.raises(Unlowerable):
        _CodeTable([], (1 << 31, 1 << 31, 1), fallback_row=0)


# ---------------------------------------------------------------------------
# compile cache, engine and break-even resolution
# ---------------------------------------------------------------------------


def test_cached_featurizer_compiles_once():
    spec, _, cuts, model, _, rows = _day("proxy", n=60)
    dev1, info1 = cached_featurizer(model, spec, cuts)
    assert dev1 is not None and info1 is not None
    dev2, info2 = cached_featurizer(model, spec, cuts)
    assert dev2 is dev1 and info2 is None
    raws = [",".join(r) for r in rows]
    batch, fresh = device_batch(spec.event_featurizer(cuts), rows, raws,
                                model)
    assert isinstance(batch, DeviceBatch) and fresh is None
    # The host features stay one attribute away (the flagged rows).
    assert batch.featurized_row(0) == \
        spec.event_featurizer(cuts)(raws).featurized_row(0)


def test_shared_vocab_rebinds_compiled_table():
    """Tenants of one vocabulary share one compiled table and one device
    copy of its rows; another vocabulary does not."""
    spec, _, cuts, model, _, rows = _day("dns", n=80, seed=3)
    rng = np.random.default_rng(9)
    theta2 = rng.uniform(0.1, 1.0, model.theta.shape)
    theta2[:-1] /= theta2[:-1].sum(1, keepdims=True)
    p2 = rng.uniform(0.1, 1.0, model.p.shape)
    p2[:-1] /= p2[:-1].sum(0, keepdims=True)
    model2 = ScoringModel(ip_index=dict(model.ip_index), theta=theta2,
                          word_index=dict(model.word_index), p=p2)
    dev1, info1 = cached_featurizer(model, spec, cuts)
    dev2, info2 = cached_featurizer(model2, spec, cuts)
    assert info1["shared"] is False and info2["shared"] is True
    assert dev2 is not dev1 and dev2.table is dev1.table
    assert dev2.model is model2
    assert fk.device_lut(dev2, CPU) is fk.device_lut(dev1, CPU)
    model3 = _with_word(model, "zz_phantom_word")
    dev3, info3 = cached_featurizer(model3, spec, cuts)
    assert info3["shared"] is False and dev3.table is not dev1.table


def test_resolve_engine_matches_jax(monkeypatch):
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    for value in ("auto", "host", "device", "fused"):
        assert resolve_engine(value) == jdevice.resolve_engine(value)
    monkeypatch.setenv("ONI_ML_TPU_FEATURIZE", "host")
    assert resolve_engine("fused") == ("host", "env")
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE")
    with pytest.raises(ValueError, match="featurize_engine"):
        resolve_engine("gpu")


def test_resolve_break_even_precedence_and_measured_record(tmp_path,
                                                          monkeypatch):
    """env > config > the plan entry measure_break_even records for this
    device (read back through plans.resolve) > 1."""
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE_BREAK_EVEN", raising=False)
    spec, _, cuts, model, _, rows = _day("dns", n=600)
    fz = spec.event_featurizer(cuts)
    with use_store(PlanStore(str(tmp_path / "plans.jsonl"))):
        assert resolve_break_even(0, device=CPU) == (1, "default")
        before = plans.counters_snapshot()["autotune_sweeps"]
        be, samples = measure_break_even(fz, rows, rows, model,
                                         sizes=(16, 64, 512), device=CPU)
        assert plans.counters_snapshot()["autotune_sweeps"] == before + 1
        assert [s["size"] for s in samples] == [16, 64, 512]
        assert all(s["host_us"] > 0 and s["device_us"] > 0 for s in samples)
        if be is not None:
            entry = [e for e in plans.current_store().entries()
                     if e.knob == "featurize_break_even"][-1]
            assert entry.value == be
        want = (be, "plan") if be is not None else (1, "default")
        assert resolve_break_even(0, device=CPU) == want
        assert plans.resolve("featurize_break_even", None, device=CPU) == (
            (be, "plan") if be is not None else (None, "default"))
        assert resolve_break_even(24, device=CPU) == (24, "config")
        monkeypatch.setenv("ONI_ML_TPU_FEATURIZE_BREAK_EVEN", "7")
        assert resolve_break_even(24, device=CPU) == (7, "env")
    # An unlowerable model measures nothing.
    bad = _with_word(model, "0_4_1_0_5_1_1_0_1")
    assert measure_break_even(fz, rows, rows, bad, device=CPU) == (None, [])


# ---------------------------------------------------------------------------
# the fused flush and the fleet's engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", SOURCES)
@pytest.mark.parametrize("word_base", [0, 2])
def test_fused_scores_and_threshold_match_jax(src, word_base):
    """fused_featurize_scores (+ the mask) within rel 1e-6 of the host's
    float64 and of the JAX fused program, at a stacked word offset."""
    spec, jspec, cuts, model, jmodel, rows = _day(src, n=150)
    dev, _ = compile_featurizer(spec, cuts, model)
    jdev, _ = jdevice.compile_featurizer(jspec, cuts, jmodel)
    feats = _serve_feats(spec, cuts, rows)
    batch = DeviceBatch(dev, lambda raws: feats, rows, rows)
    jbatch = jdevice.DeviceBatch(jdev, lambda raws: feats, rows, rows)
    # Shift p so the offset lands each row back on its own values.
    wide = type(model)(ip_index=model.ip_index, theta=model.theta,
                       word_index={}, p=np.vstack(
                           [np.zeros((word_base, model.p.shape[1])),
                            model.p]))
    jwide = JScoringModel(ip_index=jmodel.ip_index, theta=jmodel.theta,
                          word_index={}, p=wide.p)
    d, codes, ip = batch.fused_operands()
    jd, jcodes, jip = jbatch.fused_operands()
    assert codes.tobytes() == jcodes.tobytes()
    ref = batched_scores(model, *batch.pair_rows()[:2], None)
    got = fused_featurize_scores(wide, d, codes, ip, word_base=word_base,
                                 block=256, device=CPU)
    jgot = jfused_featurize_scores(jwide, jd, jcodes, jip,
                                   word_base=word_base, block=256)
    np.testing.assert_allclose(got, ref, rtol=RTOL_FUSED)
    np.testing.assert_allclose(got, jgot, rtol=RTOL_FUSED)
    thr = float(np.median(ref))
    scores, keep = fused_featurize_scores(wide, d, codes, ip,
                                          word_base=word_base, block=256,
                                          threshold=thr, device=CPU)
    _, jkeep = jfused_featurize_scores(jwide, jd, jcodes, jip,
                                       word_base=word_base, block=256,
                                       threshold=thr)
    np.testing.assert_array_equal(scores, got)
    np.testing.assert_array_equal(keep, np.float32(scores) < np.float32(thr))
    # The mask agrees with the JAX package's wherever no score sits
    # within float32 rounding of the threshold.
    clear = np.abs(ref - thr) > 1e-6 * thr
    np.testing.assert_array_equal(keep[clear], jkeep[clear])


def test_fused_scores_register_their_cost_and_check_ranges():
    from oni_ml_tpu_torch.telemetry import roofline

    spec, _, cuts, model, _, rows = _day("dns", n=40)
    dev, _ = compile_featurizer(spec, cuts, model)
    batch = DeviceBatch(dev, None, rows, rows)
    d, codes, ip = batch.fused_operands()
    fused_featurize_scores(model, d, codes, ip, block=64, device=CPU)
    cost = roofline.cost_for("serve.featurize_fused")
    k = model.theta.shape[1]
    assert cost["shape"].startswith("n64.") and cost["flops"] == 2 * k * 64
    assert cost["bytes"] == 64 * (12 + 2 * k * 4 + 4)
    rows_got = fk.lut_rows(d, codes, block=64, device=CPU)
    assert rows_got.tobytes() == dev.table.rows_of(
        batch.codes()).astype(np.int32).tobytes()
    assert roofline.cost_for("serve.featurize_rows")["bytes"] == 12 * 64
    with pytest.raises(IndexError):
        fused_featurize_scores(model, d, codes, ip + model.theta.shape[0],
                               device=CPU)
    with pytest.raises(IndexError):
        fk.lut_rows(d, codes + dev.table.size, device=CPU)


def _fleet(src, model, cuts, engine, journal, jax=False, **cfg_kw):
    spec = (jget_source if jax else get_source)(src)
    fleet = (JFleetRegistry if jax else FleetRegistry)()
    fleet.add_tenant((JTenantSpec if jax else TenantSpec)(tenant="t0",
                                                          dsource=src))
    fleet.publish("t0", model, source="day")
    cfg = (JServingConfig if jax else ServingConfig)(
        device_score_min=None, featurize_engine=engine, **cfg_kw)
    if jax:
        return JFleetScorer(fleet, {"t0": spec.event_featurizer(cuts)}, cfg,
                            journal=journal)
    return FleetScorer(fleet, {"t0": spec.event_featurizer(cuts)}, cfg,
                       metrics=MetricsEmitter(to_stdout=False),
                       journal=journal, device=CPU)


class _Journal(list):
    def append(self, record):  # noqa: A003 - the journal protocol
        list.append(self, record)


def _serve(scorer, raws):
    futs = [scorer.submit("t0", r) for r in raws]
    scorer.flush()
    out = np.array([f.result(timeout=30)[0] for f in futs])
    scorer.close()
    return out


@pytest.mark.parametrize("src", SOURCES)
def test_fleet_device_engine_scores_bitwise(src, monkeypatch):
    """The "device" engine's scores equal the host engine's and the JAX
    fleet's device engine's bit for bit; one compile record, and the
    demux record names the engine."""
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE_BREAK_EVEN", raising=False)
    spec, _, cuts, model, jmodel, rows = _day(src, n=120)
    raws = rows if src == "dns" else [",".join(r) for r in rows]
    out = {}
    for engine in ("host", "device"):
        jn = _Journal()
        scorer = _fleet(src, model, cuts, engine, jn,
                        featurize_break_even=1)
        out[engine] = _serve(scorer, raws)
        if engine == "device":
            comp = [r for r in jn if r.get("kind") == "featurize_compile"]
            assert len(comp) == 1 and comp[0]["lowered"]
            dem = [r for r in jn if r.get("kind") == "demux"]
            assert dem[0]["featurize"] == "device"
            assert dem[0]["featurize_device_tenants"] == 1
            assert scorer.counts["featurize_device"] >= 1
            assert scorer.counts["featurize_host"] == 0
    jout = _serve(_fleet(src, jmodel, cuts, "device", _Journal(), jax=True),
                  raws)
    np.testing.assert_array_equal(out["device"], out["host"])
    np.testing.assert_array_equal(out["device"], jout)


def test_fleet_fused_engine_within_rel_of_host_and_jax(monkeypatch):
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    spec, _, cuts, model, jmodel, rows = _day("dns", n=200)
    host = _serve(_fleet("dns", model, cuts, "host", _Journal()), rows)
    scorer = _fleet("dns", model, cuts, "fused", _Journal(),
                    featurize_break_even=1)
    fused = _serve(scorer, rows)
    assert scorer.counts["fused_dispatches"] >= 1
    jfused = _serve(_fleet("dns", jmodel, cuts, "fused", _Journal(),
                           jax=True), rows)
    np.testing.assert_allclose(fused, host, rtol=RTOL_FUSED)
    np.testing.assert_allclose(fused, jfused, rtol=RTOL_FUSED)


def test_unlowerable_model_keeps_the_host_featurizer_and_is_counted(
        monkeypatch):
    """The strict-parse gate is the fleet's semantics: the tenant keeps
    the host featurizer (same scores), one compile record says why, and
    the scorer counts it."""
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    spec, _, cuts, model, _, rows = _day("dns", n=60)
    bad = _with_word(model, "0_4_1_0_5_1_1_0_1", normalize=True)
    jn = _Journal()
    scorer = _fleet("dns", bad, cuts, "device", jn, featurize_break_even=1)
    got = _serve(scorer, rows)
    host = _serve(_fleet("dns", bad, cuts, "host", _Journal()), rows)
    np.testing.assert_array_equal(got, host)
    comp = [r for r in jn if r.get("kind") == "featurize_compile"]
    assert len(comp) == 1 and not comp[0]["lowered"]
    assert scorer.counts["unlowered"] == 1
    assert scorer.counts["featurize_device"] == 0


def test_pending_event_row_plumbing(monkeypatch):
    """A validate-only featurizer (no admit) still serves, on the host
    featurizer."""
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    spec, _, cuts, model, _, rows = _day("proxy", n=40)

    class ValidateOnly:
        dsource = "proxy"

        def __init__(self, inner):
            self._inner = inner

        def validate(self, line):
            return self._inner.validate(line)

        def __call__(self, lines):
            return self._inner(lines)

    fleet = FleetRegistry()
    fleet.add_tenant(TenantSpec(tenant="t0", dsource="proxy"))
    fleet.publish("t0", model, source="day")
    jn = _Journal()
    scorer = FleetScorer(
        fleet, {"t0": ValidateOnly(spec.event_featurizer(cuts))},
        ServingConfig(device_score_min=None, featurize_engine="device"),
        metrics=MetricsEmitter(to_stdout=False), journal=jn, device=CPU)
    scores = _serve(scorer, [",".join(r) for r in rows])
    assert len(scores) == len(rows)
    dem = [r for r in jn if r.get("kind") == "demux"]
    assert dem[0]["featurize_device_tenants"] == 0


def test_segments_below_the_break_even_featurize_on_the_host(monkeypatch):
    monkeypatch.delenv("ONI_ML_TPU_FEATURIZE", raising=False)
    spec, _, cuts, model, _, rows = _day("dns", n=60)
    scorer = _fleet("dns", model, cuts, "device", _Journal(),
                    featurize_break_even=1000)
    assert scorer.plan["featurize_break_even"] == {"value": 1000,
                                                   "source": "config"}
    _serve(scorer, rows)
    assert scorer.counts["featurize_device"] == 0
    assert scorer.counts["featurize_host"] >= 1
