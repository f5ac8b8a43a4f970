"""The port's publish gates and their ground truth (oni_ml_tpu_torch/
models/drift.py, sources/inject.py, sources/quality.py) against the JAX
package's, on the CPU.

Tolerances: the drift and quality decisions are host float64 arithmetic
on the same inputs, so decisions, modes, baselines and journal records
are equal; `DriftDetector.evaluate` runs the float32 held-out E-step on
both sides (the port's plain ops here) and agrees within rel 1e-5; the
injected lines are numpy-generator draws and byte-equal; the quality
suite scores through each package's float64 host scorer, so its metrics
are equal on one shared model."""

import numpy as np
import pytest

from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.models.drift import DriftDetector as JDriftDetector
from oni_ml_tpu.models.drift import QualityGate as JQualityGate
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.sources import inject as jinject
from oni_ml_tpu.sources import quality as jquality
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.models import DriftDetector, QualityGate
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.sources import get as get_source
from oni_ml_tpu_torch.sources import inject, quality

RTOL_EVAL = 1e-5

LL_SEQUENCES = {
    "regress_recover": (-4.0, -4.05, -3.95, -5.0, -4.02, -4.1),
    "warming": (-6.0, -9.0, -6.1),
    "slow_drift": tuple(-4.0 - 0.2 * i for i in range(12)),
    "noisy": (-5.0, -5.4, -4.6, -5.9, -5.1, -6.2, -4.9, -5.0, -7.0, -5.05),
}


class _J:
    def __init__(self):
        self.records = []

    def append(self, rec, sync=False):
        self.records.append(rec)


def _drive_drift(cls, lls, **kw):
    j = _J()
    d = cls(journal=j, **kw)
    out = []
    for i, ll in enumerate(lls):
        dec = d.check(ll, docs=10 + i)
        ok = d.gate(dec, version=i, tenant="t", mode=d.mode)
        out.append((dec.drifted, dec.ll, dec.baseline_ll, dec.delta,
                    dec.history, dec.mode_next, d.mode, ok, d.baseline))
    return out, j.records, (d.checks, d.drifts, d.publishes, d.vetoes)


@pytest.mark.parametrize("name", sorted(LL_SEQUENCES))
@pytest.mark.parametrize("kw", [
    {"tol_nats": 0.3, "min_history": 2},
    {"tol_nats": 0.5, "history": 3, "min_history": 1},
])
def test_drift_detector_decisions_equal_jax(name, kw):
    got = _drive_drift(DriftDetector, LL_SEQUENCES[name], **kw)
    ref = _drive_drift(JDriftDetector, LL_SEQUENCES[name], **kw)
    assert got == ref


def test_drift_detector_prime_equals_jax():
    replayed = [
        {"kind": "drift_check", "ll": -4.0, "drifted": False},
        {"kind": "drift_check", "ll": -4.1, "drifted": False},
        {"kind": "drift_check", "ll": -9.0, "drifted": True},
        {"kind": "drift_check", "ll": "nan", "drifted": False},
        {"kind": "publish_gate", "ll": -1.0},
        {"kind": "other"},
    ]
    d, jd = DriftDetector(tol_nats=0.3), JDriftDetector(tol_nats=0.3)
    assert d.prime(replayed) == jd.prime(replayed) == 2
    assert d.baseline == jd.baseline == pytest.approx(-4.05)
    assert d.check(-4.6).drifted is jd.check(-4.6).drifted is True


def test_drift_detector_argument_checks_like_jax():
    for cls in (DriftDetector, JDriftDetector):
        with pytest.raises(ValueError, match="tol_nats"):
            cls(tol_nats=0.0)
        with pytest.raises(ValueError, match="min_history"):
            cls(min_history=0)


@pytest.mark.parametrize("frac", [0.1, 0.3])
def test_drift_evaluate_within_tolerance_of_jax(frac):
    rng = np.random.default_rng(3)
    trips = [(f"10.0.0.{d}", f"w{int(rng.integers(0, 48))}",
              int(rng.integers(1, 4))) for d in range(90) for _ in range(12)]
    corpus, jcorpus = Corpus.from_word_counts(trips), \
        JCorpus.from_word_counts(trips)
    k = 4
    beta = rng.dirichlet(np.ones(corpus.num_terms), size=k)
    log_beta = np.log(beta).astype(np.float32)
    kw = dict(holdout_frac=frac, batch_size=64, min_bucket_len=16)
    ll, held = DriftDetector().evaluate(log_beta, 0.7, corpus, device="cpu",
                                        **kw)
    jll, jheld = JDriftDetector().evaluate(log_beta, 0.7, jcorpus, **kw)
    assert held == jheld
    np.testing.assert_allclose(ll, jll, rtol=RTOL_EVAL)


# ---------------------------------------------------------------------------
# QualityGate
# ---------------------------------------------------------------------------


class _ScriptedSuite:
    def __init__(self, recalls):
        self.recalls = list(recalls)

    def evaluate(self, model):
        r = self.recalls.pop(0)
        return {"recall_at_k": r, "precision_at_k": r / 2,
                "score_separation": 3.0 * r,
                "per_scenario": {"beaconing": {"recall_at_k": r}}}


@pytest.mark.parametrize("recalls", [
    (1.0, 0.9, 0.95, 0.4, 0.92),
    (0.5, 0.5, 0.1, 0.6, 0.2, 0.55),
])
def test_quality_gate_equals_jax(recalls):
    def drive(cls):
        j = _J()
        g = cls(_ScriptedSuite(recalls), tol=0.25, journal=j)
        out = []
        for v in range(len(recalls)):
            dec = g.check(None)
            out.append((dec.regressed, dec.recall, dec.baseline_recall,
                        dec.delta, dec.history,
                        g.gate(dec, version=v, tenant="t")))
        return out, j.records, (g.checks, g.publishes, g.vetoes)

    assert drive(QualityGate) == drive(JQualityGate)
    replayed = [{"kind": "quality_gate", "action": "published",
                 "recall_at_k": 0.9},
                {"kind": "quality_gate", "action": "vetoed",
                 "recall_at_k": 0.1}]
    g = QualityGate(_ScriptedSuite(()), min_history=1)
    jg = JQualityGate(_ScriptedSuite(()), min_history=1)
    assert g.prime(replayed) == jg.prime(replayed) == 1
    assert g.baseline == jg.baseline == 0.9


# ---------------------------------------------------------------------------
# Injection and the quality suite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source,kw", [
    ("flow", {}),
    ("flow", {"n_events": 300, "seed": 11, "attack_events": 5,
              "scenarios": ("port_scan",)}),
    ("dns", {}),
    ("dns", {"n_events": 250, "seed": 2, "attack_events": 9}),
    ("proxy", {}),
])
def test_inject_scenarios_byte_equal_to_jax(source, kw):
    day = inject.inject_scenarios(source, **kw)
    ref = jinject.inject_scenarios(source, **kw)
    assert day.lines == ref.lines
    assert day.labels == ref.labels
    assert day.manifest == ref.manifest
    assert day.label_rows() == ref.label_rows()
    np.testing.assert_array_equal(day.attack_mask, ref.attack_mask)
    assert inject.scenarios_for(source) == jinject.scenarios_for(source)


def test_inject_refuses_foreign_scenario_like_jax():
    for mod in (inject, jinject):
        with pytest.raises(ValueError, match="not defined for source"):
            mod.inject_scenarios("dns", scenarios=("beaconing",))


def test_detection_metrics_equal_jax():
    rng = np.random.default_rng(9)
    scores = rng.uniform(1e-30, 1e-2, size=200)
    labels = [None] * 200
    for i in rng.choice(200, size=20, replace=False):
        labels[int(i)] = {"scenario": ("a", "b")[int(i) % 2], "entity": "e"}
    mask = np.array([lb is not None for lb in labels])
    for k in (0, 5, 400):
        assert quality.detection_metrics(scores, mask, k) == \
            jquality.detection_metrics(scores, mask, k)
        assert quality.scenario_metrics(scores, labels, k) == \
            jquality.scenario_metrics(scores, labels, k)


@pytest.mark.parametrize("source", ["flow", "dns", "proxy"])
def test_quality_suite_equals_jax_on_one_model(source):
    """One model, built from the suite's own day, scored by both
    suites: every metric and the per-scenario breakdown equal."""
    spec = get_source(source)
    day = inject.inject_scenarios(source, n_events=400, seed=4,
                                  attack_events=6)
    cuts = spec.derive_cuts(day.lines)
    from oni_ml_tpu.sources import get as jget_source

    jcuts = jget_source(source).derive_cuts(day.lines)
    suite = quality.QualitySuite(source, cuts, n_events=400, seed=4,
                                 attack_events=6)
    jsuite = jquality.QualitySuite(source, jcuts, n_events=400, seed=4,
                                   attack_events=6)
    assert suite.manifest == jsuite.manifest
    corpus = Corpus.from_word_counts(suite.feats.word_counts())
    rng = np.random.default_rng(1)
    gamma = rng.gamma(1.0, size=(corpus.num_docs, 5))
    log_beta = np.log(rng.dirichlet(np.ones(corpus.num_terms), size=5))
    fallback = spec.fallback(type("S", (), {f"{source}_fallback": 0.1})())
    model = ScoringModel.from_lda(corpus.doc_names, gamma, corpus.vocab,
                                  log_beta, fallback)
    jmodel = JScoringModel.from_lda(corpus.doc_names, gamma, corpus.vocab,
                                    log_beta, fallback)
    got, ref = suite.evaluate(model), jsuite.evaluate(jmodel)
    assert got == ref
    assert got["attacks"] == day.n_attacks
