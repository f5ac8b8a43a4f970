"""The port's DNS and proxy days against the JAX package's `ml_ops`, both
on the CPU, as tests/test_torch_pipeline.py holds the flow day: the
golden DNS day (tests/golden/inputs/dns.csv with top1m.csv), a
synthetic DNS day in the bench's format (synth.write_dns_day, several
batches) and a synthetic proxy day (the proxy spec's benign day behind
a header line).  K 20, 30 EM iterations (em_tol 0: at 1e-4 the small
days converge inside 30, and one iteration apart on the two sides), the
sparse engine (stepwise on the JAX side, at the port's doc block), the
JAX initial beta carried across.  Pre and corpus artifacts
byte-identical, the model within the tolerance stated below, the scored
rows the same events in the same order (up to float32 ties on the
synthetic days); the golden day's corpus files also equal
tests/golden/expected/dns."""

import json
import os

import numpy as np
import pytest

import jax
from oni_ml_tpu import sources as jsources
from oni_ml_tpu.config import (
    DataplaneConfig,
    LDAConfig as JLDAConfig,
    PipelineConfig as JPipelineConfig,
    ScoringConfig as JScoringConfig,
    TelemetryConfig as JTelemetryConfig,
)
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu_torch.config import LDAConfig, PipelineConfig, ScoringConfig
from oni_ml_tpu_torch.io import formats
from oni_ml_tpu_torch.ops import sparse_estep as tsparse
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.synth import write_dns_day

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FDATE = "20160122"
K, EM_ITERS = 20, 30
# Above every score: all raw events are emitted, so the order of the
# whole day is compared.
TOL = 1.1
DAYS = ("dns_golden", "dns_synth", "proxy")


def _inputs(day, root):
    """(dsource, PipelineConfig keyword arguments) of a test day."""
    if day == "dns_golden":
        return "dns", dict(
            dns_path=os.path.join(GOLDEN, "inputs", "dns.csv"),
            top_domains_path=os.path.join(GOLDEN, "inputs", "top1m.csv"))
    if day == "dns_synth":
        path = root / "dns.csv"
        with open(path, "w") as f:
            write_dns_day(f, 3000, n_clients=60, n_doms=40, seed=13)
        return "dns", dict(dns_path=str(path))
    spec = jsources.get("proxy")
    path = root / "proxy.csv"
    path.write_text(",".join(spec.columns) + "\n"
                    + "\n".join(spec.synth_benign(3000, seed=9)) + "\n")
    return "proxy", dict(proxy_path=str(path))


@pytest.fixture(scope="module", params=DAYS)
def day(request, tmp_path_factory):
    """Both runners over one day: JAX with the sparse engine, the
    stepwise driver and the port's doc block; the port with the sparse
    engine from the JAX initial beta.  -> (dsource, port day dir, JAX
    day dir)."""
    root = tmp_path_factory.mktemp(request.param)
    dsource, paths = _inputs(request.param, root)
    mp = pytest.MonkeyPatch()
    mp.setenv("ONI_ML_TPU_PLAN_CACHE", str(root / "plans.jsonl"))
    mp.setattr(jsparse, "pick_block",
               lambda b, l, k, precision="f32": tsparse.pick_block(b))
    try:
        jml_ops.run_pipeline(JPipelineConfig(
            data_dir=str(root / "jax"),
            lda=JLDAConfig(num_topics=K, em_max_iters=EM_ITERS, em_tol=0.0,
                           estep_engine="sparse", fused_em_chunk=1),
            scoring=JScoringConfig(threshold=TOL),
            telemetry=JTelemetryConfig(journal=False),
            dataplane=DataplaneConfig(enabled=False), **paths,
        ), FDATE, dsource)
    finally:
        mp.undo()
    jday = root / "jax" / FDATE
    v = len(formats.read_words_dat(str(jday / "words.dat")))
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), K, v))
    ml_ops.run_pipeline(PipelineConfig(
        data_dir=str(root / "port"),
        lda=LDAConfig(num_topics=K, em_max_iters=EM_ITERS, em_tol=0.0,
                      estep_engine="sparse"),
        scoring=ScoringConfig(threshold=TOL), **paths,
    ), FDATE, dsource, device="cpu", initial_log_beta=init,
        emit=lambda *a, **k: None)
    return dsource, root / "port" / FDATE, jday


@pytest.mark.parametrize("name", ["word_counts.dat", "words.dat", "doc.dat",
                                  "model.dat"])
def test_pre_and_corpus_bytes_identical(day, name):
    _, port, ref = day
    assert (port / name).read_bytes() == (ref / name).read_bytes()


# Relative bounds (likelihood, gamma and alpha, beta as probabilities
# above 1e-12) after 30 EM iterations of float32 EM in two frameworks
# from the same initial beta.  Largest gaps measured: golden DNS 1.1e-5,
# 2.8e-5 / 1.7e-5, 2.6e-4; synthetic DNS 1.2e-6, 1.3e-5 / 1.5e-6,
# 5.7e-6; proxy 9.0e-6, 4.7e-4 / 8.7e-4, 1.7e-5.  The proxy day's 24
# clients send alike traffic, so its alpha runs to 183, where the
# likelihood is flat in alpha: the JAX package's own sparse and
# per-batch engines differ on it by 2.5e-4 in alpha and 2.7e-4 in gamma.
# Bounds about 2-5x the gaps.
MODEL_RTOL = {"dns_golden": (5e-5, 2e-4, 2e-3),
              "dns_synth": (5e-5, 2e-4, 2e-3),
              "proxy": (5e-5, 4e-3, 2e-3)}


def test_model_within_tolerance(request, day):
    """final.*, likelihood.dat and the results files within MODEL_RTOL;
    the same keys in the results files."""
    _, port, ref = day
    rtol_ll, rtol_gamma, rtol_beta = MODEL_RTOL[request.node.callspec.id]
    ll_p = formats.read_likelihood(str(port / "likelihood.dat"))
    ll_r = formats.read_likelihood(str(ref / "likelihood.dat"))
    assert ll_p.shape == ll_r.shape == (EM_ITERS, 2)
    np.testing.assert_allclose(ll_p[:, 0], ll_r[:, 0], rtol=rtol_ll)
    np.testing.assert_allclose(
        np.exp(formats.read_beta(str(port / "final.beta"))),
        np.exp(formats.read_beta(str(ref / "final.beta"))),
        rtol=rtol_beta, atol=1e-12)
    np.testing.assert_allclose(formats.read_gamma(str(port / "final.gamma")),
                               formats.read_gamma(str(ref / "final.gamma")),
                               rtol=rtol_gamma)
    o_p = formats.read_other(str(port / "final.other"))
    o_r = formats.read_other(str(ref / "final.other"))
    assert (o_p["num_topics"], o_p["num_terms"]) == (o_r["num_topics"],
                                                     o_r["num_terms"])
    np.testing.assert_allclose(o_p["alpha"], o_r["alpha"], rtol=rtol_gamma)
    for name, rtol in (("doc_results.csv", rtol_gamma),
                       ("word_results.csv", rtol_beta)):
        n_p, m_p = formats._read_keyed_matrix(str(port / name))
        n_r, m_r = formats._read_keyed_matrix(str(ref / name))
        assert n_p == n_r
        np.testing.assert_allclose(m_p, m_r, rtol=rtol, atol=1e-12)


def _scored(path):
    rows = [r.split(",") for r in path.read_text().splitlines()]
    return [tuple(r[:-1]) for r in rows], np.asarray([float(r[-1])
                                                      for r in rows])


def test_scored_rows_same_order(request, day):
    """<dsource>_results.csv: the same events, the featurized columns
    identical, the k-th score within rel 1e-3 on the two sides (a dot
    product of the doc and word rows above).  The golden day keeps the
    JAX order exactly.  On the synthetic days many events score within
    float32 noise of each other (a few hundred distinct (client, word)
    pairs over 3,000 events), so there an event may only move among
    events whose JAX scores tie with its own within rel 2e-3."""
    dsource, port, ref = day
    rows_p, s_p = _scored(port / f"{dsource}_results.csv")
    rows_r, s_r = _scored(ref / f"{dsource}_results.csv")
    assert len(rows_p) == len(rows_r) > 0
    np.testing.assert_allclose(s_p, s_r, rtol=1e-3)
    assert sorted(rows_p) == sorted(rows_r)
    if "dns_golden" in request.node.callspec.id:
        assert rows_p == rows_r
        return
    where: dict = {}
    for j, row in enumerate(rows_r):
        where.setdefault(row, []).append(j)
    for k, row in enumerate(rows_p):
        j = where[row].pop(0)
        assert abs(s_r[j] - s_r[k]) <= 2e-3 * abs(s_r[j]), (k, j, row)


def test_lda_record_and_artifacts(day):
    """Every artifact of the day exists; the `lda` record names the
    sparse engine from the config under the chunk driver, all 30
    iterations, no kernel launches on the CPU."""
    dsource, port, _ = day
    assert all((port / n).exists() for n in ml_ops.artifacts(dsource))
    with open(port / "metrics.json") as f:
        recs = {r["stage"]: r for r in json.load(f)}
    lda = recs["lda"]
    assert (lda["engine"], lda["engine_source"], lda["member"],
            lda["driver"]) == ("sparse", "config", "sparse", "fused")
    assert lda["em_iters"] == EM_ITERS and lda["corpus"] == "handoff"
    assert set(lda["kernel_launches"].values()) == {0}
    assert recs["score"]["features"] == recs["score"]["model"] == "handoff"
    assert recs["corpus"]["handoff"] == "direct"


def test_golden_dns_corpus_files_pinned(tmp_path_factory):
    """The golden DNS day's pre and corpus files from the port's runner
    equal tests/golden/expected/dns byte for byte."""
    root = tmp_path_factory.mktemp("golden_dns")
    _, paths = _inputs("dns_golden", root)
    ml_ops.run_pipeline(PipelineConfig(data_dir=str(root), **paths), FDATE,
                        "dns", device="cpu", stages=[ml_ops.Stage.PRE,
                                                     ml_ops.Stage.CORPUS],
                        emit=lambda *a, **k: None)
    for name in ("word_counts.dat", "words.dat", "doc.dat", "model.dat"):
        with open(os.path.join(GOLDEN, "expected", "dns", name), "rb") as f:
            assert (root / FDATE / name).read_bytes() == f.read(), name
