"""The port's flow day against the JAX package's `ml_ops` on the golden
flow input, both on the CPU: pre and corpus artifacts byte-identical,
the model within tolerance, and the scored events in the same order."""

import os

import numpy as np
import pytest

import jax
from oni_ml_tpu.config import (
    DataplaneConfig,
    LDAConfig as JLDAConfig,
    PipelineConfig as JPipelineConfig,
    ScoringConfig as JScoringConfig,
    TelemetryConfig,
)
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu_torch.config import LDAConfig, PipelineConfig, ScoringConfig
from oni_ml_tpu_torch.io import formats
from oni_ml_tpu_torch.ops import sparse_estep as tsparse
from oni_ml_tpu_torch.runner import ml_ops

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inputs", "flow.csv")
FDATE = "20160122"
K, EM_ITERS = 20, 30
# Suspicion threshold above every score: all raw events are emitted, so
# the order of the whole day is compared.
TOL = 1.1


@pytest.fixture(scope="module")
def days(tmp_path_factory):
    """Run both pipelines once: JAX with the sparse engine, stepwise
    driver and the port's doc block; the port from the JAX initial
    beta."""
    root = tmp_path_factory.mktemp("pipeline")
    mp = pytest.MonkeyPatch()
    mp.setenv("ONI_ML_TPU_PLAN_CACHE", str(root / "plans.jsonl"))
    mp.setattr(jsparse, "pick_block",
               lambda b, l, k, precision="f32": tsparse.pick_block(b))
    try:
        jcfg = JPipelineConfig(
            data_dir=str(root / "jax"), flow_path=GOLDEN,
            lda=JLDAConfig(num_topics=K, em_max_iters=EM_ITERS,
                           estep_engine="sparse", fused_em_chunk=1),
            scoring=JScoringConfig(threshold=TOL),
            telemetry=TelemetryConfig(journal=False),
            dataplane=DataplaneConfig(enabled=False),
        )
        jml_ops.run_pipeline(jcfg, FDATE, "flow")
    finally:
        mp.undo()
    jday = root / "jax" / FDATE
    v = len(formats.read_words_dat(str(jday / "words.dat")))
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), K, v))
    cfg = PipelineConfig(data_dir=str(root / "port"), flow_path=GOLDEN,
                         lda=LDAConfig(num_topics=K, em_max_iters=EM_ITERS),
                         scoring=ScoringConfig(threshold=TOL))
    ml_ops.run_pipeline(cfg, FDATE, "flow", device="cpu",
                        initial_log_beta=init, emit=lambda *a, **k: None)
    return root / "port" / FDATE, jday


@pytest.mark.parametrize("name", ["word_counts.dat", "words.dat", "doc.dat",
                                  "model.dat"])
def test_pre_and_corpus_bytes_identical(days, name):
    port, ref = days
    assert (port / name).read_bytes() == (ref / name).read_bytes()


def test_model_within_tolerance(days):
    """final.* and likelihood.dat after 30 EM iterations of float32 EM
    in two frameworks from the same initial beta.  Measured on this day:
    likelihood 5.6e-6, gamma 4.1e-5, alpha 3.4e-5 and beta 5.4e-4
    relative — alpha's Newton update feeds every later M-step, so beta
    drifts most.  Bounds, about 2-4x above: likelihood 2e-5, gamma and
    alpha 2e-4, beta (as probabilities above 1e-12) 2e-3."""
    port, ref = days
    ll_p = formats.read_likelihood(str(port / "likelihood.dat"))
    ll_r = formats.read_likelihood(str(ref / "likelihood.dat"))
    assert ll_p.shape == ll_r.shape
    np.testing.assert_allclose(ll_p[:, 0], ll_r[:, 0], rtol=2e-5)
    np.testing.assert_allclose(
        np.exp(formats.read_beta(str(port / "final.beta"))),
        np.exp(formats.read_beta(str(ref / "final.beta"))),
        rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(formats.read_gamma(str(port / "final.gamma")),
                               formats.read_gamma(str(ref / "final.gamma")),
                               rtol=2e-4)
    o_p = formats.read_other(str(port / "final.other"))
    o_r = formats.read_other(str(ref / "final.other"))
    assert (o_p["num_topics"], o_p["num_terms"]) == (o_r["num_topics"],
                                                     o_r["num_terms"])
    np.testing.assert_allclose(o_p["alpha"], o_r["alpha"], rtol=2e-4)
    for name, rtol in (("doc_results.csv", 2e-4), ("word_results.csv", 2e-3)):
        n_p, m_p = formats._read_keyed_matrix(str(port / name))
        n_r, m_r = formats._read_keyed_matrix(str(ref / name))
        assert n_p == n_r
        np.testing.assert_allclose(m_p, m_r, rtol=rtol, atol=1e-12)


def test_scored_rows_same_order(days):
    """flow_results.csv: the same events in the same (ascending score)
    order, the 35 featurized columns identical, the two scores within
    rel 1e-3 (dot products of the doc and word rows above)."""
    port, ref = days
    rows_p = (port / "flow_results.csv").read_text().splitlines()
    rows_r = (ref / "flow_results.csv").read_text().splitlines()
    assert len(rows_p) == len(rows_r) > 0
    for a, b in zip(rows_p, rows_r):
        fa, fb = a.split(","), b.split(",")
        assert fa[:-2] == fb[:-2]
        np.testing.assert_allclose([float(x) for x in fa[-2:]],
                                   [float(x) for x in fb[-2:]], rtol=1e-3)
