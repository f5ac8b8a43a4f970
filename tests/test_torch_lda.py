"""The port's EM trainer against the JAX package's `train_corpus`, from
the same initial beta (JAX's threefry draw, carried across through
models/convert.py) and at the same doc block: the sparse engine with
the stepwise driver (fused_em_chunk=1), and the dense engine under the
chunk driver (the JAX package forced dense with ONI_ML_TPU_ESTEP)."""

import numpy as np
import pytest
import torch

import jax
from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus, formats
from oni_ml_tpu_torch.models import convert, train_corpus
from oni_ml_tpu_torch.models.lda import (LDATrainer, init_log_beta,
                                         resolve_estep_engine)
from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import sparse_estep as tsparse
from oni_ml_tpu_torch.synth import write_flow_day
from oni_ml_tpu_torch.features import featurize_flow
from oni_ml_tpu_torch.features.lineio import iter_flow_lines

K = 5


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda") / "day.csv"
    with open(path, "w") as f:
        write_flow_day(f, 1500, n_src=50, n_dst=30, seed=9)
    triples = featurize_flow(iter_flow_lines(str(path))).word_counts()
    return Corpus.from_word_counts(triples), JCorpus.from_word_counts(triples)


@pytest.fixture()
def jax_at_port_block(monkeypatch, tmp_path):
    """The JAX sparse engine at the port's doc block (the per-block stop
    rule then makes identical decisions), with a hermetic plan cache."""
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "plans.jsonl"))
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "sparse")
    monkeypatch.setattr(
        jsparse, "pick_block",
        lambda b, l, k, precision="f32": tsparse.pick_block(b))


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "fresh"])
def test_train_corpus_matches_jax(corpora, jax_at_port_block, tmp_path, warm):
    """em_iters equal; likelihood trajectory rel 1e-5; final beta,
    gamma rel 1e-4 and alpha rel 1e-5 — float32 sums in another order
    compound over the EM iterations (each step's beta feeds the next).

    beta is compared as probabilities, rel 1e-4 above 1e-12.  Topics
    specialise, so most word-topic masses of a small day are zero or
    below float32's normal range; both packages floor those at LOG_ZERO
    (the port treats subnormals as zero, as XLA does).  What still
    differs: a mass summed from per-token contributions that are each
    below the normal range.  XLA flushes every contribution, so the sum
    is zero (LOG_ZERO); the port adds them up, and the sum can land just
    above the normal range, with a log beta near -93.  Measured: 1 of
    8,027 LOG_ZERO entries; the carve-out allows 2, where both sides
    must be below the normal range."""
    corpus, jcorpus = corpora
    common = dict(num_topics=K, em_max_iters=12, batch_size=64,
                  sparse_min_bucket_len=16, warm_start_gamma=warm, seed=0)
    jcfg = JLDAConfig(fused_em_chunk=1, estep_engine="sparse", **common)
    want = jlda.train_corpus(jcorpus, jcfg)
    assert want.plan["estep_engine"]["value"] == "sparse"
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), K,
                                         corpus.num_terms))
    out = tmp_path / "port"
    out.mkdir()
    got = train_corpus(corpus, LDAConfig(**common), out_dir=str(out),
                       initial_log_beta=init, device="cpu")
    assert got.em_iters == want.em_iters
    np.testing.assert_allclose(
        np.asarray(got.likelihoods)[:, 0], np.asarray(want.likelihoods)[:, 0],
        rtol=1e-5)
    normal = np.log(np.finfo(np.float32).tiny)      # -87.34
    differ = (want.log_beta == -100.0) != (got.log_beta == -100.0)
    assert differ.sum() <= 2
    assert (want.log_beta[differ] < normal).all()
    assert (got.log_beta[differ] < normal).all()
    np.testing.assert_allclose(np.exp(got.log_beta), np.exp(want.log_beta),
                               rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got.gamma, want.gamma, rtol=1e-4)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-5)
    for name in ("final.beta", "final.gamma", "final.other",
                 "likelihood.dat"):
        assert (out / name).exists()
    lines = (out / "likelihood.dat").read_text().splitlines()
    assert len(lines) == got.em_iters


def test_dense_train_corpus_matches_jax_forced_dense(corpora, monkeypatch,
                                                    tmp_path):
    """The dense engine (make_batches, densified W-major, the chunk
    driver with its defaults) against the JAX package forced dense, at
    the port's doc blocks: em_iters equal, the same LOG_ZERO set,
    likelihoods rel 1e-5, beta (as probabilities above 1e-12), gamma
    rel 1e-4 and alpha rel 1e-5 (measured: 2e-7, 6e-6, 6e-6, 1.4e-6) —
    float32 sums in another order over 12 EM iterations."""
    corpus, jcorpus = corpora
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "plans.jsonl"))
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "dense")
    for name in ("pick_block", "pick_block_w"):
        monkeypatch.setattr(jdense, name, lambda b, v, k, precision="f32":
                            tdense.pick_block(b, v, k))
    common = dict(num_topics=K, em_max_iters=12, batch_size=64, seed=0)
    want = jlda.train_corpus(jcorpus, JLDAConfig(**common))
    assert want.plan["estep_engine"] == {"value": "dense", "source": "env"}
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), K,
                                         corpus.num_terms))
    got = train_corpus(corpus, LDAConfig(**common), initial_log_beta=init,
                       device="cpu")
    assert got.plan["estep_engine"] == {"value": "dense", "source": "env"}
    assert got.plan["fused_em_chunk"] == {"value": 128, "source": "default"}
    assert got.stats["driver"] == "fused" and got.stats["batches"] > 1
    assert got.em_iters == want.em_iters
    np.testing.assert_allclose(
        np.asarray(got.likelihoods)[:, 0], np.asarray(want.likelihoods)[:, 0],
        rtol=1e-5)
    np.testing.assert_array_equal(got.log_beta == -100.0,
                                  want.log_beta == -100.0)
    np.testing.assert_allclose(np.exp(got.log_beta), np.exp(want.log_beta),
                               rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got.gamma, want.gamma, rtol=1e-4)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-5)


@pytest.mark.parametrize("env,cfg,want", [
    ("", "auto", ("sparse", "default")),
    ("", "dense", ("dense", "config")),
    ("dense", "sparse", ("dense", "env")),
    ("sparse", "auto", ("sparse", "env")),
])
def test_resolve_estep_engine_precedence(monkeypatch, env, cfg, want):
    """ONI_ML_TPU_ESTEP beats LDAConfig.estep_engine, which beats the
    card's default (sparse)."""
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", env)
    assert resolve_estep_engine(LDAConfig(estep_engine=cfg)) == want


def test_engine_and_plan_errors(corpora, monkeypatch):
    corpus, _ = corpora
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "compact")
    with pytest.raises(ValueError, match="ONI_ML_TPU_ESTEP='compact'"):
        resolve_estep_engine(LDAConfig())
    monkeypatch.delenv("ONI_ML_TPU_ESTEP")
    with pytest.raises(ValueError, match="estep_engine='xla'"):
        resolve_estep_engine(LDAConfig(estep_engine="xla"))
    with pytest.raises(ValueError, match="host_sync_every must be >= 0"):
        train_corpus(corpus, LDAConfig(num_topics=K, host_sync_every=-1),
                     device="cpu")
    with pytest.raises(ValueError, match="chunk driver"):
        train_corpus(corpus, LDAConfig(num_topics=K, estep_engine="dense",
                                       fused_em_chunk=1), device="cpu")


def test_convert_round_trip_and_files(tmp_path):
    rng = np.random.default_rng(0)
    lb = np.log(rng.dirichlet(np.ones(7), size=3))
    gamma = rng.uniform(0.5, 3.0, size=(4, 3))
    state = convert.from_reference(lb, 1.25, gamma)
    assert state.log_beta.dtype == torch.float32
    lb2, a2, g2 = convert.to_reference(state)
    np.testing.assert_allclose(lb2, lb.astype(np.float32))
    assert a2 == 1.25
    np.testing.assert_allclose(g2, gamma.astype(np.float32))
    # final.beta / final.other written by the JAX package load into the
    # port's state (final.beta keeps 10 decimals; float32 keeps ~1e-7).
    res = jlda.LDAResult(log_beta=lb, gamma=gamma, alpha=1.25)
    res.save(str(tmp_path))
    loaded = convert.from_reference(
        formats.read_beta(str(tmp_path / "final.beta")),
        formats.read_other(str(tmp_path / "final.other"))["alpha"],
        formats.read_gamma(str(tmp_path / "final.gamma")))
    np.testing.assert_allclose(loaded.log_beta.numpy(), lb, atol=1e-6)
    np.testing.assert_allclose(loaded.gamma.numpy(), gamma, rtol=1e-6)
    assert float(loaded.alpha) == 1.25


def test_seeded_init_is_device_independent_and_normalized():
    gen = torch.Generator().manual_seed(3)
    lb = init_log_beta(gen, 4, 50)
    np.testing.assert_allclose(torch.exp(lb).sum(1).numpy(), 1.0, rtol=1e-6)
    again = init_log_beta(torch.Generator().manual_seed(3), 4, 50)
    assert torch.equal(lb, again)


def test_trainer_rejects_wrong_initial_beta_shape(corpora):
    corpus, _ = corpora
    trainer = LDATrainer(LDAConfig(num_topics=K, em_max_iters=1),
                         corpus.num_terms, device="cpu")
    layout = corpus.bucketed_layout()
    with pytest.raises(ValueError, match="initial beta has shape"):
        trainer.fit(list(layout.batches), corpus.num_docs,
                    initial_log_beta=np.zeros((K, corpus.num_terms + 1)))
