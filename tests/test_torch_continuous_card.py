"""The continuous service's device paths on the card against their plain
CPU runs: window refits under each E-step engine (the sparse kernel and
its scatter, the dense kernel under the chunk driver, the fixed point
under ONI_ML_TPU_ESTEP=pallas), the drift detector's held-out
likelihood, and a short service run with its in-process fleet.

This file imports no JAX, so it runs on a machine with a card and no
JAX (the variable keeps tests/conftest.py from importing jax):

    ONI_ML_TPU_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_continuous_card.py

Without a CUDA device every test here skips.  Tolerances: the card's
kernels and the CPU's plain versions sum float32 in other orders, so a
refit's final likelihood agrees within rel 1e-4 and its EM iterations
within 1, a held-out likelihood within rel 1e-5, and a service run's
publish sequence is equal with held-out likelihoods within rel 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

from oni_ml_tpu_torch.config import (ContinuousConfig, LDAConfig,
                                     PipelineConfig, ServingConfig)
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.models import DriftDetector, WindowTrainer
from oni_ml_tpu_torch.runner.continuous import (ContinuousService,
                                                FleetContinuousService,
                                                IngestSlice)
from oni_ml_tpu_torch.runner.ml_ops import launch_counts, reset_kernel_counts

RTOL_LL = 1e-4
RTOL_EVAL = 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window refits run on the card")
    return torch.device("cuda")


def _corpus(seed=3, docs=300, v=400, k=4, tokens=40):
    rng = np.random.default_rng(seed)
    block = v // k
    trips = []
    for d in range(docs):
        t = d % k
        for _ in range(tokens):
            wid = (t * block + int(rng.integers(0, block))
                   if rng.random() < 0.9 else int(rng.integers(0, v)))
            trips.append((f"10.0.{d // 256}.{d % 256}", f"w{wid}", 1))
    return Corpus.from_word_counts(trips)


# (ONI_ML_TPU_ESTEP, fused_em_chunk, the kernels the card fit launches)
ENGINES = [("sparse", 1, ("sparse_estep", "sparse_scatter")),
           ("dense", 8, ("dense_estep",)),
           ("pallas", 1, ("fixed_point_estep", "sparse_scatter"))]


@pytest.mark.cuda
@pytest.mark.parametrize("env,chunk,kernels", ENGINES)
def test_cuda_window_refit_matches_cpu(cuda, monkeypatch, env, chunk,
                                       kernels):
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", env)
    corpus = _corpus()
    cfg = LDAConfig(num_topics=4, batch_size=64, min_bucket_len=64,
                    fused_em_chunk=chunk, host_sync_every=chunk,
                    em_max_iters=30)
    fits = {}
    for dev in ("cpu", cuda):
        tr = WindowTrainer(cfg, corpus.num_terms, device=dev)
        reset_kernel_counts()
        fresh = tr.fit(corpus)
        probs = np.exp(fresh.log_beta).T
        warm = tr.fit(corpus, topic_probs=probs, alpha=fresh.alpha)
        fits[str(dev)] = (fresh, warm, launch_counts())
    for i in (0, 1):
        got, ref = fits["cuda"][i], fits["cpu"][i]
        assert abs(got.em_iters - ref.em_iters) <= 1
        np.testing.assert_allclose(got.likelihoods[-1][0],
                                   ref.likelihoods[-1][0], rtol=RTOL_LL)
    launched = fits["cuda"][2]
    assert all(launched[k] > 0 for k in kernels), launched
    assert fits["cuda"][1].em_iters < fits["cuda"][0].em_iters


@pytest.mark.cuda
def test_cuda_drift_evaluate_matches_cpu(cuda):
    corpus = _corpus(seed=5)
    rng = np.random.default_rng(2)
    log_beta = np.log(rng.dirichlet(np.ones(corpus.num_terms), size=4))
    kw = dict(holdout_frac=0.2, batch_size=64, min_bucket_len=64)
    got = DriftDetector().evaluate(log_beta, 0.8, corpus, device=cuda, **kw)
    ref = DriftDetector().evaluate(log_beta, 0.8, corpus, device="cpu", **kw)
    assert got[1] == ref[1]
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL_EVAL)


def _flow_slices(seed, n_slices=7, n=400, t_base=0.0):
    rng = np.random.default_rng(seed)
    out = []
    for idx in range(n_slices):
        lines = []
        for _ in range(n):
            lines.append(
                "2016-01-22 00:00:00,2016,1,22,"
                f"{int(rng.integers(0, 24))},{int(rng.integers(0, 60))},"
                f"{int(rng.integers(0, 60))},0.0,"
                f"10.0.0.{int(rng.integers(0, 48))},"
                f"10.1.0.{int(rng.integers(0, 24))},"
                f"{int(rng.integers(1024, 60000))},"
                f"{(80, 443, 22, 53)[int(rng.integers(0, 4))]},TCP,,0,0,"
                f"{int(rng.integers(1, 100))},"
                f"{int(rng.integers(40, 100000))},0,0,0,0,0,0,0,0,0")
        out.append(IngestSlice(lines=lines, t0=t_base + idx * 600.0,
                               t1=t_base + (idx + 1) * 600.0, index=idx))
    return out


def _config(tmp_path):
    config = PipelineConfig(
        data_dir=str(tmp_path),
        continuous=ContinuousConfig(
            window_s=1800.0, refresh_every_s=1200.0, min_refresh_docs=8,
            vocab_floor=512, batch_size=64, holdout_frac=0.3),
        serving=ServingConfig(fleet_max_batch=256, fleet_max_wait_ms=5.0,
                              device_score_min=None))
    return dataclasses.replace(
        config, lda=dataclasses.replace(config.lda, num_topics=4,
                                        em_max_iters=30))


@pytest.mark.cuda
def test_cuda_service_run_matches_cpu(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "sparse")
    runs = {}
    for dev in ("cpu", "cuda"):
        svc = ContinuousService(_config(tmp_path / dev), "flow",
                                out_dir=str(tmp_path / dev / "cont"),
                                warmup_refreshes=2, device=dev)
        reset_kernel_counts()
        payload = svc.run(_flow_slices(9))
        runs[dev] = (payload, launch_counts(), svc)
    seq = {dev: [(r["mode"], r["published"], r["drifted"], r["version"])
                 for r in runs[dev][0]["refresh_records"]] for dev in runs}
    assert seq["cuda"] == seq["cpu"] and len(seq["cuda"]) >= 3
    np.testing.assert_allclose(
        [r["held_out_ll"] for r in runs["cuda"][0]["refresh_records"]],
        [r["held_out_ll"] for r in runs["cpu"][0]["refresh_records"]],
        rtol=RTOL_LL)
    payload, launched, svc = runs["cuda"]
    assert launched["sparse_estep"] > 0 and launched["sparse_scatter"] > 0
    assert payload["retraces_after_warmup"] == 0
    assert svc.events_scored == svc.events_offered
    assert svc.score_failures == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cosched", [True, False])
def test_cuda_fleet_two_tenants(cuda, tmp_path, cosched):
    fleet = FleetContinuousService(
        _config(tmp_path), {"a": "flow", "b": "flow"},
        out_dir=str(tmp_path / "fleet"), coscheduler=cosched,
        warmup_refreshes=2, device=cuda)
    sa, sb = _flow_slices(1), _flow_slices(2)
    try:
        for x, y in zip(sa, sb):
            fleet.ingest("a", x)
            fleet.ingest("b", y)
    finally:
        payload = fleet.close()
    assert payload["refresh_errors"] == 0
    assert payload["publishes"] >= 2
    for svc in fleet.services.values():
        assert svc.events_scored == svc.events_offered
        assert svc.score_failures == 0
