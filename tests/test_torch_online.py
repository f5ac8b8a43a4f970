"""The port's online SVI trainer (models/online_lda.py) against the JAX
package's, on the CPU, from the same initial lambda (the JAX trainer's
threefry draw, carried across as `initial_lam`): step() and step_many()
trajectories, the dense micro-batch E-step, train_corpus_online's files
and the runner's --online day; then the port's own semantics — stream
checkpoints (the legacy layout and its refusal of a batch checkpoint),
resume, chunked checkpoints, validation.

Tolerances: both trainers run float32 E-steps whose fixed point stops at
var_tol, summed in another order, fed back through every later step.
Measured over 12 steps (step() and step_many): likelihood 3.3e-7
relative, lambda 2.6e-5 (entries 0.09-350); the bounds are 1e-5
(likelihood) and 2e-4 relative + 1e-4 absolute (lambda).  The
schedules' rho: step() evaluates it in float64 on the host on both
sides (equal), step_many in float32 on the device (1e-6 of the
host's)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_lda as ref
from oni_ml_tpu.config import OnlineLDAConfig as JOnlineLDAConfig
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.io import make_batches as jmake_batches
from oni_ml_tpu.models import OnlineLDATrainer as JTrainer
from oni_ml_tpu.models import train_corpus_online as jtrain_online
from oni_ml_tpu.models.online_lda import (
    load_stream_checkpoint as jload_stream_checkpoint)
from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu_torch.config import OnlineLDAConfig
from oni_ml_tpu_torch.io import Batch, Corpus, formats, make_batches
from oni_ml_tpu_torch.models import online_lda
from oni_ml_tpu_torch.models.online_lda import (OnlineLDATrainer,
                                                load_stream_checkpoint,
                                                train_corpus_online)
from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import estep as testep

CPU = "cpu"
RTOL_LL = 1e-5
RTOL_LAM, ATOL_LAM = 2e-4, 1e-4


def _corpora(num_docs=96, num_terms=30, seed=9):
    """(port Corpus, JAX Corpus) of one synthetic corpus, ids = words."""
    docs, _ = ref.make_synthetic_corpus(num_docs=num_docs,
                                        num_terms=num_terms, num_topics=3,
                                        seed=seed)
    ptr, widx, cnts = [0], [], []
    for words, counts in docs:
        widx.extend(words.tolist())
        cnts.extend(counts.tolist())
        ptr.append(len(widx))
    args = ([f"ip{d}" for d in range(len(docs))],
            [f"w{i}" for i in range(num_terms)],
            np.asarray(ptr, np.int64), np.asarray(widx, np.int32),
            np.asarray(cnts, np.int32))
    return Corpus(*args), JCorpus(*args)


def _jax_lam(cfg, num_terms):
    """The JAX trainer's initial lambda for cfg.seed."""
    return np.array(jax.random.gamma(
        jax.random.PRNGKey(cfg.seed), 100.0, (cfg.num_topics, num_terms),
        jnp.float32) / 100.0)


def _pair(cfg_kw, corpus, **port_kw):
    """(JAX trainer, port trainer) from the JAX trainer's initial lambda."""
    jtr = JTrainer(JOnlineLDAConfig(**cfg_kw), num_terms=corpus.num_terms,
                   total_docs=corpus.num_docs)
    init = np.array(jtr.lam)
    ptr = OnlineLDATrainer(OnlineLDAConfig(**cfg_kw),
                           num_terms=corpus.num_terms,
                           total_docs=corpus.num_docs, initial_lam=init,
                           device=CPU, **port_kw)
    return jtr, ptr


def _lam(tr):
    return np.asarray(tr.lam.cpu() if isinstance(tr.lam, torch.Tensor)
                      else tr.lam)


CFG = dict(num_topics=4, batch_size=16, min_bucket_len=64, tau0=8.0, seed=2)


def test_initial_lam_is_the_jax_draw():
    """The JAX trainer's init is Gamma(100, 1/100) from PRNGKey(seed)
    (_jax_lam); the port's own init is the same law from a torch
    Generator (a seed gives one lambda on every device)."""
    cfg = JOnlineLDAConfig(**CFG)
    np.testing.assert_array_equal(np.asarray(JTrainer(cfg, 30, 10).lam),
                                  _jax_lam(cfg, 30))
    own = OnlineLDATrainer(OnlineLDAConfig(**CFG), 30, 10, device=CPU)
    again = online_lda.seeded_lam(OnlineLDAConfig(**CFG), 30)
    np.testing.assert_array_equal(_lam(own), again.numpy())
    assert own.lam.dtype == torch.float32 and (_lam(own) > 0).all()
    assert abs(float(_lam(own).mean()) - 1.0) < 0.02


def test_step_matches_jax():
    """step() per micro-batch: the same rho (float64 on both hosts), the
    per-step likelihood and lambda within the stated tolerance."""
    pc, jc = _corpora()
    jtr, ptr = _pair(CFG, pc)
    pb = make_batches(pc, 16, 64)
    jb = jmake_batches(jc, 16, 64)
    order = np.random.default_rng(0).permutation(len(pb)).tolist() * 2
    for i in order:
        ji, pi = jtr.step(jb[i]), ptr.step(pb[i])
        assert pi.rho == ji.rho and pi.step == ji.step
        assert (pi.batch_docs, pi.tokens) == (ji.batch_docs, ji.tokens)
        np.testing.assert_allclose(float(pi.likelihood),
                                   float(ji.likelihood), rtol=RTOL_LL)
        assert isinstance(pi.likelihood, torch.Tensor)
    np.testing.assert_allclose(_lam(ptr), _lam(jtr), rtol=RTOL_LAM,
                               atol=ATOL_LAM)
    np.testing.assert_allclose(np.exp(ptr.log_beta()),
                               np.exp(jtr.log_beta()), rtol=1e-4, atol=1e-7)


def test_step_many_matches_jax_step_many():
    """step_many's device schedule (rho in float32 from a float32 step
    counter) against the JAX scan: the same chunking into power-of-two
    runs, likelihoods and lambda within the tolerance."""
    pc, jc = _corpora()
    jtr, ptr = _pair(CFG, pc)
    stream_p = (list(make_batches(pc, 16, 64)) * 3)[:12]
    stream_j = (list(jmake_batches(jc, 16, 64)) * 3)[:12]
    pinfos = ptr.step_many(stream_p, chunk=4)
    jinfos = jtr.step_many(stream_j, chunk=4)
    assert [i.step for i in pinfos] == [i.step for i in jinfos] == \
        list(range(1, 13))
    assert [i.rho for i in pinfos] == [i.rho for i in jinfos]
    np.testing.assert_allclose([float(i.likelihood) for i in pinfos],
                               [float(i.likelihood) for i in jinfos],
                               rtol=RTOL_LL)
    np.testing.assert_allclose(_lam(ptr), _lam(jtr), rtol=RTOL_LAM,
                               atol=ATOL_LAM)


def _mixed_stream():
    v, b = 25, 8

    def mk(l, seed):
        r = np.random.default_rng(seed)
        return Batch(word_idx=r.integers(0, v, size=(b, l)).astype(np.int32),
                     counts=r.integers(1, 4, size=(b, l)).astype(np.float32),
                     doc_index=np.arange(b, dtype=np.int32),
                     doc_mask=np.ones((b,), np.float32))

    return v, ([mk(16, i) for i in range(5)]
               + [mk(32, 10 + i) for i in range(2)]
               + [mk(16, 20 + i) for i in range(2)])


@pytest.mark.parametrize("stream", ["same_shape", "mixed_shapes"])
def test_step_many_matches_sequential_steps(stream):
    """step_many is step() applied in order (a 5-batch run = 4 + one
    step; shape changes split runs), up to the float32 rho schedule."""
    if stream == "same_shape":
        pc, _ = _corpora()
        v, batches = pc.num_terms, (list(make_batches(pc, 16, 64)) * 3)[:12]
    else:
        v, batches = _mixed_stream()
    cfg = OnlineLDAConfig(num_topics=3, batch_size=16, tau0=8.0, seed=3)
    seq = OnlineLDATrainer(cfg, v, 64, device=CPU)
    for b in batches:
        seq.step(b)
    chunked = OnlineLDATrainer(cfg, v, 64, device=CPU)
    infos = chunked.step_many(batches, chunk=4)
    assert chunked.step_count == seq.step_count == len(batches)
    np.testing.assert_allclose([i.rho for i in infos],
                               [h.rho for h in seq.history], rtol=1e-6)
    np.testing.assert_allclose([float(i.likelihood) for i in infos],
                               [float(h.likelihood) for h in seq.history],
                               rtol=RTOL_LL)
    np.testing.assert_allclose(_lam(chunked), _lam(seq), rtol=RTOL_LAM,
                               atol=ATOL_LAM)


def test_dense_micro_batches_match_jax_dense(monkeypatch):
    """dense_em="on": the port's dense E-step (its plain version on the
    CPU, W-major) against the JAX dense kernel in interpret mode at the
    port's doc block; and against the port's own per-batch path."""
    for name in ("pick_block", "pick_block_w"):
        monkeypatch.setattr(jdense, name, lambda b, v, k, precision="f32":
                            tdense.pick_block(b, v, k))
    pc, jc = _corpora(num_docs=48, num_terms=40, seed=5)
    cfg = dict(num_topics=4, batch_size=16, min_bucket_len=64, seed=3,
               dense_em="on")
    jtr, ptr = _pair(cfg, pc)
    off = OnlineLDATrainer(OnlineLDAConfig(**{**cfg, "dense_em": "off"}),
                           pc.num_terms, pc.num_docs,
                           initial_lam=_lam(ptr), device=CPU)
    assert ptr.member(16, 64) == "dense"
    assert off.member(16, 64) == "per_batch:xla"
    for pb, jb in zip(make_batches(pc, 16, 64), jmake_batches(jc, 16, 64)):
        pi, ji = ptr.step(pb), jtr.step(jb)
        off.step(pb)
        np.testing.assert_allclose(float(pi.likelihood),
                                   float(ji.likelihood), rtol=RTOL_LL)
    np.testing.assert_allclose(_lam(ptr), _lam(jtr), rtol=RTOL_LAM,
                               atol=ATOL_LAM)
    np.testing.assert_allclose(_lam(ptr), _lam(off), rtol=2e-3, atol=2e-3)


def test_train_corpus_online_files_match_jax(tmp_path):
    """train_corpus_online over two epochs (the seeded permutation sorted
    by shape, the same on both sides) from the JAX draw: final.beta,
    final.gamma, final.other and likelihood.dat within the tolerance,
    gamma over every document."""
    pc, jc = _corpora(num_docs=40, num_terms=25, seed=3)
    cfg = dict(num_topics=3, batch_size=16, min_bucket_len=32, seed=4)
    jout, pout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir(), pout.mkdir()
    jres = jtrain_online(jc, JOnlineLDAConfig(**cfg), out_dir=str(jout),
                         epochs=2)
    pres = train_corpus_online(
        pc, OnlineLDAConfig(**cfg), out_dir=str(pout), epochs=2,
        initial_lam=_jax_lam(JOnlineLDAConfig(**cfg), pc.num_terms),
        device=CPU)
    assert pres.em_iters == jres.em_iters
    assert pres.stats["member"] == "per_batch:xla"
    np.testing.assert_allclose(
        np.exp(formats.read_beta(str(pout / "final.beta"))),
        np.exp(formats.read_beta(str(jout / "final.beta"))),
        rtol=1e-4, atol=1e-7)
    gp = formats.read_gamma(str(pout / "final.gamma"))
    assert gp.shape == (pc.num_docs, 3) and (gp > 0).all()
    np.testing.assert_allclose(gp, formats.read_gamma(
        str(jout / "final.gamma")), rtol=1e-4)
    assert formats.read_other(str(pout / "final.other")) == \
        formats.read_other(str(jout / "final.other"))
    lp = formats.read_likelihood(str(pout / "likelihood.dat"))
    lj = formats.read_likelihood(str(jout / "likelihood.dat"))
    assert lp.shape == lj.shape and lp[0, 1] == 1.0
    np.testing.assert_allclose(lp[:, 0], lj[:, 0], rtol=RTOL_LL)


def test_runner_online_day_matches_jax(tmp_path, monkeypatch):
    """`ml_ops --online` on the golden flow day, the port's init replaced
    by the JAX draw: the model files within the tolerance of the JAX
    runner's --online day; the lda record names the online member and
    the journal streams one em_ll record (with rho) per micro-batch; the
    --no-dataplane day writes the same bytes."""
    from oni_ml_tpu.config import PipelineConfig as JPipelineConfig
    from oni_ml_tpu.config import ScoringConfig as JScoringConfig
    from oni_ml_tpu.runner import ml_ops as jml_ops
    from oni_ml_tpu_torch.config import (DataplaneConfig, PipelineConfig,
                                         ScoringConfig)
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.telemetry import Journal

    golden = os.path.join(os.path.dirname(__file__), "golden", "inputs",
                          "flow.csv")
    jml_ops.run_pipeline(JPipelineConfig(
        data_dir=str(tmp_path / "jax"), flow_path=golden,
        scoring=JScoringConfig(threshold=1.1)), "20160122", "flow",
        online=True)
    monkeypatch.setattr(online_lda, "seeded_lam", lambda cfg, v:
                        torch.as_tensor(_jax_lam(cfg, v)))
    runs = {}
    for label, dp in (("plane", {}), ("serial", {"enabled": False})):
        runs[label] = ml_ops.run_pipeline(PipelineConfig(
            data_dir=str(tmp_path / label), flow_path=golden,
            scoring=ScoringConfig(threshold=1.1),
            dataplane=DataplaneConfig(**dp)), "20160122", "flow",
            device=CPU, online=True, emit=lambda *a, **k: None)
    jday, day = tmp_path / "jax" / "20160122", tmp_path / "plane" / "20160122"
    np.testing.assert_allclose(
        np.exp(formats.read_beta(str(day / "final.beta"))),
        np.exp(formats.read_beta(str(jday / "final.beta"))),
        rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(formats.read_gamma(str(day / "final.gamma")),
                               formats.read_gamma(str(jday / "final.gamma")),
                               rtol=1e-4)
    for name in ("words.dat", "doc.dat", "model.dat", "final.other"):
        assert (day / name).read_bytes() == (jday / name).read_bytes(), name
    lda = {r["stage"]: r for r in runs["plane"].records}["lda"]
    assert (lda["engine"], lda["member"], lda["driver"]) == (
        "online", "per_batch:xla", "online")
    assert lda["em_iters"] == lda["batches"] == 1
    ems = [r for r in Journal.replay(str(day / "run_journal.jsonl"))
           if r["kind"] == "em_ll"]
    assert [r["iter"] for r in ems] == [1] and 0 < ems[0]["rho"] <= 1
    for name in ml_ops.artifacts("flow"):
        if name != "features.pkl":
            assert (day / name).read_bytes() == (
                tmp_path / "serial" / "20160122" / name).read_bytes(), name


# ---------------------------------------------------------------------------
# Stream checkpoints, resume, validation
# ---------------------------------------------------------------------------


def test_stream_checkpoint_roundtrip_and_resume(tmp_path):
    """The checkpoint holds lam/step/history; a fresh trainer resumes
    from it bit for bit (the checkpoint wins over initial_lam)."""
    pc, _ = _corpora(num_docs=60, num_terms=25, seed=12)
    ck = str(tmp_path / "stream.npz")
    cfg = OnlineLDAConfig(num_topics=3, batch_size=16, min_bucket_len=64,
                          checkpoint_every=2, seed=5)
    tr = OnlineLDATrainer(cfg, 25, pc.num_docs, checkpoint_path=ck,
                          device=CPU)
    for b in make_batches(pc, 16, 64):
        tr.step(b)
    z = load_stream_checkpoint(ck)
    assert set(z) == {"lam", "alpha", "step", "history"}
    assert z["step"] % 2 == 0 and z["step"] > 0
    assert all(0 < rho <= 1 for _, rho in z["history"])
    jz = jload_stream_checkpoint(ck)   # the JAX package reads it alike
    np.testing.assert_array_equal(jz["lam"], z["lam"])
    assert (jz["step"], jz["history"]) == (z["step"], z["history"])
    resumed = OnlineLDATrainer(cfg, 25, pc.num_docs, checkpoint_path=ck,
                               initial_lam=np.ones((3, 25)), device=CPU)
    assert resumed.step_count == z["step"]
    np.testing.assert_array_equal(_lam(resumed), z["lam"])
    assert [h.rho for h in resumed.history] == [r for _, r in z["history"]]


def test_stream_checkpoint_reads_legacy_layout(tmp_path):
    """Checkpoints of the old layout (batch-checkpoint field names holding
    lambda) load; a genuine batch EM checkpoint (log-probabilities) is
    refused."""
    lam = np.random.default_rng(0).gamma(100.0, 0.01, (3, 25))
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, log_beta=lam, alpha=np.float64(2.5),
             em_iter=np.int64(7),
             likelihoods=np.array([[-100.0, 0.5], [-90.0, 0.4]]))
    z = load_stream_checkpoint(legacy)
    assert z["step"] == 7 and z["alpha"] == 2.5
    np.testing.assert_array_equal(z["lam"], lam)
    assert z["history"] == [(-100.0, 0.5), (-90.0, 0.4)]
    tr = OnlineLDATrainer(OnlineLDAConfig(num_topics=3, batch_size=16),
                          num_terms=25, total_docs=10,
                          checkpoint_path=legacy, device=CPU)
    assert tr.step_count == 7 and len(tr.history) == 2
    batch_ck = str(tmp_path / "batch.npz")
    np.savez(batch_ck, log_beta=np.log(lam / lam.sum(-1, keepdims=True)),
             alpha=np.float64(2.5), em_iter=np.int64(3),
             likelihoods=np.array([[-50.0, 1.0]]))
    with pytest.raises(ValueError, match="batch EM checkpoint"):
        load_stream_checkpoint(batch_ck)


def test_online_checkpoint_resume(tmp_path):
    """A stream cut after 2 steps and resumed by train_corpus_online
    fast-forwards past them and ends where the uninterrupted stream ends;
    the checkpoint is removed and likelihood.dat's second column is the
    relative change, not the learning rate."""
    pc, _ = _corpora(num_docs=30, num_terms=25, seed=13)
    cfg = OnlineLDAConfig(num_topics=3, batch_size=16, min_bucket_len=32,
                          tau0=8.0, seed=4, checkpoint_every=1)
    batches = make_batches(pc, 16, 32, pad_multiple=8)
    order = sorted(np.random.default_rng(cfg.seed).permutation(len(batches)),
                   key=lambda i: batches[i].word_idx.shape)
    full = OnlineLDATrainer(cfg, 25, pc.num_docs, device=CPU)
    for i in order:
        full.step(batches[i])
    out = tmp_path / "out"
    out.mkdir()
    part = OnlineLDATrainer(cfg, 25, pc.num_docs,
                            checkpoint_path=str(out / "checkpoint.npz"),
                            device=CPU)
    for i in order[:1]:
        part.step(batches[i])
    assert (out / "checkpoint.npz").exists()
    result = train_corpus_online(pc, cfg, out_dir=str(out), device=CPU)
    np.testing.assert_allclose(np.exp(result.log_beta),
                               np.exp(full.log_beta()), rtol=1e-5,
                               atol=1e-7)
    assert not (out / "checkpoint.npz").exists()
    ll = formats.read_likelihood(str(out / "likelihood.dat"))
    assert ll[0, 1] == 1.0 and (ll[:, 1] >= 0).all()


def test_chunked_checkpoint_lands_after_boundary(tmp_path):
    """A checkpoint_every boundary crossed inside a step_many run is
    checkpointed at the run's end (its one materialized lambda)."""
    pc, _ = _corpora(num_docs=64, num_terms=20, seed=8)
    cfg = OnlineLDAConfig(num_topics=3, batch_size=16, min_bucket_len=64,
                          tau0=8.0, seed=7, checkpoint_every=3)
    path = str(tmp_path / "stream.npz")
    tr = OnlineLDATrainer(cfg, 20, pc.num_docs, checkpoint_path=path,
                          device=CPU)
    tr.step_many((list(make_batches(pc, 16, 64)) * 2)[:4], chunk=4)
    ck = load_stream_checkpoint(path)
    assert ck["step"] == 4
    np.testing.assert_allclose(ck["lam"], _lam(tr))


def test_validation():
    with pytest.raises(ValueError, match="dense_em"):
        OnlineLDATrainer(OnlineLDAConfig(num_topics=4, dense_em="dense"),
                         num_terms=50, total_docs=10, device=CPU)
    with pytest.raises(ValueError, match="Queue 2 item 7"):
        OnlineLDATrainer(OnlineLDAConfig(compute_dtype="bfloat16"),
                         num_terms=50, total_docs=10, device=CPU)
    with pytest.raises(ValueError, match="exceeds the dense kernel"):
        OnlineLDATrainer(OnlineLDAConfig(num_topics=40, dense_em="on"),
                         num_terms=50, total_docs=10,
                         device=CPU).member(8, 16)
    with pytest.raises(ValueError, match="shape"):
        OnlineLDATrainer(OnlineLDAConfig(num_topics=4), num_terms=50,
                         total_docs=10, initial_lam=np.ones((4, 49)),
                         device=CPU)
