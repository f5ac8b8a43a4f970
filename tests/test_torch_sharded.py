"""The port's sharded E/M steps and mesh training (parallel/sharded.py,
train_corpus(mesh=, vocab_sharded=)) against the JAX package's, case for
case with tests/test_sharded.py, on the CPU: the JAX side on the suite's
8 virtual CPU devices (the dense Pallas kernel in interpret mode, as its
own tests run it), the port on 8 CPU slots of one mesh.

Two comparisons per case, each with its tolerance:
- port mesh against port unmeshed (or 1x1): the JAX test's own bounds
  (tests/test_sharded.py), which its sharded plans meet against its
  single device: E-steps gamma rtol/atol 1e-5, suff-stats rtol 1e-4 /
  atol 1e-5, likelihood and alpha_ss rtol 1e-5; 5-iteration fits
  likelihood rtol 1e-4, beta (probabilities) atol 1e-4, gamma rtol/atol
  1e-3, alpha rtol 1e-4; the (1, 1) dense mesh gamma rtol/atol 1e-6,
  suff-stats rtol 1e-5 / atol 1e-6, likelihood rtol 1e-6.
- port mesh against JAX mesh: the bounds the port's unmeshed tests hold
  it to against the JAX package (tests/test_torch_estep.py: E-step
  gamma, likelihood and alpha_ss rtol 1e-5, suff-stats rtol 1e-5 with
  an absolute floor of 1e-6 for the near-zero masses; the fits
  tests/test_torch_pipeline.py's: likelihood 2e-5, gamma and alpha
  2e-4, beta 2e-3 relative above 1e-12), from the JAX initial beta."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_lda as ref
from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu import parallel as jpar
from oni_ml_tpu.parallel import sharded as jsharded
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus, make_batches
from oni_ml_tpu_torch.models import train_corpus
from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import estep as testep
from oni_ml_tpu_torch import parallel as tpar

CPU = "cpu"
K, V = 4, 37
FIT = dict(num_topics=K, em_max_iters=5, em_tol=0.0, batch_size=64,
           min_bucket_len=64, estimate_alpha=True, seed=9)


def _corpora(docs, num_terms):
    ptr, widx, cnts = [0], [], []
    for words, counts in docs:
        widx.extend(words.tolist())
        cnts.extend(counts.tolist())
        ptr.append(len(widx))
    kw = dict(doc_names=[f"ip{d}" for d in range(len(docs))],
              vocab=[f"w{i}" for i in range(num_terms)],
              doc_ptr=np.asarray(ptr, np.int64),
              word_idx=np.asarray(widx, np.int32),
              counts=np.asarray(cnts, np.int32))
    return Corpus(**kw), JCorpus(**kw)


@pytest.fixture(scope="module")
def problem():
    docs, _ = ref.make_synthetic_corpus(num_docs=48, num_terms=V,
                                        num_topics=3, seed=11)
    corpus, jcorpus = _corpora(docs, V)
    rng = np.random.default_rng(5)
    noise = rng.uniform(size=(K, V)) + 1 / V
    log_beta = np.log(noise / noise.sum(-1, keepdims=True))
    return corpus, jcorpus, log_beta


def _batch(corpus):
    batches = make_batches(corpus, batch_size=64, min_bucket_len=64)
    assert len(batches) == 1
    return batches[0]


def _targs(log_beta, b):
    return (torch.tensor(log_beta, dtype=torch.float32), torch.tensor(2.5),
            torch.as_tensor(b.word_idx),
            torch.as_tensor(b.counts, dtype=torch.float32),
            torch.as_tensor(b.doc_mask, dtype=torch.float32))


def _jargs(log_beta, b):
    return (jnp.asarray(log_beta, jnp.float32), jnp.float32(2.5),
            jnp.asarray(b.word_idx), jnp.asarray(b.counts),
            jnp.asarray(b.doc_mask))


def _close_estep(got, want, g=(1e-5, 1e-5), ss=(1e-4, 1e-5), ll=1e-5,
                 ass=1e-5):
    np.testing.assert_allclose(np.asarray(got.gamma), np.asarray(want.gamma),
                               rtol=g[0], atol=g[1])
    np.testing.assert_allclose(np.asarray(got.suff_stats),
                               np.asarray(want.suff_stats), rtol=ss[0],
                               atol=ss[1])
    np.testing.assert_allclose(float(got.likelihood), float(want.likelihood),
                               rtol=ll)
    np.testing.assert_allclose(float(got.alpha_ss), float(want.alpha_ss),
                               rtol=ass)


# The port against the JAX package on the same inputs.
JAX_TOL = dict(g=(1e-5, 0), ss=(1e-5, 1e-6), ll=1e-5, ass=1e-5)


def test_cpu_mesh_binds_every_slot_to_the_cpu():
    """The port's counterpart of the JAX suite's 8 virtual devices: a
    CPU mesh of 8 slots, each bound to the one CPU device."""
    assert len(jax.devices()) == 8, jax.devices()
    mesh = tpar.make_mesh(data=8, model=1, device=CPU)
    assert mesh.shape == {"data": 8, "model": 1}
    assert [d.type for d in mesh.devices.flat] == [CPU] * 8


def test_data_parallel_e_step_parity(problem):
    corpus, jcorpus, log_beta = problem
    b = _batch(corpus)
    args = _targs(log_beta, b)
    single = testep.e_step(*args, var_max_iters=30, var_tol=1e-7)
    fn = tpar.make_data_parallel_e_step(tpar.make_mesh(8, 1, device=CPU))
    sharded = fn(*args, var_max_iters=30, var_tol=1e-7)
    _close_estep(sharded, single)
    jfn = jpar.make_data_parallel_e_step(jpar.make_mesh(data=8, model=1))
    want = jax.jit(lambda *a: jfn(*a, var_max_iters=30, var_tol=1e-7))(
        *_jargs(log_beta, _batch(jcorpus)))
    _close_estep(sharded, want, **JAX_TOL)


def test_vocab_sharded_e_step_parity(problem):
    corpus, jcorpus, log_beta = problem
    v_pad = tpar.pad_vocab(V, 4)
    assert v_pad == jpar.pad_vocab(V, 4)
    lb_pad = np.pad(log_beta, ((0, 0), (0, v_pad - V)),
                    constant_values=testep.LOG_ZERO)
    b = _batch(corpus)
    args = _targs(lb_pad, b)
    single = testep.e_step(*args, var_max_iters=30, var_tol=1e-7)
    e_fn, m_fn = tpar.make_vocab_sharded_fns(tpar.make_mesh(2, 4, device=CPU))
    sharded = e_fn(*args, var_max_iters=30, var_tol=1e-7)
    _close_estep(sharded, single)
    # The sharded M-step matches the dense one.
    np.testing.assert_allclose(m_fn(sharded.suff_stats).numpy(),
                               testep.m_step(single.suff_stats).numpy(),
                               rtol=1e-4, atol=1e-4)
    je, jm = jpar.make_vocab_sharded_fns(jpar.make_mesh(data=2, model=4))
    want = jax.jit(lambda *a: je(*a, var_max_iters=30, var_tol=1e-7))(
        *_jargs(lb_pad, _batch(jcorpus)))
    _close_estep(sharded, want, **JAX_TOL)
    np.testing.assert_allclose(m_fn(sharded.suff_stats).numpy(),
                               np.asarray(jax.jit(jm)(want.suff_stats)),
                               rtol=1e-5, atol=1e-5)


def _close_fit(multi, single, ll=1e-4, beta=1e-4, gamma=1e-3, alpha=1e-4):
    np.testing.assert_allclose([l for l, _ in multi.likelihoods],
                               [l for l, _ in single.likelihoods], rtol=ll)
    np.testing.assert_allclose(np.exp(multi.log_beta),
                               np.exp(single.log_beta), atol=beta)
    np.testing.assert_allclose(multi.gamma, single.gamma, rtol=gamma,
                               atol=gamma)
    np.testing.assert_allclose(multi.alpha, single.alpha, rtol=alpha)


def _close_to_jax(got, want):
    """tests/test_torch_pipeline.py's bounds for a fit against JAX."""
    np.testing.assert_allclose([l for l, _ in got.likelihoods],
                               [l for l, _ in want.likelihoods], rtol=2e-5)
    np.testing.assert_allclose(np.exp(got.log_beta), np.exp(want.log_beta),
                               rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(got.gamma, want.gamma, rtol=2e-4)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=2e-4)


def _jinit():
    return np.asarray(jlda.init_log_beta(jax.random.PRNGKey(FIT["seed"]), K,
                                         V))


@pytest.mark.parametrize("mesh_shape,vocab_sharded", [
    ((8, 1), False),
    ((2, 4), True),
])
def test_full_training_parity(problem, mesh_shape, vocab_sharded):
    corpus, jcorpus, _ = problem
    cfg = LDAConfig(**FIT)
    single = train_corpus(corpus, cfg, device=CPU)
    mesh = tpar.make_mesh(*mesh_shape, device=CPU)
    multi = train_corpus(corpus, cfg, mesh=mesh, vocab_sharded=vocab_sharded)
    assert multi.log_beta.shape == (K, V)          # trimmed back to V
    assert multi.stats["mesh"]["shape"] == list(mesh_shape)
    assert multi.stats["member"] == ("vocab_sparse" if vocab_sharded
                                     else "per_batch:xla")
    _close_fit(multi, single)
    want = jlda.train_corpus(
        jcorpus, JLDAConfig(**FIT),
        mesh=jpar.make_mesh(data=mesh_shape[0], model=mesh_shape[1]),
        vocab_sharded=vocab_sharded)
    got = train_corpus(corpus, cfg, mesh=mesh, vocab_sharded=vocab_sharded,
                       initial_log_beta=_jinit())
    _close_to_jax(got, want)


def test_full_training_parity_vocab_sharded_dense(problem):
    """The config-4 dense plan: train_corpus with vocab_sharded=True and
    dense_em='on' routes through make_vocab_sharded_dense_e_step and
    reproduces the single-slot trajectory (fresh start pinned, as in the
    JAX test)."""
    corpus, jcorpus, _ = problem
    cfg = LDAConfig(**FIT, warm_start_gamma=False)
    single = train_corpus(corpus, cfg, device=CPU)
    mesh = tpar.make_mesh(2, 4, device=CPU)
    dense_cfg = dataclasses.replace(cfg, dense_em="on")
    multi = train_corpus(corpus, dense_cfg, mesh=mesh, vocab_sharded=True)
    assert multi.stats["member"] == "vocab_dense"
    _close_fit(multi, single)
    want = jlda.train_corpus(
        jcorpus, JLDAConfig(**FIT, warm_start_gamma=False, dense_em="on"),
        mesh=jpar.make_mesh(data=2, model=4), vocab_sharded=True)
    got = train_corpus(corpus, dense_cfg, mesh=mesh, vocab_sharded=True,
                       initial_log_beta=_jinit())
    _close_to_jax(got, want)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (4, 2)])
def test_vocab_sharded_DENSE_e_step_parity(problem, mesh_shape):
    """The dense E-step with the vocabulary sharded over `model` against
    the unsharded dense E-step: gamma, suff-stats, likelihood, and the
    warm-start path; and against the JAX plan."""
    corpus, jcorpus, log_beta = problem
    d, m = mesh_shape
    b = _batch(corpus)
    dense = tdense.densify(torch.as_tensor(b.word_idx),
                           torch.as_tensor(b.counts, dtype=torch.float32), V)
    w = dense.shape[1]
    assert w % m == 0
    lb_pad = np.pad(log_beta, ((0, 0), (0, w - V)),
                    constant_values=testep.LOG_ZERO)
    lb = torch.tensor(lb_pad, dtype=torch.float32)
    mask = torch.as_tensor(b.doc_mask, dtype=torch.float32)
    kw = dict(var_max_iters=30, var_tol=1e-7)
    single = tdense.e_step_dense(lb, torch.tensor(2.5), dense, mask, **kw)
    fn = tpar.make_vocab_sharded_dense_e_step(tpar.make_mesh(d, m, device=CPU))
    zeros_g = torch.zeros((dense.shape[0], K))
    sharded = fn(lb, torch.tensor(2.5), dense, mask, zeros_g, 0, **kw)
    _close_estep(sharded, single)
    warm_single = tdense.e_step_dense(lb, torch.tensor(2.5), dense, mask,
                                      gamma_prev=single.gamma, warm=1, **kw)
    warm_sharded = fn(lb, torch.tensor(2.5), dense, mask, sharded.gamma, 1,
                      **kw)
    assert int(warm_sharded.vi_iters) <= int(sharded.vi_iters)
    np.testing.assert_allclose(warm_sharded.gamma.numpy(),
                               warm_single.gamma.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(warm_sharded.likelihood),
                               float(warm_single.likelihood), rtol=1e-5)
    jfn = jpar.make_vocab_sharded_dense_e_step(jpar.make_mesh(data=d,
                                                              model=m))
    jb = _batch(jcorpus)
    jd = np.asarray(jdense.densify(jnp.asarray(jb.word_idx),
                                   jnp.asarray(jb.counts), V))
    np.testing.assert_array_equal(jd, dense.numpy())
    want = jax.jit(lambda *a: jfn(
        *a, jnp.zeros((jd.shape[0], K), jnp.float32),
        jnp.asarray(0, jnp.int32), **kw))(
        jnp.asarray(lb_pad, jnp.float32), jnp.float32(2.5), jnp.asarray(jd),
        jnp.asarray(jb.doc_mask))
    _close_estep(sharded, want, **JAX_TOL)


def test_vocab_sharded_dense_guards(problem):
    fn = tpar.make_vocab_sharded_dense_e_step(tpar.make_mesh(2, 4,
                                                             device=CPU))
    kw = dict(var_max_iters=5, var_tol=1e-6)
    g0 = torch.zeros((5, K))
    with pytest.raises(ValueError, match="not divisible by data"):
        fn(torch.zeros((K, 128)), 2.5, torch.zeros((5, 128)),
           torch.ones((5,)), g0, 0, **kw)
    with pytest.raises(ValueError, match="not divisible by model"):
        fn(torch.zeros((K, 130)), 2.5, torch.zeros((8, 130)),
           torch.ones((8,)), g0, 0, **kw)
    with pytest.raises(ValueError, match="width"):
        fn(torch.zeros((K, 256)), 2.5, torch.zeros((8, 128)),
           torch.ones((8,)), g0, 0, **kw)


@pytest.mark.parametrize("wmajor", [False, True])
def test_data_parallel_dense_one_one_mesh_parity(problem, wmajor):
    """The data-parallel dense E-step under a (1, 1) mesh equals the
    dense E-step itself (on the card, chip_smoke.py's mesh phase holds
    the kernel the same way), and both layouts match the JAX (1, 1)
    mesh's dense kernel."""
    corpus, jcorpus, log_beta = problem
    b = _batch(corpus)
    dense = tdense.densify(torch.as_tensor(b.word_idx),
                           torch.as_tensor(b.counts, dtype=torch.float32), V)
    if wmajor:
        dense = dense.t().contiguous()
    lb = torch.tensor(log_beta, dtype=torch.float32)
    mask = torch.as_tensor(b.doc_mask, dtype=torch.float32)
    kw = dict(var_max_iters=20, var_tol=1e-6)
    plain = tdense.e_step_dense(lb, torch.tensor(2.5), dense, mask,
                                wmajor=wmajor, **kw)
    fn = tpar.make_data_parallel_dense_e_step(
        tpar.make_mesh(1, 1, device=CPU), wmajor=wmajor)
    zeros_g = torch.zeros((dense.shape[1 if wmajor else 0], K))
    sharded = fn(lb, torch.tensor(2.5), dense, mask, zeros_g, 0, **kw)
    _close_estep(sharded, plain, g=(1e-6, 1e-6), ss=(1e-5, 1e-6), ll=1e-6,
                 ass=1e-6)
    jb = _batch(jcorpus)
    jd = jdense.densify(jnp.asarray(jb.word_idx), jnp.asarray(jb.counts), V)
    if wmajor:
        jd = jnp.transpose(jd)
    jfn = jsharded.make_data_parallel_dense_e_step(
        jpar.make_mesh(data=1, model=1, devices=jax.devices()[:1]),
        wmajor=wmajor)
    want = jax.jit(lambda *a: jfn(*a, interpret=True, **kw))(
        jnp.asarray(log_beta, jnp.float32), jnp.float32(2.5), jd,
        jnp.asarray(jb.doc_mask), jnp.zeros(zeros_g.shape, jnp.float32),
        jnp.asarray(0, jnp.int32))
    _close_estep(sharded, want, g=(1e-4, 1e-4), ss=(1e-4, 1e-5), ll=1e-5,
                 ass=1e-5)


def test_data_parallel_dense_eight_slots(problem):
    """The dense kernel on each of 8 data slots' [B/8, W] slices, psummed:
    the unsharded dense E-step within the JAX test's sharded bounds, and
    every slot ran its slice (both layouts)."""
    corpus, _, log_beta = problem
    b = _batch(corpus)
    dense = tdense.densify(torch.as_tensor(b.word_idx),
                           torch.as_tensor(b.counts, dtype=torch.float32), V)
    lb = torch.tensor(log_beta, dtype=torch.float32)
    mask = torch.as_tensor(b.doc_mask, dtype=torch.float32)
    kw = dict(var_max_iters=20, var_tol=1e-6)
    for wmajor in (False, True):
        c = dense.t().contiguous() if wmajor else dense
        plain = tdense.e_step_dense(lb, torch.tensor(2.5), c, mask,
                                    wmajor=wmajor, **kw)
        fn = tpar.make_data_parallel_dense_e_step(
            tpar.make_mesh(8, 1, device=CPU), wmajor=wmajor)
        _close_estep(fn(lb, torch.tensor(2.5), c, mask, None, None, **kw),
                     plain)
    with pytest.raises(ValueError, match="not divisible by data axis 8"):
        fn(lb, torch.tensor(2.5), c[:, :12], mask[:12], None, None, **kw)


def test_batch_size_divisibility_guard(problem):
    corpus, _, _ = problem
    mesh = tpar.make_mesh(8, 1, device=CPU)
    cfg = LDAConfig(num_topics=K, batch_size=12)  # 12 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        train_corpus(corpus, cfg, mesh=mesh)


def test_one_one_mesh_is_the_unmeshed_fit(problem):
    """A (1, 1) mesh pads batches to a multiple of 1, not 8; where the
    two paddings give the same batches (this corpus: one batch of 48)
    the fit is the unmeshed one, bit for bit: the psum over one slot is
    the slot's value."""
    corpus, _, _ = problem
    cfg = LDAConfig(**FIT)
    single = train_corpus(corpus, cfg, device=CPU)
    one = train_corpus(corpus, cfg, mesh=tpar.make_mesh(1, 1, device=CPU))
    assert single.stats["batch_shapes"] == one.stats["batch_shapes"]
    np.testing.assert_array_equal(one.log_beta, single.log_beta)
    np.testing.assert_array_equal(one.gamma, single.gamma)
    assert one.likelihoods == single.likelihoods


def test_two_runs_of_one_mesh_write_the_same_bytes(problem, tmp_path):
    corpus, _, _ = problem
    cfg = LDAConfig(**FIT)
    outs = []
    for run in ("a", "b"):
        out = tmp_path / run
        out.mkdir()
        train_corpus(corpus, cfg, out_dir=str(out),
                     mesh=tpar.make_mesh(2, 4, device=CPU),
                     vocab_sharded=True)
        outs.append(out)
    for name in ("final.beta", "final.gamma", "final.other",
                 "likelihood.dat"):
        assert (outs[0] / name).read_bytes() == (outs[1] / name).read_bytes()


def test_stepwise_driver_under_a_mesh(problem):
    """fused_em_chunk=1 runs the stepwise driver over the same placed
    batches: the chunk driver's fit within the JAX test's bounds, for
    the data-parallel and the vocab-sharded plans."""
    corpus, _, _ = problem
    for shape, vs in (((8, 1), False), ((2, 4), True)):
        mesh = tpar.make_mesh(*shape, device=CPU)
        chunked = train_corpus(corpus, LDAConfig(**FIT), mesh=mesh,
                               vocab_sharded=vs)
        step = train_corpus(corpus, LDAConfig(**FIT, fused_em_chunk=1),
                            mesh=mesh, vocab_sharded=vs)
        assert step.stats["driver"] == "stepwise"
        _close_fit(step, chunked)


def test_mesh_refuses_the_sparse_engine_and_compact(problem, monkeypatch):
    corpus, _, _ = problem
    mesh = tpar.make_mesh(2, 1, device=CPU)
    with pytest.raises(ValueError, match="single-process"):
        train_corpus(corpus, LDAConfig(**FIT, estep_engine="sparse"),
                     mesh=mesh)
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "compact")
    with pytest.raises(ValueError, match="a mesh is active"):
        train_corpus(corpus, LDAConfig(**FIT), mesh=mesh)
    monkeypatch.delenv("ONI_ML_TPU_ESTEP")
    with pytest.raises(ValueError, match="requires a mesh"):
        train_corpus(corpus, LDAConfig(**FIT), device=CPU,
                     vocab_sharded=True)
    with pytest.warns(UserWarning, match="replicate work"):
        train_corpus(corpus, dataclasses.replace(LDAConfig(**FIT),
                                                 em_max_iters=1),
                     mesh=tpar.make_mesh(2, 2, device=CPU))
