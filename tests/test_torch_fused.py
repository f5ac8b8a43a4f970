"""The port's chunk driver (models/fused.py) against the JAX package's
`make_chunk_runner`: ChunkResult field by field for sparse groups,
dense groups in both layouts and the single-dense-group fast path, from
the same state, with a device stop inside a dispatch; a chunk split
across dispatches; and the chunk driver against the stepwise driver.

Both sides run at the same doc blocks (the JAX block picks are patched
to the port's; the per-block stop then makes the same decisions), and
the JAX side runs its Pallas kernels in interpret mode."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.models import fused as jfused
from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus, make_batches
from oni_ml_tpu_torch.models import convert, fused, train_corpus
from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import sparse_estep as tsparse

K, V, CHUNK = 5, 600, 6
SPARSE_BLOCK, DENSE_BLOCK = 8, 4


@pytest.fixture(scope="module")
def corpus():
    """~100 docs of 1..70 distinct words out of 600, with
    topic-structured draws so EM makes progress."""
    rng = np.random.default_rng(17)
    topics = rng.dirichlet(np.full(V, 0.05), size=4)
    triples = []
    for d in range(96):
        theta = rng.dirichlet(np.full(4, 0.3))
        words = rng.choice(V, size=int(rng.integers(1, 71)),
                           p=theta @ topics)
        for w in words:
            triples.append((f"ip{d}", f"w{w}", int(rng.integers(1, 6))))
    return Corpus.from_word_counts(triples), JCorpus.from_word_counts(triples)


@pytest.fixture()
def same_blocks(monkeypatch):
    monkeypatch.setattr(jsparse, "pick_block",
                        lambda b, l, k, precision="f32": SPARSE_BLOCK)
    for mod in (jdense, tdense):
        for name in ("pick_block", "pick_block_w"):
            monkeypatch.setattr(mod, name,
                                lambda b, v, k, precision="f32": DENSE_BLOCK)
    monkeypatch.setattr(tsparse, "pick_block", lambda b: SPARSE_BLOCK)


def _batches(corpus, kind):
    if kind == "sparse":
        return list(corpus.bucketed_layout(min_len=16, batch_cap=32,
                                           pad_multiple=8).batches)
    if kind.startswith("fast"):   # one bucket, one batch: one dense group
        return make_batches(corpus, 128, min_bucket_len=128, pad_multiple=8)
    return make_batches(corpus, 32, min_bucket_len=16, pad_multiple=8)


def _groups(batches, kind, wmajor):
    jg = jfused.stack_batches(batches, np.float32, jnp.asarray)
    tg = fused.stack_batches(batches, "cpu")
    if kind != "sparse":
        jg = jfused.densify_groups(jg, V, wmajor=wmajor)
        tg = fused.densify_groups(tg, V, wmajor=wmajor)
    return jg, tg


def _runners(kind, wmajor, num_docs, em_tol):
    kw = dict(num_docs=num_docs, num_topics=K, num_terms=V, chunk=CHUNK,
              var_max_iters=20, var_tol=1e-6, em_tol=em_tol,
              estimate_alpha=True, dense_wmajor=wmajor, warm_start=True,
              alpha_max_iters=8)
    e_fn = jsparse.make_e_step_fn(interpret=True) if kind == "sparse" else None
    return (jfused.make_chunk_runner(e_step_fn=e_fn, **kw),
            fused.make_chunk_runner(**kw))


def _log_beta0():
    rng = np.random.default_rng(3)
    noise = rng.uniform(size=(K, V)) + 1.0 / V
    return np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)


def _stop_tol(lls):
    """(em_tol, steps): an em_tol that the run's |dll/ll| first falls
    under inside the dispatch, with a margin of the geometric mean on
    both sides, and the steps the device then runs."""
    ll = np.asarray(lls, np.float64)
    conv = np.abs((ll[:-1] - ll[1:]) / ll[:-1])      # conv[i] of step i+1
    for i in range(1, len(conv) - 1):
        if conv[i] < conv[:i].min():
            return float(math.sqrt(conv[i] * conv[:i].min())), i + 2
    raise AssertionError(f"no stop inside the dispatch: {conv}")


def _assert_chunk_results_match(got, want, steps):
    """steps_done, converged and vi_iters equal; lls rtol 1e-5 (zeros
    past the stop on both sides); alpha and ll_prev rtol 1e-5; beta as
    probabilities rtol 1e-4 above 1e-12, with LOG_ZERO where JAX has it;
    gammas rtol 1e-4.  Float32 sums in two libraries in another order,
    compounded over the EM iterations of the dispatch."""
    assert int(got.steps_done) == int(want.steps_done) == steps
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_array_equal(got.vi_iters.numpy(),
                                  np.asarray(want.vi_iters))
    np.testing.assert_allclose(got.lls.numpy(), np.asarray(want.lls),
                               rtol=1e-5)
    assert (got.lls.numpy()[steps:] == 0).all()
    np.testing.assert_allclose(float(got.alpha), float(want.alpha), rtol=1e-5)
    np.testing.assert_allclose(float(got.ll_prev), float(want.ll_prev),
                               rtol=1e-5)
    wl = np.asarray(want.log_beta)
    np.testing.assert_array_equal(got.log_beta.numpy() == -100.0, wl == -100.0)
    np.testing.assert_allclose(np.exp(got.log_beta.numpy()), np.exp(wl),
                               rtol=1e-4, atol=1e-12)
    assert len(got.gammas) == len(want.gammas)
    for g, w in zip(got.gammas, want.gammas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)


@pytest.mark.parametrize("kind,wmajor,plan", [
    ("sparse", False, "generic"),
    ("dense", False, "generic"),
    ("dense", True, "generic"),
    ("fast", True, "fast"),
    ("fast", False, "fast"),
])
def test_chunk_runner_matches_jax(corpus, same_blocks, kind, wmajor, plan):
    """Dispatch 1: CHUNK steps from a fresh state, with em_tol set so
    the device stops inside the dispatch.
    Dispatch 2: both runners continue from the JAX state (carried across
    by convert.chunk_state_from_reference), warm, for 2 steps."""
    tc, jc = corpus
    batches = _batches(tc, kind)
    jg, tg = _groups(batches, kind, wmajor)
    assert (len(tg.arrays) == 1 and tg.arrays[0][0].shape[0] == 1) == (
        plan == "fast")
    lb0 = _log_beta0()
    nan = float("nan")
    # A probe with em_tol = 0 finds an em_tol that stops mid-dispatch.
    _, probe = _runners(kind, wmajor, tc.num_docs, 0.0)
    em_tol, steps = _stop_tol(probe(torch.from_numpy(lb0), 2.5, nan,
                                    tg.arrays, CHUNK).lls.numpy())
    assert steps < CHUNK
    jrun, trun = _runners(kind, wmajor, tc.num_docs, em_tol)
    jgam0 = jfused.initial_gammas(jg.arrays, K, jnp.float32,
                                  dense_wmajor=wmajor)
    jfused.LAST_CHUNK_PLAN = fused.LAST_CHUNK_PLAN = None
    want = jrun(jnp.asarray(lb0), jnp.float32(2.5), jnp.float32(nan),
                jg.arrays, CHUNK, jgam0, jnp.asarray(False))
    got = trun(torch.from_numpy(lb0), 2.5, nan, tg.arrays, CHUNK)
    assert jfused.LAST_CHUNK_PLAN == fused.LAST_CHUNK_PLAN == plan
    _assert_chunk_results_match(got, want, steps)
    assert bool(got.converged)

    state = convert.chunk_state_from_reference(
        want.log_beta, want.alpha, want.ll_prev, want.gammas)
    want2 = jrun(want.log_beta, want.alpha, want.ll_prev, jg.arrays, 2,
                 want.gammas, jnp.asarray(True))
    got2 = trun(state.log_beta, state.alpha, state.ll_prev, tg.arrays, 2,
                state.gammas, True)
    steps2 = int(want2.steps_done)
    assert steps2 >= 1
    _assert_chunk_results_match(got2, want2, steps2)


@pytest.mark.parametrize("kind", ["sparse", "dense", "fast"])
def test_split_dispatches_change_nothing(corpus, kind):
    """5 steps in one dispatch against 2 + 3 with the state carried:
    the same likelihoods and final state.  Bit for bit on the generic
    impl (the same ops in the same order); the fast path rebuilds
    log beta at each dispatch's end, so there the second dispatch
    starts from exp(log(beta)) and agrees to rtol 1e-5."""
    tc, _ = corpus
    _, tg = _groups(_batches(tc, kind), kind, True)
    run = fused.make_chunk_runner(
        num_docs=tc.num_docs, num_topics=K, num_terms=V, chunk=8,
        var_max_iters=20, var_tol=1e-6, em_tol=0.0, estimate_alpha=True,
        dense_wmajor=True, warm_start=True, alpha_max_iters=8)
    lb0, nan = torch.from_numpy(_log_beta0()), float("nan")
    one = run(lb0, 2.5, nan, tg.arrays, 5)
    a = run(lb0, 2.5, nan, tg.arrays, 2)
    b = run(a.log_beta, a.alpha, a.ll_prev, tg.arrays, 3, a.gammas,
            int(a.steps_done) > 0)
    assert int(one.steps_done) == 5 and int(a.steps_done) == 2
    split = torch.cat([a.lls[:2], b.lls[:3]])
    if kind == "fast":
        np.testing.assert_allclose(split.numpy(), one.lls[:5].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(b.log_beta.numpy(), one.log_beta.numpy(),
                                   rtol=1e-5)
        return
    assert torch.equal(split, one.lls[:5])
    assert torch.equal(b.log_beta, one.log_beta)
    assert torch.equal(b.alpha, one.alpha)
    for g1, g2 in zip(b.gammas, one.gammas):
        assert torch.equal(g1, g2)


def test_zero_step_dispatch_returns_its_input(corpus):
    """A dispatch of 0 steps changes nothing, on the fast path too
    (log(exp(x)) would drift an ulp)."""
    tc, _ = corpus
    _, tg = _groups(_batches(tc, "fast"), "fast", True)
    run = fused.make_chunk_runner(
        num_docs=tc.num_docs, num_topics=K, num_terms=V, chunk=4,
        var_max_iters=20, var_tol=1e-6, em_tol=0.0, estimate_alpha=True,
        dense_wmajor=True, warm_start=True)
    lb0 = torch.from_numpy(_log_beta0())
    res = run(lb0, 2.5, float("nan"), tg.arrays, 0)
    assert int(res.steps_done) == 0 and not bool(res.converged)
    assert torch.equal(res.log_beta, lb0)


def test_fast_path_zero_mass_round_trips_to_log_zero(corpus):
    """Words no document holds get zero mass: the fast path carries
    them through exp(LOG_ZERO), a float32 subnormal held as zero, and
    writes LOG_ZERO back bit for bit — the generic path's m_step gives
    the same set."""
    tc, _ = corpus
    batches = _batches(tc, "fast")
    _, tg = _groups(batches, "fast", True)
    lb0 = torch.from_numpy(_log_beta0())
    common = dict(num_docs=tc.num_docs, num_topics=K, num_terms=V, chunk=3,
                  var_max_iters=20, var_tol=1e-6, em_tol=0.0,
                  estimate_alpha=True, dense_wmajor=True, warm_start=True)
    fast = fused.make_chunk_runner(**common)(lb0, 2.5, float("nan"),
                                             tg.arrays, 3)
    assert fused.LAST_CHUNK_PLAN == "fast"
    generic = fused.make_chunk_runner(
        m_step_fn=lambda ss: tsparse.estep.m_step(ss), **common)(
        lb0, 2.5, float("nan"), tg.arrays, 3)
    assert fused.LAST_CHUNK_PLAN == "generic"
    unseen = np.setdiff1d(np.arange(V), tc.word_idx)
    assert len(unseen) > 0
    assert (fast.log_beta[:, unseen] == -100.0).all()
    np.testing.assert_array_equal(fast.log_beta.numpy() == -100.0,
                                  generic.log_beta.numpy() == -100.0)
    np.testing.assert_allclose(fast.lls.numpy(), generic.lls.numpy(),
                               rtol=1e-5)


def test_chunk_driver_matches_stepwise_driver(corpus):
    """The sparse engine under the chunk driver (chunk 4, a sync every 3
    iterations) against the stepwise driver: the same stop (em_tol 1e-3
    fires before em_max_iters), likelihoods to rtol 1e-6, alpha 1e-6,
    beta (as probabilities above 1e-12) 1e-4 and gamma 5e-4.  The same
    ops, but the batches' f32 sums add in another order — the chunk
    driver walks the shape groups in sorted order, as the JAX package's
    does, the stepwise driver the layout's order — and that difference
    feeds back through the fixed point's stop decisions over the EM
    iterations (measured: likelihood 9e-8, beta 5e-5, gamma 1.5e-4)."""
    tc, _ = corpus
    common = dict(num_topics=K, em_max_iters=40, em_tol=1e-3, batch_size=32,
                  sparse_min_bucket_len=16, seed=0)
    step = train_corpus(tc, LDAConfig(fused_em_chunk=1, **common),
                        device="cpu")
    chunk = train_corpus(tc, LDAConfig(fused_em_chunk=4, host_sync_every=3,
                                       **common), device="cpu")
    assert step.stats["driver"] == "stepwise"
    assert chunk.stats["driver"] == "fused"
    assert 2 < chunk.em_iters == step.em_iters < 40
    assert chunk.stats["host_syncs"] == math.ceil(chunk.em_iters / 3)
    np.testing.assert_allclose(np.asarray(chunk.likelihoods)[:, 0],
                               np.asarray(step.likelihoods)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(np.exp(chunk.log_beta), np.exp(step.log_beta),
                               rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(chunk.gamma, step.gamma, rtol=5e-4)
    np.testing.assert_allclose(chunk.alpha, step.alpha, rtol=1e-6)
