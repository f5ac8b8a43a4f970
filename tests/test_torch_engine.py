"""The port's engine choice against the JAX package on the CPU: the
engine resolution and the dense family's gates for every env value and
config, the compact-vocab plan and stacks, the plan store under the
run's device fingerprint, the measured crossover's precedence, and
whole fits of the dense family's forced paths (xla under both drivers,
compact, pallas) against the JAX trainer from the same initial beta."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.io import make_batches as jmake_batches
from oni_ml_tpu.models import fused as jfused
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu.ops import estep as jestep
from oni_ml_tpu.ops import pallas_estep as jpallas
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu_torch import plans
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus, make_batches
from oni_ml_tpu_torch.models import fused, train_corpus
from oni_ml_tpu_torch.models.lda import LDATrainer, resolve_estep_engine
from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import pallas_estep as tpallas
from oni_ml_tpu_torch.ops import sparse_estep as tsparse

K, V, DOCS, BATCH, EM_ITERS = 5, 200, 48, 8, 4


@pytest.fixture(scope="module")
def corpora():
    """48 docs of 1..40 distinct words out of 200, topic-structured."""
    rng = np.random.default_rng(23)
    topics = rng.dirichlet(np.full(V, 0.05), size=4)
    triples = []
    for d in range(DOCS):
        theta = rng.dirichlet(np.full(4, 0.3))
        for w in rng.choice(V, size=int(rng.integers(1, 41)), p=theta @ topics):
            triples.append((f"ip{d}", f"w{w}", int(rng.integers(1, 6))))
    return Corpus.from_word_counts(triples), JCorpus.from_word_counts(triples)


@pytest.fixture()
def hermetic(monkeypatch, tmp_path):
    """A fresh plan cache and no engine env for each test."""
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "plans.jsonl"))
    monkeypatch.delenv("ONI_ML_TPU_ESTEP", raising=False)
    monkeypatch.delenv("ONI_ML_TPU_ESTEP_ENGINE", raising=False)
    monkeypatch.setattr(tsparse, "_CROSSOVER_CACHE", {})


@pytest.fixture()
def fake_card(monkeypatch):
    """The card's name and count for device fingerprints, on a machine
    without one."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(plans, "_DEVICE_FP", {})


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return "raises"


@pytest.mark.parametrize("dense_em", ["auto", "on", "off"])
@pytest.mark.parametrize("env", ["", "sparse", "dense", "compact", "xla",
                                 "pallas"])
def test_engine_and_gates_decide_as_jax(corpora, hermetic, monkeypatch, env,
                                        dense_em):
    """For this env value and dense_em, every estep_engine resolves (or
    raises) as the JAX package's on the CPU, and the chunk driver's
    dense family picks the same member: full-V dense (_use_dense),
    compact (_plan_compact, with the same uniques and widths) or per
    batch."""
    corpus, jcorpus = corpora
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", env)
    for choice in ("auto", "dense", "sparse"):
        got = _outcome(lambda: resolve_estep_engine(
            corpus, LDAConfig(estep_engine=choice, dense_em=dense_em),
            device="cpu"))
        want = _outcome(lambda: jlda.resolve_estep_engine(
            jcorpus, JLDAConfig(estep_engine=choice, dense_em=dense_em)))
        assert got == want, (choice, got, want)
    batches = make_batches(corpus, BATCH, 16, pad_multiple=8)
    tr = LDATrainer(LDAConfig(num_topics=K, dense_em=dense_em),
                    corpus.num_terms, device="cpu")
    jtr = jlda.LDATrainer(JLDAConfig(num_topics=K, dense_em=dense_em),
                          jcorpus.num_terms)
    use = tr._use_dense(batches)
    assert use == jtr._use_dense(batches)
    if not use:
        plan, jplan = tr._plan_compact(batches), jtr._plan_compact(batches)
        assert (plan is None) == (jplan is None)
        if plan is not None:
            assert plan.widths == jplan.widths
            assert plan.corpus_bytes == jplan.corpus_bytes


def test_compact_plan_and_stacks_match_jax(corpora, monkeypatch):
    """plan_compact: the same per-batch uniques and group widths;
    compact_stack_batches: the same local dense corpus, masks and
    vocabulary maps, W-major and row-major."""
    corpus, _ = corpora
    for name in ("pick_block", "pick_block_w"):
        monkeypatch.setattr(jdense, name, lambda b, v, k, precision="f32":
                            tdense.pick_block(b, v, k))
    batches = make_batches(corpus, BATCH, 16, pad_multiple=8)
    jbatches = jmake_batches(corpora[1], BATCH, 16, pad_multiple=8)
    for wmajor in (True, False):
        plan = fused.plan_compact(batches, K, wmajor=wmajor)
        jplan = jfused.plan_compact(jbatches, K, wmajor=wmajor)
        assert plan.widths == jplan.widths and plan.wmajor == jplan.wmajor
        for us, jus in zip(plan.uniques, jplan.uniques):
            for u, ju in zip(us, jus):
                np.testing.assert_array_equal(u, ju)
        got = fused.compact_stack_batches(batches, "cpu", plan)
        want = jfused.compact_stack_batches(jbatches, np.float32,
                                            jnp.asarray, jplan)
        assert got.batch_slots == want.batch_slots
        for g, w in zip(got.arrays, want.arrays):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert fused.plan_compact(batches, tdense.MAX_TOPICS + 1) is None


def test_dense_gates_count_the_kernel_scratch(hermetic):
    """On the card, the full-V and compact gates add the dense kernel's
    largest per-launch scratch (fused.dense_scratch_bytes) to the corpus
    and sparse-stack bytes: a batch of 8 documents of 4,096 tokens at
    K=20 over a 5,632-wide vocabulary has blocks of one document with up
    to 4,096 non-zero cells, more than shared memory holds, so each
    launch takes 8 slices of 4,096 cells of 21 floats; the flow day's
    main bucket (L=128) takes none.  A budget that fits all three admits
    the path; one byte less refuses it."""
    import types

    rng = np.random.default_rng(5)
    num_terms, k = 5520, 20
    batches = [types.SimpleNamespace(word_idx=rng.integers(
        0, num_terms, size=(8, 4096)).astype(np.int32))]
    width = tdense.padded_width(num_terms)
    scratch = fused.dense_scratch_bytes([((8, 4096), width)], k)
    assert scratch == 8 * 4096 * 4 * (k + 1)
    assert fused.dense_scratch_bytes([((1024, 128), width)], k) == 0
    sparse_bytes = 8 * 4096 * 8
    full = 8 * width * 4 + sparse_bytes + scratch

    def trainer(budget):
        tr = LDATrainer(LDAConfig(num_topics=k, dense_hbm_budget=budget),
                        num_terms, device="cpu")
        tr.device = torch.device("cuda")   # the gates' card check only
        return tr

    assert trainer(full)._use_dense(batches)
    assert not trainer(full - 1)._use_dense(batches)
    plan = fused.plan_compact(batches, k)
    assert plan.widths[0] > 4096     # so the same scratch as full-V
    compact = plan.corpus_bytes + sparse_bytes + scratch
    assert trainer(compact - 1)._plan_compact(batches) is None
    assert trainer(compact)._plan_compact(batches) is not None


def test_plan_store_round_trips_under_the_card_fingerprint(
        hermetic, fake_card, tmp_path, monkeypatch):
    """A record written for a run on the card reads back from the file
    under its `cuda:` fingerprint and misses for a CPU run; the EM
    knobs are plan knobs too (resolved in models/lda.py); an unknown knob
    is not recorded; an invalid entry is ignored; ONI_ML_TPU_PLANS=0
    disables lookups; the port ships no seed plans."""
    assert plans.device_fingerprint("cuda") == "cuda:nvidia_h100_80gb_hbm3:1"
    assert plans.device_fingerprint("cpu").startswith("cpu:")
    value = {"engine": "dense", "dense_s": 0.5, "sparse_s": 0.7}
    assert plans.record_value("estep_engine", value, shape="s1",
                              device="cuda", measurements={1: 2})
    assert plans.record_value("fused_em_chunk", 32, shape="k5",
                              device="cuda")
    assert not plans.record_value("dense_estep_block", 32, shape="k5",
                                  device="cuda")
    fresh = plans.PlanStore(str(tmp_path / "plans.jsonl"))
    entry = fresh.lookup("estep_engine", "cuda:nvidia_h100_80gb_hbm3:1", "s1")
    assert entry.value == value and entry.measurements == {"1": 2}
    assert entry.record["schema"] == plans.SCHEMA_VERSION
    assert fresh.lookup("fused_em_chunk", "cuda:nvidia_h100_80gb_hbm3:1",
                        "k5").value == 32
    assert fresh.lookup("dense_estep_block", "cuda:nvidia_h100_80gb_hbm3:1",
                        "k5") is None
    assert plans.lookup_value("estep_engine", "s1", device="cuda") == value
    assert plans.lookup_value("estep_engine", "s1", device="cpu") is None
    assert plans.record_value("estep_engine", {"engine": "xla"}, shape="s2",
                              device="cuda")
    assert plans.lookup_value("estep_engine", "s2", device="cuda") is None
    with plans.use_store(plans.NullStore()):
        assert plans.lookup_value("estep_engine", "s1", device="cuda") is None
    monkeypatch.setenv("ONI_ML_TPU_PLANS", "0")
    assert plans.lookup_value("estep_engine", "s1", device="cuda") is None
    assert not plans.record_value("estep_engine", value, device="cuda")
    with open(tmp_path / "plans.jsonl", "a") as f:
        f.write('{"schema": 99, "knob": "x", "backend": "y", "value": 1}\n'
                '{"trunc')
    assert plans.PlanStore(str(tmp_path / "plans.jsonl")).dropped_records == 1
    import os

    assert not os.path.exists(os.path.join(os.path.dirname(plans.__file__),
                                           "seeds"))


def test_engine_crossover_precedence(corpora, hermetic, fake_card,
                                     monkeypatch):
    """ONI_ML_TPU_ESTEP_ENGINE > this process's memo > the plan cache
    (exact shape before density band) > a measurement, which is recorded
    under both keys; resolve_estep_engine on the card takes the
    crossover at the corpus' dominant bucket shape."""
    calls = []

    def fake_measure(k, v, b, l, *, precision="f32", device="cuda"):
        calls.append((k, v, b, l))
        return {"engine": "sparse", "dense_s": 2.0, "sparse_s": 1.0,
                "source": "measured",
                "shape": tsparse.crossover_shapes(k, v, b, l, precision)[0]}

    monkeypatch.setattr(tsparse, "measure_crossover", fake_measure)
    monkeypatch.setenv("ONI_ML_TPU_ESTEP_ENGINE", "dense")
    assert tsparse.engine_crossover(20, 5000, 1024, 128)["source"] == "env"
    monkeypatch.delenv("ONI_ML_TPU_ESTEP_ENGINE")
    first = tsparse.engine_crossover(20, 5000, 1024, 128)
    assert first["source"] == "measured" and len(calls) == 1
    assert tsparse.engine_crossover(20, 5000, 1024, 128) is first
    tsparse._CROSSOVER_CACHE.clear()
    again = tsparse.engine_crossover(20, 5000, 1024, 128)
    exact, band = tsparse.crossover_shapes(20, 5000, 1024, 128, "f32")
    assert (again["source"], again["shape"]) == ("plan", exact)
    assert again["sparse_s"] == 1.0 and len(calls) == 1
    near = tsparse.engine_crossover(20, 5100, 512, 128)
    assert (near["source"], near["shape"]) == ("plan", band)
    tsparse.engine_crossover(20, 5000, 1024, 128, force=True)
    assert len(calls) == 2
    assert tsparse.engine_crossover(20, 5000, 1024, 128,
                                    device="cpu")["source"] == "measured"
    corpus, _ = corpora
    got = resolve_estep_engine(corpus, LDAConfig(num_topics=K), device="cuda")
    assert got == ("sparse", "measured")
    b_dom, l_dom, _ = max(corpus.bucket_shapes(128, 1024, 8),
                          key=lambda s: s[2])
    assert calls[-1] == (K, corpus.num_terms, b_dom, l_dom)
    assert resolve_estep_engine(corpus, LDAConfig(num_topics=K,
                                                  dense_em="on"),
                                device="cuda") == ("dense", "default")


def test_crossover_plan_misses_after_a_kernel_source_change(
        hermetic, fake_card, monkeypatch, tmp_path):
    """A crossover recorded under one build of the kernels (their source
    hashes, which name the built libraries) is a plan hit while the
    sources stay, and a miss, memo included, once they change: a
    redesigned kernel re-measures the engine choice.  The hash moves
    with an edit to a kernel's source."""
    calls = []

    def fake_measure(k, v, b, l, *, precision="f32", device="cuda"):
        calls.append((k, v, b, l))
        return {"engine": "sparse", "dense_s": 2.0, "sparse_s": 1.0,
                "source": "measured",
                "shape": tsparse.crossover_shapes(k, v, b, l, precision)[0]}

    monkeypatch.setattr(tsparse, "measure_crossover", fake_measure)
    monkeypatch.setattr(tsparse, "crossover_kernels", lambda: "olda+oldb")
    assert tsparse.engine_crossover(20, 5000, 1024, 128)["source"] == "measured"
    tsparse._CROSSOVER_CACHE.clear()
    assert tsparse.engine_crossover(20, 5000, 1024, 128)["source"] == "plan"
    monkeypatch.setattr(tsparse, "crossover_kernels", lambda: "newa+newb")
    again = tsparse.engine_crossover(20, 5000, 1024, 128)
    assert again["source"] == "measured" and len(calls) == 2
    assert plans.lookup_value("estep_engine", again["shape"], device="cuda",
                              kernels="olda+oldb")["engine"] == "sparse"
    assert plans.lookup_value("estep_engine", again["shape"],
                              device="cuda") is None
    import shutil

    from oni_ml_tpu_torch.ops import _cuda

    before = _cuda.source_digest("dense_estep")
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    assert _cuda.source_digest("dense_estep") == before
    with open(csrc / "dense_estep.cu", "a") as f:
        f.write("// edited\n")
    assert _cuda.source_digest("dense_estep") != before


@pytest.mark.parametrize("k,v,b,l", [(20, 5568, 1024, 128),
                                     (5, 200, 8, 4096), (50, 300000, 16, 16)])
def test_crossover_keys_and_flops_match_jax(k, v, b, l):
    """The crossover's plan keys (exact shape, density band) and the
    flop counts it is read against are the JAX package's."""
    assert tsparse.crossover_shapes(k, v, b, l, "f32") == \
        jsparse.crossover_shapes(k, v, b, l, "f32")
    assert tsparse.density_pct(l, v) == jsparse.density_pct(l, v)
    assert tsparse.effective_flops(b, l, k, 8) == \
        jsparse.effective_flops(b, l, k, 8)
    assert tsparse.dense_equiv_flops(b, v, k, 8) == \
        jsparse.dense_equiv_flops(b, v, k, 8)


def _jax_init(corpus):
    return np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), K,
                                         corpus.num_terms))


def _assert_fits_match(got, want):
    """The tolerances of tests/test_torch_lda.py: em_iters equal, the
    same LOG_ZERO set, likelihoods rel 1e-5, beta as probabilities rel
    1e-4 above 1e-12, gamma rel 1e-4, alpha rel 1e-5."""
    assert got.em_iters == want.em_iters == EM_ITERS
    np.testing.assert_allclose(np.asarray(got.likelihoods)[:, 0],
                               np.asarray(want.likelihoods)[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(got.log_beta == -100.0,
                                  want.log_beta == -100.0)
    np.testing.assert_allclose(np.exp(got.log_beta), np.exp(want.log_beta),
                               rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got.gamma, want.gamma, rtol=1e-4)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-5)


# EM_ITERS full EM iterations (em_tol below any conv).  Four: as the
# topics specialise, some gamma entries fall towards alpha, where
# digamma is steep, and float32 sums in another order grow there
# (measured on small flow days: gamma rel 2e-4 to 5e-4 by the sixth
# iteration on every path, under 5e-6 by the third).
COMMON = dict(num_topics=K, em_max_iters=EM_ITERS, em_tol=1e-12,
              batch_size=BATCH, seed=0)


@pytest.mark.parametrize("path,chunk", [("xla", 128), ("xla", 1),
                                        ("compact", 128)])
def test_forced_dense_family_fits_match_jax(corpora, hermetic, monkeypatch,
                                            path, chunk):
    """ONI_ML_TPU_ESTEP=xla under the chunk and the stepwise driver, and
    =compact under the chunk driver (JAX's dense kernel in interpret
    mode at the port's doc blocks), against the JAX trainer forced the
    same way."""
    corpus, jcorpus = corpora
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", path)
    for name in ("pick_block", "pick_block_w"):
        monkeypatch.setattr(jdense, name, lambda b, v, k, precision="f32":
                            tdense.pick_block(b, v, k))
    want = jlda.train_corpus(jcorpus, JLDAConfig(fused_em_chunk=chunk,
                                                 **COMMON))
    got = train_corpus(corpus, LDAConfig(fused_em_chunk=chunk, **COMMON),
                       initial_log_beta=_jax_init(corpus), device="cpu")
    assert got.plan["estep_engine"] == want.plan["estep_engine"] == {
        "value": "dense", "source": "env"}
    assert got.stats["member"] == ("compact" if path == "compact"
                                   else "per_batch:xla")
    assert got.stats["driver"] == ("fused" if chunk > 1 else "stepwise")
    _assert_fits_match(got, want)


def _jax_pallas_e_step(log_beta, alpha, word_idx, counts, doc_mask,
                       var_max_iters, var_tol, gamma_prev=None, warm=None):
    """JAX pallas_estep.e_step's steps with the kernel in interpret mode
    at the port's doc block (so both sides stop at the same blocks)."""
    v = log_beta.shape[1]
    slab = jnp.exp(log_beta)[:, word_idx]
    gamma, iters = jpallas.fixed_point(
        slab, alpha, counts, doc_mask, var_max_iters, var_tol,
        block=tpallas.pick_block(word_idx.shape[0]), interpret=True,
        gamma_prev=gamma_prev, warm=warm)
    phi_c, phinorm = jestep.phi_weighted(slab.transpose(1, 2, 0), gamma,
                                         counts, doc_mask)
    suff = jestep.suff_stats(phi_c, word_idx, v)
    likelihood, alpha_ss = jestep.batch_likelihood(gamma, phinorm, counts,
                                                   alpha, doc_mask)
    return jestep.EStepResult(gamma, suff, alpha_ss, likelihood, iters)


_jax_pallas_e_step._oni_warm_capable = True


def test_forced_pallas_fit_matches_jax(corpora, hermetic, monkeypatch):
    """ONI_ML_TPU_ESTEP=pallas under the port's chunk driver (the
    fixed-point kernel's plain version on the CPU) against the JAX
    trainer given the Pallas fixed point in interpret mode as its
    e_step_fn, under the stepwise driver (interpret mode is cheaper
    there); both warm-started."""
    corpus, jcorpus = corpora
    batches = jmake_batches(jcorpus, BATCH, 16, pad_multiple=8)
    jtr = jlda.LDATrainer(JLDAConfig(fused_em_chunk=1, **COMMON),
                          jcorpus.num_terms, e_step_fn=_jax_pallas_e_step)
    want = jtr.fit(batches, jcorpus.num_docs,
                   initial_log_beta=_jax_init(corpus))
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "pallas")
    got = train_corpus(corpus, LDAConfig(**COMMON),
                       initial_log_beta=_jax_init(corpus), device="cpu")
    assert got.stats["member"] == "per_batch:pallas"
    assert got.stats["driver"] == "fused"
    _assert_fits_match(got, want)
