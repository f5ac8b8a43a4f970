"""The E-step kernels' bf16 storage mode (LDAConfig.dense_precision =
"bf16", `ml_ops --dense-precision bf16`) in the port against the JAX
package's bf16 mode on the CPU, on numpy inputs made from a seed: the
JAX Pallas kernels in interpret mode at the port's doc blocks (as the
port's f32 tests run them), the port's plain versions (the CUDA kernels'
CPU counterparts; the kernels against them on the card are in
test_torch_kernels.py).

What bf16 computes, in both packages: the sparse engine rounds its
exp(log beta) table to bf16 once and reads it everywhere (the tail
included); the dense family rounds beta, exp_et and the ratio before
each fixed-point product, keeps the tail f32 on f32 beta, and stores the
densified corpus as bf16 where every cell is <= 256.  Sums stay f32.

Each tolerance is stated where it is used.  Every one is tighter than the
JAX package's own bound between its bf16 and f32 results for the same
quantity (tests/test_sparse_estep.py: likelihood rtol 5e-3, gamma 2e-2;
tests/test_dense_estep.py: likelihood 1e-3, gamma 5e-2), and the E-step
tests also show the port's bf16 results far closer to JAX's bf16 than to
JAX's f32 ones, so the mode, not only the algorithm, is the one ported.
The gaps that remain are f32 sums in another order and the exact divide
of the plain versions against the Newton reciprocal, which moves a bf16
rounding of the ratio by one bf16 step now and then."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oni_ml_tpu import parallel as jpar
from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu_torch import parallel as tpar
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.models import train_corpus
from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import sparse_estep as tsparse

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
K, V, B, L = 6, 600, 64, 24


def _problem(seed):
    """A [B, L] batch of 4..L tokens (duplicate words included), a few
    masked docs, a warm-start gamma near the fresh one, beta from the JAX
    init's noise recipe."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(K, V)) + 1.0 / V
    log_beta = np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)
    lens = rng.integers(4, L + 1, size=B)
    live = np.arange(L)[None, :] < lens[:, None]
    word = np.where(live, rng.integers(0, V, size=(B, L)), 0).astype(np.int32)
    counts = np.where(live, rng.integers(1, 5, size=(B, L)), 0).astype(
        np.float32)
    mask = (rng.uniform(size=B) > 0.15).astype(np.float32)
    mean = 2.5 + counts.sum(1, keepdims=True) / K
    gamma_prev = (mean * rng.uniform(0.5, 1.5, size=(B, K))).astype(np.float32)
    return log_beta, word, counts, mask, gamma_prev


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


def test_bf16_rounding_of_tiny_beta_matches_xla():
    """exp(log beta) rounded to bf16 as the port's sparse table rounds it
    (exp_beta_table: subnormals flushed, then torch's CPU round to
    nearest even) and as the JAX package's slab is (XLA's exp and
    convert): the same bits, on a beta whose entries run from normal
    values through float32's smallest normals (log 1.17549435e-38 =
    -87.336...) into its subnormal range, and on exact ties between two
    bf16 values.  The dense mode's rounding (dense_estep.round_bf16) is
    the same torch call; the card's __float2bfloat16_rn against it is a
    cuda test (test_torch_kernels.py)."""
    rng = np.random.default_rng(3)
    lb = rng.uniform(-12.0, -0.5, size=(4, 96)).astype(np.float32)
    lb[0, :48] = np.linspace(-87.6, -87.0, 48, dtype=np.float32)
    lb[1, :48] = np.linspace(-103.0, -88.0, 48, dtype=np.float32)
    lb[2, :8] = -100.0                      # the LOG_ZERO floor
    got = tsparse.exp_beta_table(torch.from_numpy(lb), "bf16")
    want = jnp.exp(jnp.asarray(lb)).astype(jnp.bfloat16).T
    assert got.dtype == torch.bfloat16 and got.shape == (96, 4)
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  _bits(want))
    assert not bool(((got > 0) & (got.float() < 1.17549435e-38)).any())
    # Ties: 1 + (2k + 1) 2^-8 lies halfway between two bf16 values; both
    # round to the even one.
    ties = (1.0 + (2 * np.arange(64) + 1) * 2.0 ** -8).astype(np.float32)
    np.testing.assert_array_equal(
        tdense.round_bf16(torch.from_numpy(ties)).numpy(),
        np.asarray(jnp.asarray(ties).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_pad_multiple_and_precision_checks_match_jax():
    """The bucketed layout's batch pad: 8 for f32, 16 for bf16 in both
    packages; an unknown precision raises in both (and in the port's
    dispatch gate and corpus dtype, which the JAX package reaches only
    on the TPU)."""
    for precision in ("f32", "bf16"):
        assert tsparse.pad_multiple_for(precision) == \
            jsparse.pad_multiple_for(precision)
    assert tsparse.pad_multiple_for("bf16") == 16
    for mod in (tsparse, jsparse):
        with pytest.raises(ValueError,
                           match="unknown sparse E-step precision"):
            mod.pad_multiple_for("fp8")
    assert tsparse.available(8, 16, 4, "cpu", "bf16") is False
    with pytest.raises(ValueError, match="unknown sparse E-step precision"):
        tsparse.available(8, 16, 4, "cpu", "fp8")
    with pytest.raises(ValueError, match="unknown dense E-step precision"):
        tdense.corpus_dtype(3.0, "fp8")


@pytest.mark.parametrize("cell", [256, 257], ids=["cell256", "cell257"])
def test_corpus_dtype_and_densify_match_jax(cell):
    """max_dense_cell sums duplicate (doc, word) tokens in both packages
    (a cell of 256 made of 64 tokens of 4, or 257 with one more count);
    corpus_dtype stores bf16 at <= 256 in the bf16 mode only; densify at
    that dtype gives the JAX package's array bit for bit (integer counts
    are exact in bf16 up to 256)."""
    rng = np.random.default_rng(cell)
    word = rng.integers(0, V, size=(B, L + 64)).astype(np.int32)
    counts = rng.integers(0, 5, size=(B, L + 64)).astype(np.float32)
    word[5, :64] = 11
    counts[5, :64] = 4.0
    counts[5, 64] = 1.0 if cell == 257 else 0.0
    word[5, 64] = 11
    word[5, 65:] = np.where(word[5, 65:] == 11, 12, word[5, 65:])
    cmax = tdense.max_dense_cell(word, counts)
    assert cmax == jdense.max_dense_cell(word, counts) == cell
    for precision in ("f32", "bf16"):
        got_dt = tdense.corpus_dtype(cmax, precision)
        want_dt = jdense.corpus_dtype(cmax, precision)
        bf16 = precision == "bf16" and cell <= 256
        assert got_dt == (torch.bfloat16 if bf16 else torch.float32)
        assert want_dt == (jnp.bfloat16 if bf16 else jnp.float32)
        got = tdense.densify(torch.from_numpy(word), torch.from_numpy(counts),
                             V, dtype=got_dt)
        want = jdense.densify(jnp.asarray(word), jnp.asarray(counts), V,
                              dtype=want_dt)
        assert got.dtype == got_dt
        if bf16:
            np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                          _bits(want))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got.float().max()) == cell


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
def test_sparse_e_step_bf16_matches_jax(warm):
    """The whole sparse E-step over the bf16 table against the JAX one
    over its bf16 slab at the same block (8): iterations equal; gamma
    rtol 5e-5 (measured 6.9e-6); likelihood and alpha_ss rtol 1e-6
    (measured 8.5e-8, 1.0e-7); suff-stats within 5e-5 of their largest
    entry (measured 5.3e-6).  JAX's own bf16 is 3.2e-3 from its f32 in
    gamma here, and the port's bf16 at least 20x further from JAX's f32
    gamma than from its bf16 one."""
    lb, word, counts, m, g = _problem(5)
    jkw = dict(gamma_prev=jnp.asarray(g), warm=jnp.int32(1)) if warm else {}
    want = {p: jsparse.e_step(
        jnp.asarray(lb), jnp.float32(2.5), jnp.asarray(word),
        jnp.asarray(counts), jnp.asarray(m), 60, 1e-5, interpret=True,
        precision=p, block=8, **jkw) for p in ("f32", "bf16")}
    tkw = dict(gamma_prev=torch.from_numpy(g), warm=torch.tensor(1)) \
        if warm else {}
    got = tsparse.e_step(
        torch.from_numpy(lb), torch.tensor(2.5), torch.from_numpy(word),
        torch.from_numpy(counts), torch.from_numpy(m), 60, 1e-5, block=8,
        precision="bf16", **tkw)
    w = want["bf16"]
    assert int(got.vi_iters) == int(w.vi_iters)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(w.gamma),
                               rtol=5e-5)
    np.testing.assert_allclose(float(got.likelihood), float(w.likelihood),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got.alpha_ss), float(w.alpha_ss),
                               rtol=1e-6)
    ws = np.asarray(w.suff_stats)
    np.testing.assert_allclose(got.suff_stats.numpy(), ws, rtol=0,
                               atol=5e-5 * np.abs(ws).max())
    assert _rel(got.gamma, want["f32"].gamma) > 20 * _rel(got.gamma, w.gamma)


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("wmajor", [False, True], ids=["rowmajor", "wmajor"])
def test_e_step_dense_bf16_matches_jax(wmajor, warm):
    """The dense E-step in the bf16 mode over a bf16-stored corpus (every
    cell <= 256) against the JAX kernels in interpret mode at the same
    block (8), each layout: iterations equal; gamma rtol 2e-3 (measured
    4.4e-4: a ratio rounded one bf16 step apart moves gamma by about
    that); likelihood and alpha_ss rtol 1e-6 (measured 1.7e-7, 1.1e-7);
    suff-stats within 1e-4 of their largest entry (measured 1.8e-5).
    JAX's own bf16 is 1.9e-2 to 2.4e-2 from its f32 in gamma here, and
    the port's bf16 at least 10x further from JAX's f32 gamma than from
    its bf16 one."""
    lb, word, counts, m, g = _problem(3)
    store = tdense.corpus_dtype(tdense.max_dense_cell(word, counts), "bf16")
    jstore = jdense.corpus_dtype(jdense.max_dense_cell(word, counts), "bf16")
    assert store == torch.bfloat16 and jstore == jnp.bfloat16
    jkw = dict(gamma_prev=jnp.asarray(g), warm=jnp.int32(1)) if warm else {}
    want = {}
    for p, dt in (("f32", None), ("bf16", jstore)):
        jd = jdense.densify(jnp.asarray(word), jnp.asarray(counts), V, dtype=dt)
        want[p] = jdense.e_step_dense(
            jnp.asarray(lb), jnp.float32(2.5), jd.T if wmajor else jd,
            jnp.asarray(m), 60, 1e-5, block=8, interpret=True, wmajor=wmajor,
            precision=p, **jkw)
    td = tdense.densify(torch.from_numpy(word), torch.from_numpy(counts), V,
                        dtype=store)
    tkw = dict(gamma_prev=torch.from_numpy(g), warm=torch.tensor(1)) \
        if warm else {}
    got = tdense.e_step_dense(
        torch.from_numpy(lb), torch.tensor(2.5),
        td.t().contiguous() if wmajor else td, torch.from_numpy(m), 60, 1e-5,
        block=8, wmajor=wmajor, precision="bf16", **tkw)
    w = want["bf16"]
    assert int(got.vi_iters) == int(w.vi_iters)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(w.gamma),
                               rtol=2e-3)
    np.testing.assert_allclose(float(got.likelihood), float(w.likelihood),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got.alpha_ss), float(w.alpha_ss),
                               rtol=1e-6)
    ws = np.asarray(w.suff_stats)
    assert got.suff_stats.shape == ws.shape == (V, K)
    np.testing.assert_allclose(got.suff_stats.numpy(), ws, rtol=0,
                               atol=1e-4 * np.abs(ws).max())
    assert _rel(got.gamma, want["f32"].gamma) > 10 * _rel(got.gamma, w.gamma)


def test_dense_bf16_mode_rounds_operands_not_the_tail():
    """The plain dense fixed point in the bf16 mode against the same
    arithmetic written out: the f32 corpus and its bf16-stored copy give
    the same bits (exact counts), the fixed point differs from f32, and
    the tail from the converged gamma reads f32 beta: a zero-iteration
    bf16 call equals the f32 one."""
    lb, word, counts, m, g = _problem(7)
    eb = tdense.padded_exp_beta(torch.from_numpy(lb), 640)
    d32 = tdense.densify(torch.from_numpy(word), torch.from_numpy(counts), V)
    d16 = d32.to(torch.bfloat16)
    args = (eb, torch.tensor(2.5))
    rest = (torch.from_numpy(m), 60, 1e-5, 8)
    a = tdense.dense_fixed_point_reference(*args, d32, *rest, precision="bf16")
    b = tdense.dense_fixed_point_reference(*args, d16, *rest, precision="bf16")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    f = tdense.dense_fixed_point_reference(*args, d32, *rest)
    assert not torch.equal(a[0], f[0])
    warm = dict(gamma_prev=a[0], warm=torch.tensor(1))
    tail16 = tdense.dense_fixed_point_reference(
        *args, d16, torch.from_numpy(m), 0, 1e-5, 8, precision="bf16", **warm)
    tail32 = tdense.dense_fixed_point_reference(
        *args, d32, torch.from_numpy(m), 0, 1e-5, 8, **warm)
    for x, y in zip(tail16[:4], tail32[:4]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="needs precision 'bf16'"):
        tdense.fixed_point_blocks(eb, torch.tensor(2.5), d16,
                                  torch.from_numpy(m), 60, 1e-5)


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

FK, FV, DOCS, EM_ITERS = 5, 200, 48, 4
# The dense family's fits run 2 EM iterations.  Its bf16 mode rounds the
# ratio of every cell on every fixed-point iteration, and a ratio that
# lands one bf16 step apart in the two packages (the exact divide against
# the Newton reciprocal, f32 sums in another order) moves that document's
# gamma, which the next EM iteration carries into beta: measured on this
# corpus, port against JAX in bf16, gamma rel 5.6e-7 after one iteration,
# 2.9e-5 after two and 0.18 after four, while JAX's own bf16 fit is 0.13
# (two) and 0.57 (four) from its f32 one.  The likelihood stays within
# 2e-6 throughout.  The sparse mode rounds only the table, once, and
# holds the f32 fits' tolerances over 4 iterations and more.
DENSE_EM_ITERS = 2


def _triples():
    """48 docs of 1..40 distinct words out of 200, topic-structured (the
    corpus of tests/test_torch_engine.py)."""
    rng = np.random.default_rng(23)
    topics = rng.dirichlet(np.full(FV, 0.05), size=4)
    out = []
    for d in range(DOCS):
        theta = rng.dirichlet(np.full(4, 0.3))
        for w in rng.choice(FV, size=int(rng.integers(1, 41)),
                            p=theta @ topics):
            out.append((f"ip{d}", f"w{w}", int(rng.integers(1, 6))))
    return out


@pytest.fixture(scope="module")
def corpora():
    trips = _triples()
    return Corpus.from_word_counts(trips), JCorpus.from_word_counts(trips)


@pytest.fixture()
def at_port_blocks(monkeypatch, tmp_path):
    """The JAX kernels at the port's doc blocks (the per-block stop then
    decides alike), a hermetic plan cache, no engine env."""
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "plans.jsonl"))
    monkeypatch.delenv("ONI_ML_TPU_ESTEP", raising=False)
    monkeypatch.delenv("ONI_ML_TPU_ESTEP_ENGINE", raising=False)
    monkeypatch.setattr(jsparse, "pick_block",
                        lambda b, l, k, precision="f32": tsparse.pick_block(b))
    for name in ("pick_block", "pick_block_w"):
        monkeypatch.setattr(jdense, name, lambda b, v, k, precision="f32":
                            tdense.pick_block(b, v, k))


def _jax_init(num_terms, k=FK, seed=0):
    return np.asarray(jlda.init_log_beta(jax.random.PRNGKey(seed), k,
                                         num_terms))


def _assert_fit_close(got, want, ll, beta, gamma, alpha):
    """em_iters equal, the same LOG_ZERO set; likelihoods, beta (as
    probabilities above 1e-12), gamma and alpha at the given rtols."""
    assert got.em_iters == want.em_iters
    np.testing.assert_allclose(np.asarray(got.likelihoods)[:, 0],
                               np.asarray(want.likelihoods)[:, 0], rtol=ll)
    np.testing.assert_array_equal(got.log_beta == -100.0,
                                  np.asarray(want.log_beta) == -100.0)
    np.testing.assert_allclose(np.exp(got.log_beta),
                               np.exp(np.asarray(want.log_beta)), rtol=beta,
                               atol=1e-12)
    np.testing.assert_allclose(got.gamma, np.asarray(want.gamma), rtol=gamma)
    np.testing.assert_allclose(got.alpha, float(want.alpha), rtol=alpha)


COMMON = dict(num_topics=FK, em_max_iters=EM_ITERS, em_tol=1e-12,
              batch_size=8, seed=0, dense_precision="bf16")


@pytest.mark.parametrize("chunk", [1, 128], ids=["stepwise", "chunked"])
def test_sparse_train_corpus_bf16_matches_jax(corpora, at_port_blocks,
                                              chunk):
    """The sparse engine in bf16 under the port's stepwise and chunk
    drivers against the JAX package's bf16 sparse engine (stepwise) from
    the same initial beta: the bucketed batches padded to 16 in both;
    likelihoods rtol 1e-5, beta rtol 1e-4, gamma rtol 1e-4, alpha rtol
    1e-5, the f32 fits' tolerances (tests/test_torch_lda.py)."""
    corpus, jcorpus = corpora
    kw = dict(COMMON, estep_engine="sparse", sparse_min_bucket_len=16)
    want = jlda.train_corpus(jcorpus, JLDAConfig(fused_em_chunk=1, **kw))
    got = train_corpus(corpus, LDAConfig(fused_em_chunk=chunk, **kw),
                       initial_log_beta=_jax_init(corpus.num_terms),
                       device="cpu")
    assert got.stats["member"] == "sparse"
    assert got.stats["dense_precision"] == "bf16"
    assert all(b % 16 == 0 for b, _ in got.stats["batch_shapes"])
    _assert_fit_close(got, want, ll=1e-5, beta=1e-4, gamma=1e-4, alpha=1e-5)
    f32 = train_corpus(corpus, LDAConfig(fused_em_chunk=chunk,
                                         **dict(kw, dense_precision="f32")),
                       initial_log_beta=_jax_init(corpus.num_terms),
                       device="cpu")
    assert not np.array_equal(f32.log_beta, got.log_beta)


@pytest.mark.parametrize("path,batch", [("dense", 8), ("dense", 64),
                                        ("compact", 8)],
                         ids=["dense", "dense_fast_path", "compact"])
def test_dense_family_train_corpus_bf16_matches_jax(corpora, at_port_blocks,
                                                    monkeypatch, path, batch):
    """The dense family in bf16 (full-V dense over several batches, over
    one batch, which takes the chunk driver's fast path, and compact),
    each with a bf16-stored corpus, against the JAX package forced the
    same way, from the same initial beta, over DENSE_EM_ITERS: likelihoods
    rtol 1e-5 (measured up to 1.1e-7), beta rtol 2e-4 (2.3e-5), gamma rtol
    2e-4 (2.9e-5), alpha rtol 2e-5 (4.3e-6)."""
    corpus, jcorpus = corpora
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", path)
    kw = dict(COMMON, batch_size=batch, em_max_iters=DENSE_EM_ITERS)
    want = jlda.train_corpus(jcorpus, JLDAConfig(**kw))
    got = train_corpus(corpus, LDAConfig(**kw),
                       initial_log_beta=_jax_init(corpus.num_terms),
                       device="cpu")
    assert got.stats["member"] == path
    assert got.stats["dense_precision"] == "bf16"
    _assert_fit_close(got, want, ll=1e-5, beta=2e-4, gamma=2e-4, alpha=2e-5)


def test_mesh_dense_bf16_fit_matches_jax(corpora, at_port_blocks):
    """A (2, 1) data-parallel fit of the full-V dense member in bf16 (the
    dense kernel's plain version on each data slot) against the JAX
    package's (2, 1) mesh on its virtual CPU devices, from the same
    initial beta, over DENSE_EM_ITERS, at the dense fits' tolerances
    above."""
    corpus, jcorpus = corpora
    kw = dict(COMMON, batch_size=16, dense_em="on",
              em_max_iters=DENSE_EM_ITERS)
    want = jlda.train_corpus(jcorpus, JLDAConfig(**kw),
                             mesh=jpar.make_mesh(data=2, model=1))
    got = train_corpus(corpus, LDAConfig(**kw),
                       mesh=tpar.make_mesh(2, 1, device="cpu"),
                       initial_log_beta=_jax_init(corpus.num_terms))
    assert got.stats["member"] == "dense"
    assert got.stats["mesh"]["shape"] == [2, 1]
    assert got.stats["dense_precision"] == "bf16"
    _assert_fit_close(got, want, ll=1e-5, beta=2e-4, gamma=2e-4, alpha=2e-5)


def test_multihost_sparse_bf16_two_ranks_match_jax(tmp_path,
                                                   at_port_blocks):
    """Two rank processes train the sparse engine in bf16 by distributed
    EM over the CPU collective (kvring over a file KV), 8 shards, each
    shard's bucketed layout padded to 16; against the JAX package's
    distributed fit in one process (JAX lda.py pads and runs it in bf16
    too), from the same initial beta: every rank the same bytes, and the
    f32 distributed fit's tolerances against JAX over its 10 EM
    iterations (tests/test_torch_multihost.py: likelihoods rtol 2e-5,
    beta rtol 2e-3 above 1e-12, gamma and alpha rtol 2e-4; measured beta
    9.4e-4 on one entry of 1e-5)."""
    sys.path.insert(0, TESTS)
    from torch_collective_worker import SPARSE_BF16_CONFIG, window_triples

    trips = window_triples()
    jcorpus = JCorpus.from_word_counts(trips)
    cfg = dict(SPARSE_BF16_CONFIG)
    init = _jax_init(jcorpus.num_terms, k=cfg["num_topics"], seed=cfg["seed"])
    kv = tmp_path / "kv"
    outs = [str(tmp_path / f"r{r}.npz") for r in range(2)]
    np.save(str(tmp_path / "init.npy"), init)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_collective_worker.py"),
         "file", str(kv), str(r), "2", "sparse_bf16", outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(o)) for o in outs]
    for key, value in ranks[0].items():
        assert ranks[1][key].tobytes() == value.tobytes(), key
    got = ranks[0]
    assert str(got["member"]) == "sparse" and str(got["precision"]) == "bf16"
    assert (got["batch_rows"] % 16 == 0).all()
    want = jlda.train_corpus(jcorpus, JLDAConfig(**cfg), distributed=True)
    assert want.plan["estep_engine"]["value"] == "sparse"
    assert int(got["em_iters"]) == want.em_iters
    np.testing.assert_allclose(got["lls"], [ll for ll, _ in want.likelihoods],
                               rtol=2e-5)
    np.testing.assert_array_equal(got["log_beta"] == -100.0,
                                  np.asarray(want.log_beta) == -100.0)
    np.testing.assert_allclose(np.exp(got["log_beta"]),
                               np.exp(np.asarray(want.log_beta)), rtol=2e-3,
                               atol=1e-12)
    np.testing.assert_allclose(got["gamma"], np.asarray(want.gamma),
                               rtol=2e-4)
    np.testing.assert_allclose(float(got["alpha"]), float(want.alpha),
                               rtol=2e-4)


# ---------------------------------------------------------------------------
# The runner's flag
# ---------------------------------------------------------------------------


def _lda_record(day) -> dict:
    with open(os.path.join(day, "metrics.json")) as f:
        return next(r for r in json.load(f) if r.get("stage") == "lda")


def test_runner_dense_precision_flag(tmp_path, monkeypatch):
    """`--dense-precision` takes the JAX choices with the default f32 (an
    unknown value exits 2); on a synthetic flow day with the sparse
    engine pinned, bf16 reaches the kernel (the lda record names it, the
    batches pad to 16, the likelihood trajectory differs from the f32
    day's) and its final likelihood lies within the JAX package's
    bf16-against-f32 bound (rel 5e-3) of the f32 day's; the default
    writes the bytes of a run without the flag.  (Both modes end on the
    same beta here: at 48 EM iterations every word of this small day
    sits in one topic, whose beta is then its count over the topic's.)"""
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.synth import write_flow_day

    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "plans.jsonl"))
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "sparse")
    raw = tmp_path / "flow.csv"
    with open(raw, "w") as f:
        write_flow_day(f, 1500, n_src=50, n_dst=30, seed=9)
    with pytest.raises(SystemExit) as exc:
        ml_ops.main(["20160122", "flow", "1.1", "--dense-precision", "fp8"])
    assert exc.value.code == 2

    def day(name, *extra):
        data = tmp_path / name
        assert ml_ops.main(["20160122", "flow", "1.1", "--flow-path",
                            str(raw), "--data-dir", str(data), "--device",
                            "cpu", "--pre-workers", "1", *extra]) == 0
        return str(data / "20160122")

    plain, f32, bf16 = (day("plain"), day("f32", "--dense-precision", "f32"),
                        day("bf16", "--dense-precision", "bf16"))
    for name in ("final.beta", "final.gamma", "final.other",
                 "likelihood.dat", "flow_results.csv"):
        with open(os.path.join(plain, name), "rb") as a, \
                open(os.path.join(f32, name), "rb") as b:
            assert a.read() == b.read(), name
    rec, rec32 = _lda_record(bf16), _lda_record(f32)
    assert (rec["engine"], rec["member"], rec["dense_precision"]) == (
        "sparse", "sparse", "bf16")
    assert rec32["dense_precision"] == "f32"
    assert all(b % 16 == 0 for b, _ in rec["batch_shapes"])
    with open(os.path.join(bf16, "likelihood.dat")) as a, \
            open(os.path.join(f32, "likelihood.dat")) as b:
        assert a.read() != b.read()
    np.testing.assert_allclose(rec["final_likelihood"],
                               rec32["final_likelihood"], rtol=5e-3)
