"""The port's dense E-step against the JAX package on identical numpy
inputs: make_batches and densify byte for byte, the plain dense fixed
point (the CUDA kernel's CPU version) in both layouts against the Pallas
kernels run in interpret mode at the same doc block, and e_step_dense.
The CUDA kernel against its plain version is in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.io import make_batches as j_make_batches
from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu_torch.io import Corpus, make_batches
from oni_ml_tpu_torch.ops import dense_estep as tdense

# V = 600 pads to W = 640, so the padded tail is in every case.
K, V, B, L = 6, 600, 64, 24


def _corpus(seed=0, docs=150):
    """A ragged corpus of 1..70 distinct words per doc, duplicate
    (doc, word) tokens included."""
    rng = np.random.default_rng(seed)
    triples = []
    for d in range(docs):
        n = int(rng.integers(1, 71))
        for w in rng.integers(0, V, size=n):
            triples.append((f"ip{d}", f"w{w}", int(rng.integers(1, 9))))
    return Corpus.from_word_counts(triples), JCorpus.from_word_counts(triples)


def _problem(seed=0):
    """A densified batch: docs of 4..L tokens, duplicate words summed by
    densify, a few masked docs, a warm-start gamma near the fresh one;
    beta from the JAX init's noise recipe."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(K, V)) + 1.0 / V
    log_beta = np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)
    lens = rng.integers(4, L + 1, size=B)
    live = np.arange(L)[None, :] < lens[:, None]
    word = np.where(live, rng.integers(0, V, size=(B, L)), 0).astype(np.int32)
    counts = np.where(live, rng.integers(1, 5, size=(B, L)), 0).astype(np.float32)
    mask = (rng.uniform(size=B) > 0.15).astype(np.float32)
    mean = 2.5 + counts.sum(1, keepdims=True) / K
    gamma_prev = (mean * rng.uniform(0.5, 1.5, size=(B, K))).astype(np.float32)
    dense = np.array(jdense.densify(jnp.asarray(word), jnp.asarray(counts), V))
    return log_beta, dense, mask, gamma_prev


@pytest.mark.parametrize("min_bucket_len,pad_multiple",
                         [(16, 8), (4, None), (1, 8)])
def test_make_batches_byte_equal_to_jax(min_bucket_len, pad_multiple):
    corpus, jcorpus = _corpus()
    got = make_batches(corpus, 32, min_bucket_len, pad_multiple=pad_multiple)
    want = j_make_batches(jcorpus, 32, min_bucket_len,
                          pad_multiple=pad_multiple)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for name in ("word_idx", "counts", "doc_index", "doc_mask"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), name


def test_densify_equal_to_jax():
    """Integer counts summed per (doc, word): exact in any order."""
    rng = np.random.default_rng(1)
    word = rng.integers(0, V, size=(B, L)).astype(np.int32)
    word[:, :3] = 7                       # duplicate tokens of one word
    counts = rng.integers(0, 5, size=(B, L)).astype(np.float32)
    want = np.asarray(jdense.densify(jnp.asarray(word), jnp.asarray(counts), V))
    got = tdense.densify(torch.from_numpy(word), torch.from_numpy(counts), V)
    assert tdense.padded_width(V) == jdense.padded_width(V) == 640
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_fp(prob, wmajor, warm, block, var_max_iters=60, var_tol=1e-5):
    lb, dense, m, g = prob
    eb = jnp.pad(jnp.exp(jnp.asarray(lb)), ((0, 0), (0, dense.shape[1] - V)))
    fp = jdense.dense_fixed_point_w if wmajor else jdense.dense_fixed_point
    kw = {"gamma_prev": jnp.asarray(g), "warm": jnp.int32(1)} if warm else {}
    return fp(eb, jnp.float32(2.5), jnp.asarray(dense.T if wmajor else dense),
              jnp.asarray(m), var_max_iters, var_tol, block=block,
              interpret=True, **kw)


def _port_fp(prob, wmajor, warm, block, var_max_iters=60, var_tol=1e-5):
    lb, dense, m, g = prob
    eb = tdense.padded_exp_beta(torch.from_numpy(lb), dense.shape[1])
    fp = tdense.dense_fixed_point_w if wmajor else tdense.dense_fixed_point
    kw = {"gamma_prev": torch.from_numpy(g), "warm": torch.tensor(1)} \
        if warm else {}
    c = torch.from_numpy(np.ascontiguousarray(dense.T if wmajor else dense))
    return fp(eb, torch.tensor(2.5), c, torch.from_numpy(m), var_max_iters,
              var_tol, block=block, **kw)


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("wmajor", [False, True], ids=["rowmajor", "wmajor"])
def test_plain_dense_fixed_point_matches_pallas_interpret(wmajor, warm):
    """Each layout against its own Pallas kernel in interpret mode at the
    same doc block (8): the same stop decisions (iters equal); docll and
    ass to rtol 1e-5; gamma and T to rtol 5e-5, T with a floor of 1e-6
    of its largest entry.  f32 products in two libraries sum in another
    order; the fixed point stops at a relative delta of var_tol = 1e-5,
    so those differences reach gamma at about that scale, and T sums 64
    docs' products."""
    prob = _problem()
    want = _jax_fp(prob, wmajor, warm, 8)
    got = _port_fp(prob, wmajor, warm, 8)
    assert int(got[4]) == int(want[4]) > 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=5e-5)
    wt = np.asarray(want[1])
    assert got[1].shape == wt.shape == (K, 640)
    np.testing.assert_allclose(got[1].numpy(), wt, rtol=5e-5,
                               atol=1e-6 * np.abs(wt).max())
    for i in (2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5)


def test_plain_fixed_point_per_block_stop():
    """Per-block stop: with block 4, blocks stop on their own deltas
    (the counts differ between blocks), and the max over blocks equals
    the JAX kernel's iters at the same block."""
    prob = _problem(2)
    lb, dense, m, _ = prob
    eb = tdense.padded_exp_beta(torch.from_numpy(lb), dense.shape[1])
    *_, iters = tdense.fixed_point_blocks(
        eb, torch.tensor(2.5), torch.from_numpy(dense), torch.from_numpy(m),
        60, 1e-5, block=4)
    assert iters.shape == (B // 4,) and int(iters.min()) < int(iters.max())
    assert int(iters.max()) == int(_jax_fp(prob, False, False, 4)[4])


@pytest.mark.parametrize("wmajor", [False, True], ids=["rowmajor", "wmajor"])
def test_e_step_dense_matches_jax(wmajor):
    """The whole dense E-step (suff-stats SS = beta * T over the real
    vocabulary, likelihood, alpha_ss) from a warm start: gamma,
    likelihood and alpha_ss to rtol 1e-5, SS to T's rtol and floor."""
    lb, dense, m, g = _problem(3)
    c = dense.T if wmajor else dense
    want = jdense.e_step_dense(
        jnp.asarray(lb), jnp.float32(2.5), jnp.asarray(c), jnp.asarray(m),
        60, 1e-5, block=8, interpret=True, wmajor=wmajor,
        gamma_prev=jnp.asarray(g), warm=jnp.int32(1))
    got = tdense.e_step_dense(
        torch.from_numpy(lb), torch.tensor(2.5),
        torch.from_numpy(np.ascontiguousarray(c)), torch.from_numpy(m),
        60, 1e-5, block=8, wmajor=wmajor, gamma_prev=torch.from_numpy(g),
        warm=torch.tensor(1))
    assert int(got.vi_iters) == int(want.vi_iters)
    ws = np.asarray(want.suff_stats)
    assert got.suff_stats.shape == ws.shape == (V, K)
    np.testing.assert_allclose(got.suff_stats.numpy(), ws, rtol=5e-5,
                               atol=1e-6 * np.abs(ws).max())
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.likelihood), float(want.likelihood),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.alpha_ss), float(want.alpha_ss),
                               rtol=1e-5)


def test_pick_block_for_the_card():
    """At least one CTA per SM where the batch allows it; BB <= 4, and
    <= 2 above 20 topics (the kernel's register budget); both layouts
    pick alike (no lane rule on the card); the bf16 mode picks the same
    block (both stage f32 cells) and an unknown precision raises."""
    assert tdense.pick_block(1024, 5520, 20) == 4       # 256 CTAs
    assert tdense.pick_block(1024, 5520, 32) == 2
    assert tdense.pick_block(512, 5520, 20) == 2
    assert tdense.pick_block(64, 600, 6) == 1
    assert tdense.pick_block(24, 600, 6) == tdense.pick_block_w(24, 600, 6)
    for b in (8, 16, 24, 472, 1024, 4096):
        bb = tdense.pick_block(b, V, K)
        assert b % bb == 0 and bb & (bb - 1) == 0
    for b in (8, 64, 1024):
        assert tdense.pick_block(b, V, K, precision="bf16") == \
            tdense.pick_block(b, V, K)
    with pytest.raises(ValueError, match="unknown dense E-step precision"):
        tdense.pick_block(64, V, K, precision="fp8")
    with pytest.raises(ValueError, match="outside"):
        tdense.pick_block(64, V, 33)


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("block", [1, 4])
def test_dense_plain_version_equals_the_slab_fixed_point(block, warm):
    """The identity the dense kernel rests on: only the non-zero cells
    count.  dense_fixed_point_reference over a densified batch against
    pallas_estep.fixed_point_reference over the gathered slab of the same
    documents (distinct words, as the bucketed corpus holds them; zero
    padding), at the same block: iteration counts at most one apart per
    block, gamma within rel 1e-5 in the blocks that stop together (the
    two sum the same products over W and over L in another f32 order)."""
    from oni_ml_tpu_torch.ops import pallas_estep as tpallas

    rng = np.random.default_rng(41 + block)
    noise = rng.uniform(size=(K, V)) + 1.0 / V
    lb = torch.from_numpy(np.log(noise / noise.sum(-1, keepdims=True))
                          .astype(np.float32))
    word = np.zeros((B, L), np.int64)
    counts = np.zeros((B, L), np.float32)
    for d, n in enumerate(rng.integers(4, L + 1, size=B)):
        word[d, :n] = rng.choice(V, size=n, replace=False)
        counts[d, :n] = rng.integers(1, 5, size=n)
    mask = torch.from_numpy((rng.uniform(size=B) > 0.15).astype(np.float32))
    mean = 2.5 + counts.sum(1, keepdims=True) / K
    kw = {"warm": torch.tensor(int(warm)), "gamma_prev": torch.from_numpy(
        (mean * rng.uniform(0.5, 1.5, size=(B, K))).astype(np.float32))
        if warm else None}
    word, counts = torch.from_numpy(word), torch.from_numpy(counts)
    eb = tdense.padded_exp_beta(lb, tdense.padded_width(V))
    dense = tdense.densify(word, counts, V)
    gd, *_, itd = tdense.dense_fixed_point_reference(
        eb, torch.tensor(2.5), dense, mask, 200, 1e-5, block, **kw)
    gs, its = tpallas.fixed_point_reference(
        eb[:, word], torch.tensor(2.5), counts, mask, 200, 1e-5, block, **kw)
    assert 1 < int(its.max()) < 200
    assert int((itd - its).abs().max()) <= 1
    same = (itd == its).repeat_interleave(block)
    assert bool(same.any())
    np.testing.assert_allclose(gd[same].numpy(), gs[same].numpy(), rtol=1e-5)


@pytest.mark.parametrize("cells", [None, 128, 4096])
@pytest.mark.parametrize("w", [640, 5632])
@pytest.mark.parametrize("b", [8, 24, 1024])
def test_dense_launch_geometry_within_card_limits(b, w, cells):
    """The block is pick_block's; one warp a document where the batch
    has more blocks than the card has SMs, else CTA_WARPS warps a CTA
    shared evenly by the block's documents;
    the lists' shared memory stays within what a CTA may take (two CTAs
    an SM where the batch has more blocks than the card has SMs); the
    scratch exists exactly where a block's worst case (each document
    with min(W, cells) non-zero cells) would not fit, sized for every
    block's worst case."""
    for k in (6, 20, 32):
        geom = tdense.launch_geometry(b, w, k, cells=cells)
        block = geom["block"]
        assert block == tdense.pick_block(b, w, k) == geom["docs_per_cta"]
        wpd = 1 if b // block > tdense.NUM_SMS else tdense.CTA_WARPS // block
        assert geom["warps_per_doc"] == wpd
        assert geom["threads"] == 32 * block * wpd <= 256
        assert geom["ctas"] == b // block and geom["cluster"] == 1
        cap = (tdense.SMEM_TWO_PER_SM if geom["ctas"] > tdense.NUM_SMS
               else tdense.SMEM_PER_CTA - tdense.SMEM_STATIC)
        assert 0 < geom["smem_bytes"] <= cap <= 232_448
        assert geom["smem_cells"] == geom["smem_bytes"] // (4 * (k + 1))
        per_doc = min(w, cells or w)
        assert geom["block_cells"] == block * per_doc
        worst = block * per_doc * 4 * (k + 1)
        assert geom["smem_bytes"] == min(cap, worst)
        assert geom["scratch_bytes"] == (0 if worst <= geom["smem_bytes"]
                                         else b * per_doc * 4 * (k + 1))
    with pytest.raises(ValueError, match="positive"):
        tdense.launch_geometry(b, w, 20, cells=0)
