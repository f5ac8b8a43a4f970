"""The port's E-step ops against the JAX package on identical numpy
inputs: the stop rule, the in-kernel special functions, the plain
sparse E-step (the CUDA kernel's CPU version) against the Pallas kernel
in interpret mode, the batch-wide XLA path, the M-step and the alpha
Newton.  The CUDA kernel against its plain version is in
test_torch_kernels.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.ops import estep as jestep
from oni_ml_tpu.ops import pallas_estep as jpallas
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu.ops import stop as jstop
from oni_ml_tpu_torch.models import lda as tlda
from oni_ml_tpu_torch.ops import estep as testep
from oni_ml_tpu_torch.ops import sparse_estep as tsparse
from oni_ml_tpu_torch.ops import special as tspecial
from oni_ml_tpu_torch.ops import stop as tstop

K, V, B, L = 6, 60, 32, 16


def _problem(seed=0):
    """A padded bucket: docs of 4..L live tokens, zero padding after,
    a few masked docs; beta from the JAX init's noise recipe."""
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
    return log_beta, np.float32(2.5), word, counts, mask, gamma_prev


def test_fp_continue_matches_jax():
    vals = [0.0, 1e-7, 1e-6, 5e-3, 1e-2, 0.5, float("inf")]
    for it, delta, prev in itertools.product([0, 1, 5, 20], vals, vals):
        want = bool(jstop.fp_continue(jnp.int32(it), jnp.float32(delta),
                                      jnp.float32(prev), 20, 1e-6))
        got = bool(tstop.fp_continue(it, torch.tensor(delta),
                                     torch.tensor(prev), 20, 1e-6))
        assert got == want, (it, delta, prev)
    assert tstop.STALL_GATE == jstop.STALL_GATE


@pytest.mark.parametrize("fn", ["digamma_pos", "gammaln_pos"])
def test_special_functions_match_jax(fn):
    # Same recurrence and series in both; the only differences are the
    # two libraries' float32 log (1 ulp) — hence rtol 2e-6 with an
    # absolute floor of 2e-6 near the functions' zeros.
    x = np.concatenate([
        np.random.default_rng(1).uniform(1e-3, 60.0, 2000),
        [1e-4, 0.5, 1.0, 1.4616, 2.0, 5.999, 6.0, 6.001, 1e4],
    ]).astype(np.float32)
    want = np.asarray(getattr(jpallas, fn)(jnp.asarray(x)))
    got = getattr(tspecial, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def _jax_sparse(prob, block, warm, var_max_iters=40, var_tol=1e-6):
    lb, a, w, c, m, g = prob
    kw = {}
    if warm:
        kw = {"gamma_prev": jnp.asarray(g), "warm": jnp.int32(1)}
    return jsparse.e_step(jnp.asarray(lb), jnp.float32(a), jnp.asarray(w),
                          jnp.asarray(c), jnp.asarray(m), var_max_iters,
                          var_tol, interpret=True, block=block, **kw)


def _port_sparse(prob, block, warm, var_max_iters=40, var_tol=1e-6):
    lb, a, w, c, m, g = prob
    kw = {}
    if warm:
        kw = {"gamma_prev": torch.from_numpy(g), "warm": torch.tensor(1)}
    return tsparse.e_step(torch.from_numpy(lb), torch.tensor(a),
                          torch.from_numpy(w), torch.from_numpy(c),
                          torch.from_numpy(m), var_max_iters, var_tol,
                          block=block, **kw)


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("block", [None, 8], ids=["port_block", "block8"])
def test_plain_sparse_estep_matches_pallas_interpret(block, warm):
    """The kernel's plain version against the Pallas kernel run in
    interpret mode at the same doc block: same stop decisions (iters
    equal) and the same numbers to float32 rounding — rtol 1e-5 on
    gamma, suff-stats (absolute floor 1e-6 of the largest entry, for
    near-empty vocabulary rows), likelihood and alpha_ss."""
    prob = _problem()
    bb = block or tsparse.pick_block(B)
    want = _jax_sparse(prob, bb, warm)
    got = _port_sparse(prob, bb, warm)
    assert int(got.vi_iters) == int(want.vi_iters)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               rtol=1e-5)
    ws = np.asarray(want.suff_stats)
    np.testing.assert_allclose(got.suff_stats.numpy(), ws, rtol=1e-5,
                               atol=1e-6 * np.abs(ws).max())
    np.testing.assert_allclose(float(got.likelihood), float(want.likelihood),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.alpha_ss), float(want.alpha_ss),
                               rtol=1e-5)


def test_fixed_point_full_layout_and_per_block_iters():
    """fixed_point_full keeps the JAX layout (phi_c [K, B, L]) and the
    per-block iteration counts reduce to the JAX max.  phi_c gets rtol
    5e-5: it compounds gamma's float32 agreement (rtol 1e-5) through
    exp(digamma(gamma)) and the per-token normalizer."""
    lb, a, w, c, m, _ = _problem(3)
    bb = 8
    jg, jphic, jdocll, jass, jit = jsparse.fixed_point_full(
        jnp.exp(jnp.asarray(lb))[:, jnp.asarray(w)], jnp.float32(a),
        jnp.asarray(c), jnp.asarray(m), 30, 1e-6, block=bb, interpret=True)
    tg, tphic, tdocll, tass, tit = tsparse.fixed_point_full(
        tsparse.exp_beta_table(torch.from_numpy(lb)), torch.tensor(a),
        torch.from_numpy(w), torch.from_numpy(c), torch.from_numpy(m),
        30, 1e-6, block=bb)
    assert tuple(tphic.shape) == (K, B, L) == np.asarray(jphic).shape
    assert int(tit) == int(jit)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5)
    np.testing.assert_allclose(tphic.numpy(), np.asarray(jphic), rtol=5e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tdocll.numpy(), np.asarray(jdocll), rtol=1e-5)
    np.testing.assert_allclose(tass.numpy(), np.asarray(jass), rtol=1e-5)


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
def test_plain_estep_matches_jax_xla(warm):
    """The port's batch-wide XLA-path counterpart against JAX's
    estep.e_step(backend="xla"): same stop rule on the same batch, so
    iters equal and rtol 1e-5 throughout."""
    lb, a, w, c, m, g = _problem(1)
    kw_j = kw_t = {}
    if warm:
        kw_j = {"gamma_prev": jnp.asarray(g), "warm": jnp.int32(1)}
        kw_t = {"gamma_prev": torch.from_numpy(g), "warm": torch.tensor(1)}
    want = jestep.e_step(jnp.asarray(lb), jnp.float32(a), jnp.asarray(w),
                         jnp.asarray(c), jnp.asarray(m), 40, 1e-6,
                         backend="xla", **kw_j)
    got = testep.e_step(torch.from_numpy(lb), torch.tensor(a),
                        torch.from_numpy(w), torch.from_numpy(c),
                        torch.from_numpy(m), 40, 1e-6, **kw_t)
    assert int(got.vi_iters) == int(want.vi_iters)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               rtol=1e-5)
    ws = np.asarray(want.suff_stats)
    np.testing.assert_allclose(got.suff_stats.numpy(), ws, rtol=1e-5,
                               atol=1e-6 * np.abs(ws).max())
    np.testing.assert_allclose(float(got.likelihood), float(want.likelihood),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.alpha_ss), float(want.alpha_ss),
                               rtol=1e-5)


def test_sparse_block_rule_vs_xla_batch_rule():
    """Per-block stop (sparse) against the batch-wide stop (JAX XLA
    path).  Both stop once their max relative delta is under var_tol;
    a block whose docs converged early stops earlier than the batch, so
    the two agree to the var_tol scale: at var_tol=1e-7, gamma within
    rtol 1e-4 (1000 var_tol — the residual error of a contraction that
    stops at delta <= var_tol is a small multiple of it), likelihood
    within 1e-5."""
    lb, a, w, c, m, _ = _problem(2)
    want = jestep.e_step(jnp.asarray(lb), jnp.float32(a), jnp.asarray(w),
                         jnp.asarray(c), jnp.asarray(m), 300, 1e-7,
                         backend="xla")
    got = _port_sparse((lb, a, w, c, m, None), None, False, 300, 1e-7)
    sel = m == 1
    np.testing.assert_allclose(got.gamma.numpy()[sel],
                               np.asarray(want.gamma)[sel], rtol=1e-4)
    np.testing.assert_allclose(float(got.likelihood), float(want.likelihood),
                               rtol=1e-5)


def test_m_step_matches_jax():
    """Zero and subnormal masses both give LOG_ZERO, as XLA (which
    flushes float32 subnormals to zero) gives them: the same LOG_ZERO
    set, and the other entries to rtol 1e-6."""
    rng = np.random.default_rng(4)
    ss = rng.gamma(0.3, 2.0, size=(V, K)).astype(np.float32)
    ss[rng.uniform(size=ss.shape) < 0.2] = 0.0
    tiny = np.finfo(np.float32).tiny
    sub = rng.uniform(size=ss.shape) < 0.1
    ss[sub] = (tiny * rng.uniform(1e-3, 0.99, size=int(sub.sum()))).astype(
        np.float32)
    ss[0, 0], ss[1, 1] = tiny, np.float32(1e-45)   # smallest normal, subnormal
    assert (ss[sub] < tiny).all() and (ss[sub] > 0).all()
    want = np.asarray(jestep.m_step(jnp.asarray(ss)))
    got = testep.m_step(torch.from_numpy(ss)).numpy()
    np.testing.assert_array_equal(got == testep.LOG_ZERO,
                                  want == jestep.LOG_ZERO)
    assert (got[sub.T] == testep.LOG_ZERO).all()
    assert got[0, 0] != testep.LOG_ZERO
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_exp_beta_tables_hold_subnormals_as_zero():
    """exp(log beta) below the normal range is zero in both E-steps'
    beta tables, as XLA computes it; exp(LOG_ZERO) among them."""
    from oni_ml_tpu_torch.ops import dense_estep as tdense

    lb = torch.tensor([[0.0, -80.0, -88.0, -100.0, -103.0]])
    want = torch.tensor([[1.0, float(torch.exp(torch.tensor(-80.0))), 0, 0,
                          0]])
    assert torch.equal(tsparse.exp_beta_table(lb), want.t())
    assert torch.equal(tdense.padded_exp_beta(lb, 8)[:, :5], want)


@pytest.mark.parametrize("max_iters", [8, 100])
@pytest.mark.parametrize("ss,alpha0", [(-6.4e4, 2.5), (-1.2e5, 0.7),
                                       (-8.0e4, 10.0)])
def test_update_alpha_matches_jax(max_iters, ss, alpha0):
    """Both Newton forms against JAX's, from alpha_ss values a D=1000,
    K=20 day produces (mean E[log theta] between -3.2 and -6): float32
    digamma/trigamma from two libraries, so rtol 1e-5."""
    d, k = 1000, 20
    want = float(jlda.update_alpha(jnp.float32(ss), jnp.float32(alpha0), d,
                                   k, max_iters=max_iters))
    got = float(tlda.update_alpha(torch.tensor(ss), torch.tensor(alpha0), d,
                                  k, max_iters=max_iters))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pick_block_and_pad_multiple():
    assert tsparse.pick_block(1024) == 4          # 256 CTAs on 132 SMs
    assert tsparse.pick_block(4096) == 8
    assert tsparse.pick_block(8) == 1
    assert tsparse.pick_block(24) == 1
    for b in (8, 16, 24, 472, 1024, 4096):
        bb = tsparse.pick_block(b)
        assert b % bb == 0 and bb & (bb - 1) == 0
        assert tsparse.pad_multiple_for() % bb == 0
        assert tsparse.pad_multiple_for("bf16") % bb == 0
    assert tsparse.pad_multiple_for("bf16") == 16
    with pytest.raises(ValueError, match="unknown sparse E-step precision"):
        tsparse.pad_multiple_for("fp8")

