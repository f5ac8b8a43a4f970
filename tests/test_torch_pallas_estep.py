"""The port's fixed-point module (ops/pallas_estep.py) and the per-batch
E-step dispatch (ops/estep.py e_step) against the JAX package on the
CPU: the plain version of csrc/fixed_point_estep.cu against the Pallas
kernel in interpret mode at the same doc block, the pallas drop-in
against JAX's, and each backend of the dispatch against its JAX
counterpart, on seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oni_ml_tpu.ops import dense_estep as jdense
from oni_ml_tpu.ops import estep as jestep
from oni_ml_tpu.ops import pallas_estep as jpallas
from oni_ml_tpu.ops import sparse_estep as jsparse
from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import estep as testep
from oni_ml_tpu_torch.ops import pallas_estep as tpallas
from oni_ml_tpu_torch.ops import sparse_estep as tsparse

K, V, B, L = 5, 60, 16, 32


def _problem(seed):
    """A padded batch: docs of 4..L live tokens, zero padding after, a
    few masked docs, a warm-start gamma near the fresh one."""
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


def _warm_kw(g, warm, lib):
    if not warm:
        return {}
    if lib == "jax":
        return {"gamma_prev": jnp.asarray(g), "warm": jnp.int32(1)}
    return {"gamma_prev": torch.from_numpy(g), "warm": torch.tensor(1)}


def _assert_results_match(got, want):
    """gamma, suff_stats, alpha_ss and likelihood rtol 1e-5 (suff_stats
    with an absolute floor of 1e-6 of its largest entry), iters equal."""
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


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("block", [1, 4])
def test_fixed_point_reference_matches_pallas_interpret(block, warm):
    """The plain version against `_fixed_point_kernel` in interpret mode
    at the same doc block, under a cap every block stops below (at
    var_tol 1e-5: at 1e-6 these slow random inputs put a block's stop
    within f32 noise of the stall exit, where two summation orders can
    move it by one): gamma rtol 1e-5, the per-block iteration counts
    reduce to the JAX max (JAX returns only the max)."""
    lb, a, w, c, m, g = _problem(11)
    slab = np.exp(lb)[:, w]                               # [K, B, L]
    jg, jit = jpallas.fixed_point(
        jnp.asarray(slab), jnp.float32(a), jnp.asarray(c), jnp.asarray(m),
        200, 1e-5, block=block, interpret=True, **_warm_kw(g, warm, "jax"))
    tg, tit = tpallas.fixed_point_reference(
        torch.from_numpy(slab), torch.tensor(a), torch.from_numpy(c),
        torch.from_numpy(m), 200, 1e-5, block, **_warm_kw(g, warm, "torch"))
    assert tit.shape == (B // block,)
    assert int(tit.max()) == int(jit) < 200
    assert int(tit.min()) < int(tit.max())
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5)


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
def test_pallas_e_step_matches_jax_interpret(warm):
    """The port's e_step(backend="pallas") at JAX's own block pick
    (pallas_estep.pick_block(B, L, K): the card's rule picks another
    block at this B, so the block is always passed) against JAX's
    pallas_estep.e_step in interpret mode."""
    lb, a, w, c, m, g = _problem(12)
    bb = jpallas.pick_block(B, L, K)
    assert bb is not None and bb != tpallas.pick_block(B)
    want = jpallas.e_step(jnp.asarray(lb), jnp.float32(a), jnp.asarray(w),
                          jnp.asarray(c), jnp.asarray(m), 40, 1e-6,
                          interpret=True, **_warm_kw(g, warm, "jax"))
    got = testep.e_step(torch.from_numpy(lb), torch.tensor(a),
                        torch.from_numpy(w), torch.from_numpy(c),
                        torch.from_numpy(m), 40, 1e-6, backend="pallas",
                        block=bb, **_warm_kw(g, warm, "torch"))
    _assert_results_match(got, want)


@pytest.fixture()
def port_blocks(monkeypatch):
    """The JAX sparse and dense kernels at the port's doc blocks, so the
    per-block stops decide alike."""
    monkeypatch.setattr(jsparse, "pick_block",
                        lambda b, l, k, precision="f32": tsparse.pick_block(b))
    for name in ("pick_block", "pick_block_w"):
        monkeypatch.setattr(jdense, name, lambda b, v, k, precision="f32":
                            tdense.pick_block(b, v, k))


@pytest.mark.parametrize("backend", ["auto", "xla", "sparse", "dense",
                                     "pallas"])
def test_dispatch_backends_match_jax(port_blocks, monkeypatch, backend):
    """Each backend of the port's dispatch against its JAX counterpart
    on the CPU, warm: JAX estep.e_step(backend=...) for auto (xla off
    the TPU), xla, sparse and dense (the Pallas kernels in interpret
    mode); for pallas, JAX's module function in interpret mode (its
    dispatch would call it without interpret mode), at the port's
    block."""
    monkeypatch.delenv("ONI_ML_TPU_ESTEP", raising=False)
    lb, a, w, c, m, g = _problem(13)
    args_j = (jnp.asarray(lb), jnp.float32(a), jnp.asarray(w), jnp.asarray(c),
              jnp.asarray(m), 40, 1e-6)
    if backend == "pallas":
        monkeypatch.setattr(jpallas, "pick_block",
                            lambda b, l, k, precision="f32": tpallas.pick_block(b))
        want = jpallas.e_step(*args_j, interpret=True, **_warm_kw(g, True, "jax"))
    else:
        want = jestep.e_step(*args_j, backend=backend,
                             **_warm_kw(g, True, "jax"))
    assert testep.resolve_backend(backend, B, L, K, "cpu") == (
        "xla" if backend == "auto" else backend)
    got = testep.e_step(torch.from_numpy(lb), torch.tensor(a),
                        torch.from_numpy(w), torch.from_numpy(c),
                        torch.from_numpy(m), 40, 1e-6, backend=backend,
                        **_warm_kw(g, True, "torch"))
    _assert_results_match(got, want)


@pytest.mark.parametrize("env,path", [("dense", "xla"), ("compact", "xla"),
                                      ("xla", "xla"), ("pallas", "pallas"),
                                      ("sparse", "sparse")])
def test_env_overrides_auto_but_not_with_driver_hints(monkeypatch, env, path):
    """ONI_ML_TPU_ESTEP overrides "auto"; dense and compact there are the
    drivers' hints, which "auto" ignores (xla on the CPU, as JAX's auto
    resolves off the TPU); an explicit backend beats the env.  On the
    card "auto" is the sparse kernel (any L, K <= 64); above the kernels'
    compiled bound it raises, and plain ops run there only when named."""
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", env)
    assert testep.resolve_backend("auto", B, L, K, "cpu") == path
    assert testep.resolve_backend("xla", B, L, K, "cpu") == "xla"
    monkeypatch.delenv("ONI_ML_TPU_ESTEP")
    assert testep.resolve_backend("auto", B, L, K, "cuda") == "sparse"
    with pytest.raises(ValueError, match="compiled for at most 64"):
        testep.resolve_backend("auto", B, L, 65, "cuda")
    assert testep.resolve_backend("xla", B, L, 65, "cuda") == "xla"
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "xla")
    assert testep.resolve_backend("auto", B, L, 65, "cuda") == "xla"


def test_unknown_backend_and_lone_gamma_prev_raise(monkeypatch):
    """An unknown backend raises, from the argument and from the env, as
    JAX's dispatch does; gamma_prev without `warm` raises on every
    backend."""
    lb, a, w, c, m, g = _problem(14)
    args = (torch.from_numpy(lb), torch.tensor(a), torch.from_numpy(w),
            torch.from_numpy(c), torch.from_numpy(m), 10, 1e-6)
    with pytest.raises(ValueError, match="unknown E-step backend"):
        testep.e_step(*args, backend="bogus")
    with pytest.raises(ValueError, match="unknown E-step backend"):
        jestep.e_step(*(jnp.asarray(x) for x in (lb, a, w, c, m)), 10, 1e-6,
                      backend="bogus")
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "bogus")
    with pytest.raises(ValueError, match="unknown E-step backend"):
        testep.e_step(*args)
    monkeypatch.delenv("ONI_ML_TPU_ESTEP")
    for backend in testep.BACKENDS:
        with pytest.raises(ValueError, match="explicit `warm` gate"):
            testep.e_step(*args, backend=backend,
                          gamma_prev=torch.from_numpy(g))


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
def test_xla_fixed_point_device_stop_matches_host_stop(warm):
    """The xla fixed point as the card runs it (every one of the
    var_max_iters iterations enqueued, a stopped one leaving the state
    as it was, no host read) gives the bits and the iteration count of
    the loop that leaves at the stop."""
    lb, a, w, c, m, g = _problem(16)
    beta_bt = testep.gather_beta(torch.from_numpy(lb), torch.from_numpy(w))
    args = (beta_bt, torch.tensor(a), torch.from_numpy(c),
            torch.from_numpy(m), 40, 1e-3)
    kw = _warm_kw(g, warm, "torch")
    host = testep.fixed_point(*args, host_stop=True, **kw)
    dev = testep.fixed_point(*args, host_stop=False, **kw)
    assert 0 < int(host[1]) < 40
    assert torch.equal(host[0], dev[0]) and int(host[1]) == int(dev[1])


def test_pick_block_and_routing():
    """The card's block rule (the sparse kernel's), CPU tensors take the
    plain version and count no launch, other devices raise."""
    assert tpallas.pick_block(1024) == 4
    assert tpallas.pick_block(8) == 1
    assert tpallas.pick_block(4096) == 8
    lb, a, w, c, m, _ = _problem(15)
    slab = torch.from_numpy(np.exp(lb)[:, w])
    args = (slab, torch.tensor(a), torch.from_numpy(c), torch.from_numpy(m),
            20, 1e-6)
    tpallas.reset_launch_count()
    got = tpallas.fixed_point_blocks(*args, block=4)
    want = tpallas.fixed_point_reference(*args, 4)
    assert tpallas.launch_count == 0
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    meta = (slab.to("meta"), args[1], args[2].to("meta"), args[3].to("meta"),
            20, 1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        tpallas.fixed_point_blocks(*meta, block=1)
    assert tpallas.available(B, 4096, 20, "cuda")
    assert not tpallas.available(B, L, 20, "cpu")
    assert not tpallas.available(B, L, 65, "cuda")
