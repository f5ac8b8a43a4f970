"""The port's CUDA kernel against its plain PyTorch version.

This file imports no JAX, so it also runs on a machine with a card and
no JAX (the variable keeps tests/conftest.py from importing jax):

    ONI_ML_TPU_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_kernels.py

Without a CUDA device the `cuda` tests skip: a hand-written kernel has
no CPU mode.  The routing tests run everywhere."""

import numpy as np
import pytest
import torch

from oni_ml_tpu_torch.ops import sparse_estep as tsparse

K, V = 6, 60


def _problem(seed, b, l, min_live):
    """A padded bucket: docs of min_live..l live tokens, zero padding
    after, a few masked docs, a warm-start gamma near the fresh one."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(K, V)) + 1.0 / V
    log_beta = np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)
    lens = rng.integers(min_live, l + 1, size=b)
    live = np.arange(l)[None, :] < lens[:, None]
    word = np.where(live, rng.integers(0, V, size=(b, l)), 0).astype(np.int32)
    counts = np.where(live, rng.integers(1, 5, size=(b, l)), 0).astype(np.float32)
    mask = (rng.uniform(size=b) > 0.15).astype(np.float32)
    mean = 2.5 + counts.sum(1, keepdims=True) / K
    gamma_prev = (mean * rng.uniform(0.5, 1.5, size=(b, K))).astype(np.float32)
    return log_beta, np.float32(2.5), word, counts, mask, gamma_prev


def _args(prob, dev, var_max_iters=40, var_tol=1e-6):
    lb, a, w, c, m, _ = prob
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return (tsparse.exp_beta_table(t(lb)), torch.tensor(a, device=dev),
            t(w), t(c), t(m), var_max_iters, var_tol)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    prob = _problem(5, 32, 16, 4)
    tsparse.reset_launch_count()
    got = tsparse.fixed_point_blocks(*_args(prob, "cpu"), block=8)
    want = tsparse.fixed_point_full_reference(*_args(prob, "cpu"), block=8)
    assert tsparse.launch_count == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_other_devices_raise_instead_of_falling_back():
    args = list(_args(_problem(5, 8, 16, 4), "cpu"))
    args[2:5] = [t.to("meta") for t in args[2:5]]
    with pytest.raises(ValueError, match="unsupported device"):
        tsparse.fixed_point_blocks(*args, block=1)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
def test_cuda_kernel_matches_plain_version(cuda, warm):
    """rtol 1e-4 on gamma and phi_c (rcp.approx + one Newton step and
    another float32 summation order), 1e-5 on docll, iterations within
    one per block (the same differences can move one stop decision)."""
    prob = _problem(5, 32, 16, 4)
    kw = {"block": 8, "warm": torch.tensor(int(warm)),
          "gamma_prev": torch.from_numpy(prob[5]).to(cuda) if warm else None}
    args = _args(prob, cuda)
    tsparse.reset_launch_count()
    got = tsparse.fixed_point_blocks(*args, **kw)
    torch.cuda.synchronize()
    assert tsparse.launch_count == 1
    ref = tsparse.fixed_point_full_reference(*args, **kw)
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(got[1].cpu().numpy(), ref[1].cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * float(ref[1].abs().max()))
    np.testing.assert_allclose(got[2].cpu().numpy(), ref[2].cpu().numpy(),
                               rtol=1e-5)
    assert int((got[4] - ref[4]).abs().max()) <= 1


@pytest.mark.cuda
def test_cuda_e_step_long_documents_match_cpu(cuda):
    """A long-doc bucket (L=4096, past any shared-memory slab) through
    the whole e_step on the card and on the CPU: suff-stats rtol 1e-4
    (atomics in the [V, K] index_add_ add in another order), likelihood
    and alpha_ss rtol 1e-5."""
    prob = _problem(7, 8, 4096, 2049)
    lb, a, w, c, m, _ = prob
    res = {}
    for dev in ("cpu", cuda):
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        res[str(dev)] = tsparse.e_step(t(lb), torch.tensor(a), t(w), t(c),
                                       t(m), 40, 1e-6, block=1)
    got, want = res["cuda"], res["cpu"]
    ws = want.suff_stats.numpy()
    np.testing.assert_allclose(got.suff_stats.cpu().numpy(), ws, rtol=1e-4,
                               atol=1e-6 * np.abs(ws).max())
    np.testing.assert_allclose(float(got.likelihood), float(want.likelihood),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.alpha_ss), float(want.alpha_ss),
                               rtol=1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_operands(cuda):
    args = list(_args(_problem(5, 8, 16, 4), cuda))
    args[3] = args[3].double()
    with pytest.raises(TypeError, match="counts must be"):
        tsparse.fixed_point_blocks(*args, block=1)
    args = list(_args(_problem(5, 8, 16, 4), cuda))
    args[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError, match="word_idx must be contiguous"):
        tsparse.fixed_point_blocks(*args, block=1)
