"""The port's CUDA kernels against their plain PyTorch versions: the
sparse E-step and its [V, K] scatter, the dense E-step in both layouts,
and the fixed point over a gathered slab.

This file imports no JAX, so it also runs on a machine with a card and
no JAX (the variable keeps tests/conftest.py from importing jax):

    ONI_ML_TPU_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_kernels.py

Without a CUDA device the `cuda` tests skip: a hand-written kernel has
no CPU mode.  The routing tests run everywhere."""

import numpy as np
import pytest
import torch

from oni_ml_tpu_torch.ops import dense_estep as tdense
from oni_ml_tpu_torch.ops import estep as testep
from oni_ml_tpu_torch.ops import pallas_estep as tpallas
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


def test_executed_counters_read_zero_before_any_launch():
    """The kernels' device counters of the launches that ran: nothing
    launched since the reset reads zero (on a machine without a card
    too: no counter exists until a kernel launches)."""
    tsparse.reset_launch_count()
    tdense.reset_launch_count()
    assert tsparse.executed_counts() == (0, 0)
    assert tdense.executed_count() == 0


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


@pytest.mark.cuda
def test_cuda_scatter_is_bit_identical_to_index_add(cuda):
    """The scatter kernel sums each word's rows in position order, the
    order of the CPU's sequential index_add_: given the same phi_c the
    [V, K] sums are the same bits on every launch and equal the CPU's.
    The card's own index_add_ (atomics) agrees to rtol 1e-6."""
    prob = _problem(9, 32, 64, 4)
    args = _args(prob, cuda)
    phic = tsparse.fixed_point_blocks(*args, block=8)[1]
    live = tsparse.live_tokens(args[2], args[3])
    tsparse.reset_launch_count()
    got = tsparse.scatter_live(phic, live, V)
    again = tsparse.scatter_live(phic, live, V)
    assert tsparse.scatter_launch_count == 2
    ref = tsparse.scatter_live_reference(phic, live, V)
    cpu = tsparse.scatter_live(phic.cpu(), tsparse.live_tokens(
        args[2].cpu(), args[3].cpu()), V)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), cpu)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-6)


def _dense_problem(seed, b, v=600, k=K):
    """A densified batch (V=600 pads to W=640, a padded tail), a few
    masked docs, and a warm-start gamma."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(k, v)) + 1.0 / v
    log_beta = np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)
    l = 24
    word = rng.integers(0, v, size=(b, l)).astype(np.int32)
    counts = rng.integers(1, 5, size=(b, l)).astype(np.float32)
    counts[:, l - 4:] = 0
    mask = (rng.uniform(size=b) > 0.15).astype(np.float32)
    mean = 2.5 + counts.sum(1, keepdims=True) / k
    gamma_prev = (mean * rng.uniform(0.5, 1.5, size=(b, k))).astype(np.float32)
    dense = tdense.densify(torch.from_numpy(word), torch.from_numpy(counts), v)
    return log_beta, dense, mask, gamma_prev


@pytest.mark.cuda
@pytest.mark.parametrize("wmajor", [False, True], ids=["rowmajor", "wmajor"])
@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("block", [1, 2, 4])
def test_cuda_dense_kernel_matches_plain_version(cuda, wmajor, warm, block):
    """Iterations within one per block; gamma rtol 1e-4 (rcp.approx +
    one Newton step and another f32 summation order) in the blocks that
    stop at the same iteration — one that stops an iteration apart
    differs by one fixed-point step, under 2 var_tol by the stop rule's
    own measure; the tail (T rtol 1e-4, docll and ass 1e-5) against the
    plain tail on the kernel's gamma; T bit-identical across two
    launches (no atomics)."""
    lb, dense, mask, gp = _dense_problem(11, 64)
    eb = tdense.padded_exp_beta(torch.from_numpy(lb), dense.shape[1]).to(cuda)
    c = (dense.t() if wmajor else dense).contiguous().to(cuda)
    kw = {"block": block, "wmajor": wmajor, "warm": torch.tensor(int(warm)),
          "gamma_prev": torch.from_numpy(gp).to(cuda) if warm else None}
    var_tol = 1e-5
    args = (eb, torch.tensor(2.5, device=cuda), c,
            torch.from_numpy(mask).to(cuda), 60, var_tol)
    tdense.reset_launch_count()
    got = tdense.fixed_point_blocks(*args, **kw)
    again = tdense.fixed_point_blocks(*args, **kw)
    torch.cuda.synchronize()
    assert tdense.launch_count == 2
    plain = (eb, args[1], dense.to(cuda), args[3])
    ref = tdense.dense_fixed_point_reference(
        *plain, 60, var_tol, block, gamma_prev=kw["gamma_prev"],
        warm=kw["warm"])
    assert torch.equal(got[1], again[1])
    moved = got[4] != ref[4]
    assert int((got[4] - ref[4]).abs().max()) <= 1
    same = ~moved.repeat_interleave(block)
    np.testing.assert_allclose(got[0][same].cpu().numpy(),
                               ref[0][same].cpu().numpy(), rtol=1e-4)
    if bool(moved.any()):
        g, r = got[0][~same].double(), ref[0][~same].double()
        assert float(((g - r).abs().mean(1) / r.mean(1)).max()) <= 2 * var_tol
    tail = tdense.dense_fixed_point_reference(
        *plain, 0, var_tol, block, gamma_prev=got[0], warm=torch.tensor(1))
    rt = tail[1].cpu().numpy()
    np.testing.assert_allclose(got[1].cpu().numpy(), rt, rtol=1e-4,
                               atol=1e-4 * np.abs(rt).max())
    for i in (2, 3):
        r = tail[i].cpu().numpy()
        np.testing.assert_allclose(got[i].cpu().numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


@pytest.mark.cuda
def test_cuda_stop_flag_gates_both_kernels(cuda):
    """The chunk driver's stop flag: clear, the launches compute what
    they compute without it (bit for bit); set, they still launch and
    count, and return at once, so the kernels' own counters of the
    launches that ran leave them out."""
    lb, dense, mask, _ = _dense_problem(12, 16)
    eb = tdense.padded_exp_beta(torch.from_numpy(lb), dense.shape[1]).to(cuda)
    args = (eb, torch.tensor(2.5, device=cuda), dense.to(cuda),
            torch.from_numpy(mask).to(cuda), 20, 1e-6)
    sargs = _args(_problem(5, 32, 16, 4), cuda)
    clear = torch.zeros((), dtype=torch.int32, device=cuda)
    tdense.reset_launch_count()
    tsparse.reset_launch_count()
    for ref, got in (
        (tdense.fixed_point_blocks(*args, block=1),
         tdense.fixed_point_blocks(*args, block=1, stop=clear)),
        (tsparse.fixed_point_blocks(*sargs, block=8),
         tsparse.fixed_point_blocks(*sargs, block=8, stop=clear)),
    ):
        for r, g in zip(ref, got):
            assert torch.equal(r, g)
    tdense.fixed_point_blocks(*args, block=1, stop=clear + 1)
    tsparse.fixed_point_blocks(*sargs, block=8, stop=clear + 1)
    torch.cuda.synchronize()
    assert tdense.launch_count == 3 and tsparse.launch_count == 3
    assert tdense.executed_count() == 2
    assert tsparse.executed_counts() == (2, 0)


@pytest.mark.cuda
def test_cuda_dense_wrapper_rejects_bad_operands(cuda):
    lb, dense, mask, _ = _dense_problem(13, 8)
    eb = tdense.padded_exp_beta(torch.from_numpy(lb), dense.shape[1]).to(cuda)
    a = torch.tensor(2.5, device=cuda)
    m = torch.from_numpy(mask).to(cuda)
    with pytest.raises(TypeError, match="dense_counts must be"):
        tdense.fixed_point_blocks(eb, a, dense.double().to(cuda), m, 20, 1e-6)
    with pytest.raises(ValueError, match="dense_counts must be contiguous"):
        tdense.fixed_point_blocks(eb, a, dense.to(cuda).t(), m, 20, 1e-6,
                                  wmajor=True)
    with pytest.raises(ValueError, match="doc block 8 must be"):
        tdense.fixed_point_blocks(eb, a, dense.to(cuda), m, 20, 1e-6, block=8)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("block", [1, 4, 8])
def test_cuda_fixed_point_kernel_matches_plain_version(cuda, warm, block):
    """csrc/fixed_point_estep.cu against fixed_point_reference on the
    same slab: iterations within one per block; gamma rtol 1e-4
    (rcp.approx + one Newton step and another f32 summation order) in
    the blocks that stop together, the others within 2 var_tol by the
    stop rule's own measure.  With the stop flag clear the launch
    computes the same bits; set, it returns at once and its device
    counter leaves it out."""
    lb, a, w, c, m, gp = _problem(21, 64, 48, 4)
    dev = cuda
    slab = tpallas.gather_slab(
        tsparse.exp_beta_table(torch.from_numpy(lb).to(dev)),
        torch.from_numpy(w).to(dev))
    args = (slab, torch.tensor(a, device=dev), torch.from_numpy(c).to(dev),
            torch.from_numpy(m).to(dev), 80, 1e-5)
    kw = {"block": block, "warm": torch.tensor(int(warm)),
          "gamma_prev": torch.from_numpy(gp).to(dev) if warm else None}
    tpallas.reset_launch_count()
    got = tpallas.fixed_point_blocks(*args, **kw)
    clear = torch.zeros((), dtype=torch.int32, device=dev)
    again = tpallas.fixed_point_blocks(*args, stop=clear, **kw)
    tpallas.fixed_point_blocks(*args, stop=clear + 1, **kw)
    torch.cuda.synchronize()
    assert tpallas.launch_count == 3 and tpallas.executed_count() == 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref = tpallas.fixed_point_reference(*args, block, gamma_prev=kw["gamma_prev"],
                                        warm=kw["warm"])
    assert int((got[1] - ref[1]).abs().max()) <= 1
    moved = got[1] != ref[1]
    same = ~moved.repeat_interleave(block)
    np.testing.assert_allclose(got[0][same].cpu().numpy(),
                               ref[0][same].cpu().numpy(), rtol=1e-4)
    if bool(moved.any()):
        g, r = got[0][~same].double(), ref[0][~same].double()
        assert float(((g - r).abs().mean(1) / r.mean(1)).max()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_cuda_per_batch_e_step_matches_cpu_and_repeats(cuda, backend):
    """The per-batch dispatch's pallas and xla paths on the card against
    the CPU (likelihood, alpha_ss rtol 1e-5, suff-stats rtol 1e-4), and
    twice on the card the same bits: the [V, K] sums go through the
    position-ordered scatter kernel, not index_add_'s atomics."""
    lb, a, w, c, m, _ = _problem(22, 32, 64, 4)
    res = {}
    for dev in ("cpu", cuda, cuda):
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        live = tsparse.live_tokens(t(w), t(c))
        res.setdefault(str(dev), []).append(testep.e_step(
            t(lb), torch.tensor(a), t(w), t(c), t(m), 40, 1e-5,
            backend=backend, live=live))
    (want,), (got, again) = res["cpu"], res["cuda"]
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    ws = want.suff_stats.numpy()
    np.testing.assert_allclose(got.suff_stats.cpu().numpy(), ws, rtol=1e-4,
                               atol=1e-6 * np.abs(ws).max())
    np.testing.assert_allclose(float(got.likelihood), float(want.likelihood),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.alpha_ss), float(want.alpha_ss),
                               rtol=1e-5)
