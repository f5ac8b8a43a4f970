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


def _long_case(seed, b, l, min_live, k=20, v=5520):
    """A long-document bucket at the flow day's widths (K=20, V=5,520):
    docs of min_live..l tokens, of distinct words (as the bucketed corpus
    holds them) up to V of them, counts 1..4, the last doc masked, a
    warm-start gamma."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(k, v)) + 1.0 / v
    log_beta = np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)
    lens = rng.integers(min_live, l + 1, size=b)
    word = np.zeros((b, l), np.int32)
    counts = np.zeros((b, l), np.float32)
    for d, n in enumerate(lens):
        word[d, :n] = rng.choice(v, size=n, replace=bool(n > v))
        counts[d, :n] = rng.integers(1, 5, size=n)
    mask = np.ones(b, np.float32)
    mask[-1] = 0.0
    mean = 2.5 + counts.sum(1, keepdims=True) / k
    gamma_prev = (mean * rng.uniform(0.5, 1.5, size=(b, k))).astype(np.float32)
    return log_beta, word, counts, mask, gamma_prev


def _check_block_parity(got, ref, block, var_tol):
    """(gamma, iters) against the plain version's: iterations within one
    per block; gamma rtol 1e-4 in the blocks that stop together, the
    others within 2 var_tol by the stop rule's own measure."""
    assert int((got[1] - ref[1]).abs().max()) <= 1
    moved = got[1] != ref[1]
    same = ~moved.repeat_interleave(block)
    np.testing.assert_allclose(got[0][same].cpu().numpy(),
                               ref[0][same].cpu().numpy(), rtol=1e-4)
    if bool(moved.any()):
        g, r = got[0][~same].double(), ref[0][~same].double()
        assert float(((g - r).abs().mean(1) / r.mean(1)).max()) <= 2 * var_tol


@pytest.mark.cuda
@pytest.mark.parametrize("wmajor", [False, True], ids=["rowmajor", "wmajor"])
def test_cuda_dense_overflow_path_matches_plain_version(cuda, wmajor):
    """Long documents densified to the flow day's W=5,632 at K=20: a doc
    block of one document with up to 4,096 non-zero cells does not fit in
    shared memory, so its lists go to the device-memory scratch (a slice
    of min(W, L) cells per block).  Gamma and iterations as in the
    main-shape test, the tail (T rtol 1e-4, docll 1e-5) against the plain
    tail on the kernel's gamma, and two launches give the same bits."""
    lb, w, c, m, _ = _long_case(31, 8, 4096, 2049)
    eb = tdense.padded_exp_beta(torch.from_numpy(lb).to(cuda), 5632)
    dense = tdense.densify(torch.from_numpy(w).to(cuda),
                           torch.from_numpy(c).to(cuda), 5520)
    cm = (dense.t() if wmajor else dense).contiguous()
    args = (eb, torch.tensor(2.5, device=cuda), cm,
            torch.from_numpy(m).to(cuda), 20, 1e-6)
    got = tdense.fixed_point_blocks(*args, wmajor=wmajor, cells=4096)
    again = tdense.fixed_point_blocks(*args, wmajor=wmajor, cells=4096)
    torch.cuda.synchronize()
    geom = tdense.launch_geometry(8, 5632, 20, cells=4096)
    block = geom["block"]
    assert block == 1 and geom["scratch_bytes"] == 8 * 4096 * 4 * 21
    # A block takes the scratch where its non-zero cells outnumber the
    # shared memory's.
    nnz_block = (dense != 0).sum(1).view(-1, block).sum(1)
    assert int((nnz_block > geom["smem_cells"]).sum()) >= 1
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    plain = (eb, args[1], dense, args[3])
    ref = tdense.dense_fixed_point_reference(*plain, 20, 1e-6, block)
    _check_block_parity((got[0], got[4]), (ref[0], ref[4]), block, 1e-6)
    tail = tdense.dense_fixed_point_reference(
        *plain, 0, 1e-6, block, gamma_prev=got[0], warm=torch.tensor(1))
    rt = tail[1].cpu().numpy()
    np.testing.assert_allclose(got[1].cpu().numpy(), rt, rtol=1e-4,
                               atol=1e-4 * np.abs(rt).max())
    np.testing.assert_allclose(got[2].cpu().numpy(), tail[2].cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,min_live", [(8, 4096, 2049), (2, 16384, 8193)],
                         ids=["cluster8_b8", "cluster8_b2"])
def test_cuda_fixed_point_cluster_path_matches_plain_version(cuda, b, l,
                                                             min_live):
    """Long documents through a thread-block cluster of CTAs per document
    (the partial sums added through distributed shared memory in rank
    order): gamma and iterations against fixed_point_reference as in the
    main-shape test, and two launches give the same bits."""
    lb, w, c, m, gp = _long_case(32 + b, b, l, min_live)
    geom = tpallas.launch_geometry(b, l, 20)
    assert geom["cluster"] > 2 and geom["staged"]
    slab = tpallas.gather_slab(
        tsparse.exp_beta_table(torch.from_numpy(lb).to(cuda)),
        torch.from_numpy(w).to(cuda))
    args = (slab, torch.tensor(2.5, device=cuda), torch.from_numpy(c).to(cuda),
            torch.from_numpy(m).to(cuda), 20, 1e-6)
    for warm in (False, True):
        kw = {"warm": torch.tensor(int(warm)),
              "gamma_prev": torch.from_numpy(gp).to(cuda) if warm else None}
        got = tpallas.fixed_point_blocks(*args, **kw)
        again = tpallas.fixed_point_blocks(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        ref = tpallas.fixed_point_reference(*args, geom["block"], **kw)
        _check_block_parity(got, ref, geom["block"], 1e-6)


@pytest.mark.parametrize("l", [128, 4096, 16384])
@pytest.mark.parametrize("b", [1, 2, 8, 1024])
def test_sparse_launch_geometry_keeps_the_block_within_card_limits(b, l):
    """The sparse E-step's launch geometry: the doc block (the stop
    groups) is pick_block's, one CTA or one cluster per block; a cluster
    of 1-8 CTAs, and more than one only for a block of one document; at
    most MAX_THREADS threads in whole warps; a staged tile covers the
    document's share of L in 16-byte rows and fits in a CTA's shared
    memory beside the kernel's static arrays."""
    for k in (5, 20, 64):
        geom = tsparse.launch_geometry(b, l, k)
        block, cluster = geom["block"], geom["cluster"]
        assert block == tsparse.pick_block(b) == geom["docs_per_cta"]
        assert cluster in (1, 2, 4, 8) and (cluster == 1 or block == 1)
        assert cluster <= tsparse.MAX_CLUSTER
        assert geom["ctas"] == b // block * cluster
        assert geom["threads"] == 32 * block * geom["warps_per_doc"]
        assert geom["threads"] <= tsparse.MAX_THREADS == 256
        if geom["staged"]:
            assert geom["tile_len"] % 4 == 0
            assert geom["tile_len"] * cluster >= l
            assert geom["smem_bytes"] == block * 4 * (k + 1) * geom["tile_len"]
            assert geom["smem_bytes"] <= (tpallas.SMEM_PER_CTA
                                          - tpallas.SMEM_STATIC)
        else:
            # Only where no cluster can help: a block of several
            # documents, or a document past 8 CTAs' tiles.
            assert geom["smem_bytes"] == 0 and (cluster == 8 or block > 1)


@pytest.mark.parametrize("l", [128, 4096, 16384])
@pytest.mark.parametrize("b", [1, 2, 8, 1024])
def test_sparse_geometry_is_the_fixed_points(b, l, monkeypatch):
    """One rule for both kernels that stage 4 * (K + 1) bytes a token:
    the sparse geometry is the fixed point's, key for key, at every K
    and at each tokens-per-warp setting of the sweep."""
    for tpw in (32, 128, 256):
        monkeypatch.setattr(tpallas, "TOKENS_PER_WARP", tpw)
        for k in (5, 20, 64):
            assert tsparse.launch_geometry(b, l, k) == tpallas.launch_geometry(
                b, l, k, tsparse.pick_block(b))


def test_sparse_wrapper_limits_are_the_kernel_source():
    """The sparse wrapper's CTA, cluster and shared-memory limits are the
    numbers csrc/sparse_estep.cu sizes its launch and static arrays by:
    MAX_THREADS is kMaxThreads, MAX_CLUSTER kMaxCluster, SMEM_STATIC
    covers the static arrays at that CTA and K <= 64 (two halves of
    per-warp and per-CTA topic sums, the deltas, N_d and the live
    bounds)."""
    import pathlib
    import re

    csrc = pathlib.Path(tsparse.__file__).parents[1] / "csrc"
    src = (csrc / "sparse_estep.cu").read_text()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    threads = const("kMaxThreads")
    assert threads == tsparse.MAX_THREADS
    assert const("kMaxCluster") == tsparse.MAX_CLUSTER
    kernel = src[src.index("sparse_estep_kernel("):src.index("sparse_scatter_kernel(")]
    decl = re.findall(r"__shared__ (?:float|int) s_\w+(\[[^;]*);", kernel)
    assert len(decl) == 5
    warps, ns = threads // 32, 2
    static = 4 * (2 * warps * ns * 32 + 2 * ns * 32 + 2 * warps + 2 * warps)
    assert static <= tpallas.SMEM_STATIC < static + 1024


# (B, L, min_live) at V=5,520 for each launch geometry the sparse
# E-step's rule gives (sparse_estep.launch_geometry), at K 5 and 20 alike:
# one warp per document (blocks of 4), four warps per document (blocks
# of 2), a cluster of 2 and of 8 CTAs per document, and the beta rows
# read from the table in device memory, for a document longer than 8
# CTAs' tiles and for a block of 4 documents whose tiles do not fit one
# CTA (as in the flow day's buckets of 264 documents or more at L 2,048).
SPARSE_GEOMETRIES = {
    "one_warp": (1024, 32, 8),
    "four_warps": (264, 512, 129),
    "cluster2": (40, 256, 129),
    "cluster8": (8, 4096, 2049),
    "unstaged": (1, 81920, 40961),
    "unstaged_block": (1024, 4096, 2049),
}


def _sparse_geometry_holds(case, geom):
    return {
        "one_warp": geom["warps_per_doc"] == 1 and geom["block"] == 4
        and geom["cluster"] == 1 and geom["staged"],
        "four_warps": geom["warps_per_doc"] == 4 and geom["block"] == 2
        and geom["staged"],
        "cluster2": geom["cluster"] == 2 and geom["staged"],
        "cluster8": geom["cluster"] == 8 and geom["staged"],
        "unstaged": geom["cluster"] == 8 and not geom["staged"],
        "unstaged_block": geom["block"] > 1 and not geom["staged"],
    }[case]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("case", list(SPARSE_GEOMETRIES))
def test_cuda_sparse_kernel_matches_plain_version_in_every_geometry(
        cuda, case, k):
    """csrc/sparse_estep.cu in each geometry, at K 20 (16-byte staging
    copies and reads) and K 5 (4-byte ones), against
    fixed_point_full_reference, fresh and warm: iterations within one
    per block; gamma rtol 1e-4 (rcp.approx + one Newton step and another
    f32 summation order) in the blocks that stop together, the others
    within 2 var_tol by the stop rule's own measure; the tail (phi_c rtol
    1e-4, docll and ass 1e-5) against the plain tail on the kernel's
    gamma; two launches give the same bits."""
    b, l, min_live = SPARSE_GEOMETRIES[case]
    geom = tsparse.launch_geometry(b, l, k)
    assert _sparse_geometry_holds(case, geom), geom
    lb, w, c, m, gp = _long_case(40 + b, b, l, min_live, k)
    expb = tsparse.exp_beta_table(torch.from_numpy(lb).to(cuda))
    args = (expb, torch.tensor(2.5, device=cuda), torch.from_numpy(w).to(cuda),
            torch.from_numpy(c).to(cuda), torch.from_numpy(m).to(cuda), 20, 1e-6)
    block = geom["block"]
    for warm in (False, True):
        kw = {"block": block, "warm": torch.tensor(int(warm)),
              "gamma_prev": torch.from_numpy(gp).to(cuda) if warm else None}
        got = tsparse.fixed_point_blocks(*args, **kw)
        again = tsparse.fixed_point_blocks(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        ref = tsparse.fixed_point_full_reference(*args, **kw)
        _check_block_parity((got[0], got[4]), (ref[0], ref[4]), block, 1e-6)
        tail = tsparse.fixed_point_full_reference(
            *args[:5], 0, 1e-6, block=block, gamma_prev=got[0],
            warm=torch.tensor(1))
        rt = tail[1].cpu().numpy()
        np.testing.assert_allclose(got[1].cpu().numpy(), rt, rtol=1e-4,
                                   atol=1e-4 * np.abs(rt).max())
        for i in (2, 3):
            r = tail[i].cpu().numpy()
            np.testing.assert_allclose(got[i].cpu().numpy(), r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())


@pytest.mark.cuda
@pytest.mark.parametrize("v", [60, 5520])
def test_cuda_scatter_on_spread_and_empty_batches(cuda, v):
    """The scatter's [V, K] output on words spread over V: the rows of
    words no live token holds are zeros, before, between and after the
    words that occur, and a batch with no live token gives all zeros,
    as on the CPU."""
    lb, a, w, c, m, _ = _problem(23, 16, 24, 4)
    w = (w * (v // V)).astype(np.int32)         # spread the words over V
    dev = cuda
    phic = torch.rand((16, 24, K), device=dev)
    for counts in (c, np.zeros_like(c)):
        tw, tc = torch.from_numpy(w).to(dev), torch.from_numpy(counts).to(dev)
        live = tsparse.live_tokens(tw, tc)
        got = tsparse.scatter_live(phic, live, v)
        cpu = tsparse.scatter_live(phic.cpu(), tsparse.live_tokens(
            tw.cpu(), tc.cpu()), v)
        assert torch.equal(got.cpu(), cpu)


# ---------------------------------------------------------------------------
# Online SVI and the dataplane day on the card
# ---------------------------------------------------------------------------


def _random_corpus(seed, docs=300, v=200):
    """A corpus of `docs` documents of 5-60 distinct words out of `v`."""
    from oni_ml_tpu_torch.io import Corpus

    rng = np.random.default_rng(seed)
    ptr, widx, cnts = [0], [], []
    for _ in range(docs):
        n = int(rng.integers(5, 61))
        widx.extend(rng.choice(v, size=n, replace=False).tolist())
        cnts.extend(rng.integers(1, 6, size=n).tolist())
        ptr.append(len(widx))
    return Corpus([f"d{i}" for i in range(docs)], [f"w{i}" for i in range(v)],
                  np.asarray(ptr, np.int64), np.asarray(widx, np.int32),
                  np.asarray(cnts, np.int32))


# dense_em, ONI_ML_TPU_ESTEP -> the member and the kernels its micro-batch
# steps launch; the final inference pass runs the per-batch E-step.
ONLINE_PATHS = {"dense": ("auto", None, "dense"),
                "sparse": ("off", None, "per_batch:sparse"),
                "fixed_point": ("off", "pallas", "per_batch:pallas")}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(ONLINE_PATHS))
def test_cuda_online_paths_launch_their_kernels(cuda, path, monkeypatch):
    """train_corpus_online on the card through each micro-batch E-step:
    every step launches its kernel (dense, sparse or fixed point, the
    per-batch ones with the [V, K] scatter), the inference pass its
    per-batch kernel once per batch; the per-step likelihoods and final
    lambda agree with the CPU's plain versions to 1e-4 relative."""
    from dataclasses import replace

    from oni_ml_tpu_torch.config import OnlineLDAConfig
    from oni_ml_tpu_torch.models import online_lda
    from oni_ml_tpu_torch.runner.ml_ops import launch_counts, reset_kernel_counts

    dense_em, env, member = ONLINE_PATHS[path]
    if env:
        monkeypatch.setenv("ONI_ML_TPU_ESTEP", env)
    corpus = _random_corpus(3)
    cfg = OnlineLDAConfig(num_topics=20, batch_size=64, dense_em=dense_em,
                          seed=1)
    runs = {}
    for dev in ("cpu", cuda):
        reset_kernel_counts()
        lls = []
        # On the CPU "auto" is the per-batch path: force the dense one.
        res = online_lda.train_corpus_online(
            corpus, replace(cfg, dense_em="on") if dev == "cpu" and
            member == "dense" else cfg, device=dev,
            progress=lambda info: lls.append(float(info.likelihood)))
        runs[str(dev)] = (res, lls, launch_counts())
    res, lls, launches = runs["cuda"]
    cpu_res, cpu_lls, cpu_launches = runs["cpu"]
    assert res.stats["member"] == member
    assert cpu_launches == {k: 0 for k in cpu_launches}
    steps, nb = res.em_iters, res.stats["batches"]
    infer = "fixed_point_estep" if env == "pallas" else "sparse_estep"
    want = {k: 0 for k in launches}
    want[infer] += nb
    want["sparse_scatter"] += nb
    if member == "dense":
        want["dense_estep"] += steps
    else:
        want[infer] += steps
        want["sparse_scatter"] += steps
    assert launches == want
    np.testing.assert_allclose(lls, cpu_lls, rtol=1e-4)
    np.testing.assert_allclose(np.exp(res.log_beta), np.exp(cpu_res.log_beta),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_cuda_held_out_ll_matches_cpu(cuda):
    from oni_ml_tpu_torch.io import make_batches
    from oni_ml_tpu_torch.models.evaluate import held_out_per_token_ll

    corpus = _random_corpus(5)
    rng = np.random.default_rng(2)
    log_beta = np.log(rng.dirichlet(np.full(200, 0.3), size=20))
    batches = make_batches(corpus, 128, 16)
    got = held_out_per_token_ll(log_beta, 2.5, batches, device=cuda)
    want = held_out_per_token_ll(log_beta, 2.5, batches, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_dataplane_day_is_the_serial_day(cuda, tmp_path, monkeypatch):
    """A small flow day on the card, sparse engine pinned: the dataplane
    day writes the --no-dataplane day's bytes, and --no-checkpoints its
    results CSV alone."""
    from oni_ml_tpu_torch.config import (DataplaneConfig, LDAConfig,
                                         PipelineConfig, ScoringConfig)
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.synth import write_flow_day

    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "sparse")
    raw = tmp_path / "flow.csv"
    with open(raw, "w") as f:
        write_flow_day(f, 5000, n_src=200, n_dst=50, seed=5)
    days = {}
    for label, dp in (("plane", {}), ("serial", {"enabled": False}),
                      ("products", {"checkpoints": False})):
        ml_ops.run_pipeline(PipelineConfig(
            data_dir=str(tmp_path / label), flow_path=str(raw),
            lda=LDAConfig(em_max_iters=5), scoring=ScoringConfig(threshold=1.1),
            dataplane=DataplaneConfig(**dp)), "20160122", "flow",
            device=cuda, emit=lambda *a, **k: None)
        days[label] = tmp_path / label / "20160122"
    for name in ml_ops.artifacts("flow"):
        if name != "features.pkl":
            assert (days["plane"] / name).read_bytes() == \
                (days["serial"] / name).read_bytes(), name
    assert sorted(p.name for p in days["products"].iterdir()) == [
        "flow_results.csv", "metrics.json", "run_journal.jsonl"]
    assert (days["products"] / "flow_results.csv").read_bytes() == \
        (days["plane"] / "flow_results.csv").read_bytes()


# ---------------------------------------------------------------------------
# The bf16 storage mode (precision "bf16")
# ---------------------------------------------------------------------------


def test_bf16_plain_versions_count_no_launch():
    """On the CPU the bf16 mode takes the plain versions too, and no
    launch counts (bf16 or not)."""
    prob = _problem(5, 32, 16, 4)
    lb = torch.from_numpy(prob[0])
    args = list(_args(prob, "cpu"))
    args[0] = tsparse.exp_beta_table(lb, "bf16")
    tsparse.reset_launch_count()
    tdense.reset_launch_count()
    tsparse.fixed_point_blocks(*args, block=8)
    lbd, dense, mask, _ = _dense_problem(11, 16)
    tdense.fixed_point_blocks(
        tdense.padded_exp_beta(torch.from_numpy(lbd), dense.shape[1]),
        torch.tensor(2.5), dense.to(torch.bfloat16), torch.from_numpy(mask),
        20, 1e-6, precision="bf16")
    assert (tsparse.launch_count, tsparse.bf16_launch_count) == (0, 0)
    assert (tdense.launch_count, tdense.bf16_launch_count) == (0, 0)


@pytest.mark.cuda
def test_cuda_bf16_table_rounds_as_the_cpu(cuda):
    """The bf16 table made on the card (torch's round to nearest even
    there) is the CPU's bit for bit, on a beta running from normal values
    through float32's smallest normals into its subnormal range (flushed
    first); tests/test_torch_bf16.py holds the CPU's against XLA's."""
    rng = np.random.default_rng(3)
    lb = rng.uniform(-12.0, -0.5, size=(20, 96)).astype(np.float32)
    lb[0, :48] = np.linspace(-87.6, -87.0, 48, dtype=np.float32)
    lb[1, :48] = np.linspace(-103.0, -88.0, 48, dtype=np.float32)
    t = torch.from_numpy(lb)
    got = tsparse.exp_beta_table(t.to(cuda), "bf16").cpu()
    want = tsparse.exp_beta_table(t, "bf16")
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 5, 20, 32, 64])
@pytest.mark.parametrize("case", ["one_warp", "cluster8", "unstaged"])
def test_cuda_sparse_bf16_kernel_matches_plain_version(cuda, case, k):
    """The sparse kernel's bf16 instantiation (the [V, K] table stored as
    bf16) against fixed_point_full_reference over the same rounded table,
    staged (8-byte loads of four values where K % 4 == 0: K 4, 20, 32, 64;
    2-byte ones at K 5) and read from the table in device memory, fresh
    and warm: the f32 bounds hold, since both read the same values
    (iterations within one per block, gamma rtol 1e-4 in the blocks that
    stop together, the tail against the plain tail on the kernel's gamma:
    phi_c rtol 1e-4, docll and ass 1e-5); two launches the same bits;
    every launch counted as a bf16 one."""
    b, l, min_live = SPARSE_GEOMETRIES[case]
    geom = tsparse.launch_geometry(b, l, k)
    if k >= 20:            # at K 4 the "unstaged" document's tile fits
        assert geom["staged"] == (case != "unstaged"), geom
    lb, w, c, m, gp = _long_case(60 + b + k, b, l, min_live, k)
    expb = tsparse.exp_beta_table(torch.from_numpy(lb).to(cuda), "bf16")
    args = (expb, torch.tensor(2.5, device=cuda), torch.from_numpy(w).to(cuda),
            torch.from_numpy(c).to(cuda), torch.from_numpy(m).to(cuda), 20, 1e-6)
    block = geom["block"]
    tsparse.reset_launch_count()
    for warm in (False, True):
        kw = {"block": block, "warm": torch.tensor(int(warm)),
              "gamma_prev": torch.from_numpy(gp).to(cuda) if warm else None}
        got = tsparse.fixed_point_blocks(*args, **kw)
        again = tsparse.fixed_point_blocks(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        ref = tsparse.fixed_point_full_reference(*args, **kw)
        _check_block_parity((got[0], got[4]), (ref[0], ref[4]), block, 1e-6)
        tail = tsparse.fixed_point_full_reference(
            *args[:5], 0, 1e-6, block=block, gamma_prev=got[0],
            warm=torch.tensor(1))
        rt = tail[1].cpu().numpy()
        np.testing.assert_allclose(got[1].cpu().numpy(), rt, rtol=1e-4,
                                   atol=1e-4 * np.abs(rt).max())
        for i in (2, 3):
            r = tail[i].cpu().numpy()
            np.testing.assert_allclose(got[i].cpu().numpy(), r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())
    assert tsparse.bf16_launch_count == tsparse.launch_count == 4


def _check_bf16_block_parity(got, ref, ref32, block):
    """The dense bf16 instantiation's (gamma, iters) against the plain
    version's in the bf16 mode (`ref`) and in f32 (`ref32`).  Both round
    every cell's ratio to bf16, from the Newton reciprocal on the card
    and the exact divide on the CPU, so a ratio lands one bf16 step
    (2^-8) apart now and then, and rounded operands keep delta above
    var_tol, so blocks stop at the stop rule's stall gate (delta under
    1e-2 and no longer falling), where that noise decides the iteration
    and gamma is settled only to the gate's step.  So: iterations within
    10 per block (5 apart at the smoke's main shape on the H100); each
    document within (m + 1) gate steps by the stop rule's measure (mean
    |d gamma| over its mean gamma), m the iterations its block stopped
    apart (chip_smoke.py holds the main shape the same way); and the
    kernel's gamma closer to the bf16 plain version's than to the f32
    one's by 10x (median over documents), so the rounding happened."""
    diff = (got[1] - ref[1]).abs()
    assert int(diff.max()) <= 10

    def measure(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return (a - b).abs().mean(1) / b.mean(1)

    steps = measure(got[0], ref[0])
    bound = (diff.repeat_interleave(block).double().cpu() + 1) * 1e-2
    assert bool((steps <= bound).all()), (steps.max(), bound.min())
    to32 = float(measure(got[0], ref32[0]).median())
    assert to32 >= 10 * float(steps.median()), (to32, float(steps.median()))


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["bf16", "f32"],
                         ids=["bf16_corpus", "f32_corpus"])
@pytest.mark.parametrize("wmajor", [False, True], ids=["rowmajor", "wmajor"])
@pytest.mark.parametrize("block", [1, 2, 4])
def test_cuda_dense_bf16_kernel_matches_plain_version(cuda, wmajor, block,
                                                       store):
    """The dense kernel's bf16 instantiations (operands rounded in the
    fixed point; the corpus stored as bf16, or as f32 where a cell is
    above 256, here one of 280) against the plain version in the bf16
    mode and in f32, fresh and warm (_check_bf16_block_parity); the tail (T rtol
    1e-4, docll and ass 1e-5, f32 on f32 beta) against the plain tail on
    the kernel's gamma; T the same bits on two launches; every launch
    counted as a bf16 one."""
    lb, dense, mask, gp = _dense_problem(17, 64)
    if store == "f32":
        dense[3, 7] = 280.0
    cells = dense.to(tdense.corpus_dtype(float(dense.max()), "bf16"))
    assert cells.dtype == (torch.bfloat16 if store == "bf16"
                           else torch.float32)
    eb = tdense.padded_exp_beta(torch.from_numpy(lb), dense.shape[1]).to(cuda)
    c = (cells.t() if wmajor else cells).contiguous().to(cuda)
    var_tol = 1e-5
    args = (eb, torch.tensor(2.5, device=cuda), c,
            torch.from_numpy(mask).to(cuda), 60, var_tol)
    plain = (eb, args[1], cells.to(cuda), args[3])
    tdense.reset_launch_count()
    for warm in (False, True):
        kw = {"block": block, "wmajor": wmajor, "warm": torch.tensor(int(warm)),
              "gamma_prev": torch.from_numpy(gp).to(cuda) if warm else None,
              "precision": "bf16"}
        got = tdense.fixed_point_blocks(*args, **kw)
        again = tdense.fixed_point_blocks(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        ref = tdense.dense_fixed_point_reference(
            *plain, 60, var_tol, block, gamma_prev=kw["gamma_prev"],
            warm=kw["warm"], precision="bf16")
        ref32 = tdense.dense_fixed_point_reference(
            *plain, 60, var_tol, block, gamma_prev=kw["gamma_prev"],
            warm=kw["warm"])
        _check_bf16_block_parity((got[0], got[4]), (ref[0], ref[4]),
                                 (ref32[0], ref32[4]), block)
        tail = tdense.dense_fixed_point_reference(
            *plain, 0, var_tol, block, gamma_prev=got[0],
            warm=torch.tensor(1), precision="bf16")
        rt = tail[1].cpu().numpy()
        np.testing.assert_allclose(got[1].cpu().numpy(), rt, rtol=1e-4,
                                   atol=1e-4 * np.abs(rt).max())
        for i in (2, 3):
            r = tail[i].cpu().numpy()
            np.testing.assert_allclose(got[i].cpu().numpy(), r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())
    assert tdense.bf16_launch_count == tdense.launch_count == 4
    with pytest.raises(ValueError, match="needs precision 'bf16'"):
        tdense.fixed_point_blocks(eb, args[1], cells.to(torch.bfloat16)
                                  .to(cuda), args[3], 20, 1e-6)
