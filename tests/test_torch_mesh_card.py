"""The device mesh on the card (parallel/mesh.py, parallel/sharded.py,
the scorer's mesh path), its slots repeating one card
(devices=[cuda:0] * N), against the unmeshed paths on the same card.

This file imports no JAX, so it runs on a machine with a card and no
JAX (the variable keeps tests/conftest.py from importing jax):

    ONI_ML_TPU_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_mesh_card.py

Without a CUDA device every test here skips.  Tolerances: the JAX
package's for its sharded E-step against one device
(tests/test_sharded.py: gamma rtol/atol 1e-5, suff-stats rtol 1e-4 /
atol 1e-5); the scorer's scores bit-equal (each event's score depends
on its two rows alone)."""

import numpy as np
import pytest
import torch

from oni_ml_tpu_torch import parallel as tpar
from oni_ml_tpu_torch.ops import estep as testep
from oni_ml_tpu_torch.scoring import ScoringModel, chunked_scores


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh binds cards there")
    return torch.device("cuda", 0)


def _model(k=20, d=300, v=200, seed=0):
    rng = np.random.default_rng(seed)
    return ScoringModel(ip_index={}, theta=rng.random((d + 1, k)),
                        word_index={}, p=rng.random((v + 1, k)))


def _idx(model, n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, model.theta.shape[0], n).astype(np.int32),
            rng.integers(0, model.p.shape[0], n).astype(np.int32))


@pytest.mark.cuda
def test_cuda_mesh_binds_cards_only(cuda):
    n = torch.cuda.device_count()
    mesh = tpar.make_mesh(1, 1)
    assert mesh.device_type == "cuda"
    with pytest.raises(ValueError, match=f"needs {n + 1} devices, have {n}"):
        tpar.make_mesh(n + 1, 1)
    rep = tpar.make_mesh(2, 2, devices=[cuda] * 4)
    assert all(d.type == "cuda" for d in rep.devices.flat)


@pytest.mark.cuda
def test_cuda_data_parallel_e_step_runs_the_kernel_on_every_slot(cuda):
    """The per-batch dispatch on 4 slots of one card: the sparse kernel
    and the scatter launched once per slot; the result within the JAX
    test's sharded bounds of the unmeshed E-step on the card."""
    rng = np.random.default_rng(0)
    k, v, b, l = 20, 500, 64, 32
    noise = rng.uniform(size=(k, v)) + 1.0 / v
    lb = torch.tensor(np.log(noise / noise.sum(-1, keepdims=True)),
                      dtype=torch.float32, device=cuda)
    w = torch.tensor(rng.integers(0, v, (b, l)), dtype=torch.int32,
                     device=cuda)
    c = torch.tensor(rng.integers(1, 4, (b, l)), dtype=torch.float32,
                     device=cuda)
    m = torch.ones(b, device=cuda)
    mesh = tpar.make_mesh(4, 1, devices=[cuda] * 4)
    got = tpar.make_data_parallel_e_step(mesh)(lb, torch.tensor(2.5),
                                               w, c, m, 30, 1e-7)
    want = testep.e_step(lb, torch.tensor(2.5), w, c, m, 30, 1e-7)
    torch.cuda.synchronize()
    assert mesh.launches["sparse_estep"] == [1, 1, 1, 1]
    assert mesh.launches["sparse_scatter"] == [1, 1, 1, 1]
    np.testing.assert_allclose(got.gamma.cpu().numpy(),
                               want.gamma.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.suff_stats.cpu().numpy(),
                               want.suff_stats.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.cuda
def test_cuda_mesh_scorer_bit_equal(cuda):
    model = _model(k=20, seed=23)
    ia, ib = _idx(model, 5000, seed=24)
    single = chunked_scores(model, ia, ib, chunk=1024)
    mesh = tpar.make_mesh(4, 1, devices=[cuda] * 4)
    np.testing.assert_array_equal(
        chunked_scores(model, ia, ib, chunk=1024, mesh=mesh), single)
