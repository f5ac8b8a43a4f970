"""The serving fleet's device paths on the card against their plain CPU
runs: the fused featurize + gather + dot (ops/featurize_kernel.py), the
table gather, a bf16 stack and a FleetScorer under the "fused" engine.

This file imports no JAX, so it runs on a machine with a card and no
JAX (the variable keeps tests/conftest.py from importing jax):

    ONI_ML_TPU_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_fleet_card.py

Without a CUDA device every test here skips.  Tolerances: the card and
the CPU run the same float32 ops (gathers, k-order multiply-adds), so
scores agree within rel 1e-6; the table gather is integer and exact;
a bf16 stack's storage is half the f32 stack's bytes."""

import numpy as np
import pytest
import torch

from oni_ml_tpu_torch.config import ServingConfig
from oni_ml_tpu_torch.ops import featurize_kernel as fk
from oni_ml_tpu_torch.runner.serve import _perturbed_model, _synthetic_day
from oni_ml_tpu_torch.scoring.pipeline import fused_featurize_scores
from oni_ml_tpu_torch.scoring.score import _device_model
from oni_ml_tpu_torch.serving import (DnsEventFeaturizer, FleetRegistry,
                                      FleetScorer, MetricsEmitter,
                                      TenantSpec)
from oni_ml_tpu_torch.sources import get as get_source
from oni_ml_tpu_torch.sources.device import DeviceBatch, compile_featurizer

RTOL = 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused flush runs on the card")
    return torch.device("cuda")


def _batch():
    rows, model, cuts = _synthetic_day(seed=42)
    dev, info = compile_featurizer(get_source("dns"), tuple(cuts), model)
    assert dev is not None, info["reason"]
    return model, dev, DeviceBatch(dev, None, rows, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [None, "median"])
def test_cuda_fused_scores_match_cpu(cuda, threshold):
    model, dev, batch = _batch()
    d, codes, ip = batch.fused_operands()
    cpu = fused_featurize_scores(model, d, codes, ip, block=64, device="cpu")
    thr = None if threshold is None else float(np.median(cpu))
    got = fused_featurize_scores(model, d, codes, ip, block=64,
                                 threshold=thr, device=cuda)
    ref = fused_featurize_scores(model, d, codes, ip, block=64,
                                 threshold=thr, device="cpu")
    if thr is None:
        np.testing.assert_allclose(got, ref, rtol=RTOL)
    else:
        np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
        np.testing.assert_array_equal(got[1], np.float32(got[0])
                                      < np.float32(thr))


@pytest.mark.cuda
def test_cuda_lut_rows_exact(cuda):
    _, dev, batch = _batch()
    _, codes, _ = batch.fused_operands()
    got = fk.lut_rows(dev, codes, block=64, device=cuda)
    assert got.tobytes() == fk.lut_rows(dev, codes, block=64,
                                        device="cpu").tobytes()
    assert fk.device_lut(dev, cuda).device.type == "cuda"


@pytest.mark.cuda
def test_cuda_bf16_stack_half_bytes_and_close_to_cpu(cuda):
    rows, model, cuts = _synthetic_day(seed=42)
    got = {}
    for precision in ("f32", "bf16"):
        fleet = FleetRegistry(stack_precision=precision)
        for t, m in (("a", model), ("b", _perturbed_model(model, 11))):
            fleet.add_tenant(TenantSpec(tenant=t, dsource="dns"))
            fleet.publish(t, m, t)
        stack = fleet.stack_for("a")
        theta, p = _device_model(stack.model, cuda)
        got[precision] = (theta.element_size() * theta.nelement()
                          + p.element_size() * p.nelement())
    assert got["bf16"] * 2 == got["f32"]


@pytest.mark.cuda
def test_cuda_fleet_fused_engine_matches_cpu(cuda):
    rows, model, cuts = _synthetic_day(seed=42)
    out = {}
    for device in (cuda, "cpu"):
        fleet = FleetRegistry()
        fleet.add_tenant(TenantSpec(tenant="t0", dsource="dns"))
        fleet.publish("t0", model, "day")
        scorer = FleetScorer(
            fleet, {"t0": DnsEventFeaturizer(cuts)},
            ServingConfig(device_score_min=None, featurize_engine="fused",
                          featurize_break_even=1),
            metrics=MetricsEmitter(to_stdout=False), device=device)
        futs = [scorer.submit("t0", r) for r in rows]
        scorer.flush()
        out[str(device)] = np.array([f.result(30.0)[0] for f in futs])
        scorer.close()
        assert scorer.counts["fused_dispatches"] >= 1
        assert scorer.counts["failures"] == 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=RTOL)
