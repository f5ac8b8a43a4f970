"""The EM chunk probe (oni_ml_tpu_torch/tools/em_chunk_probe.py) on the
card at a small budget: it times the chunk runner over the sparse E-step
kernel and records the winner, keyed by the card and the E-step
kernels' build hashes, under the exact shape and "*".

This file imports no JAX, so it runs on a machine with a card and no
JAX (the variable keeps tests/conftest.py from importing jax):

    ONI_ML_TPU_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_plans_card.py

Without a CUDA device the test skips."""

import json

import pytest
import torch

from oni_ml_tpu_torch import plans
from oni_ml_tpu_torch.ops import _cuda


@pytest.mark.cuda
def test_em_chunk_probe_records_on_the_card(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe times the sparse E-step "
                    "kernel")
    from oni_ml_tpu_torch.tools import em_chunk_probe

    path = str(tmp_path / "plans.jsonl")
    assert em_chunk_probe.main(["--b", "1024", "--rounds", "1",
                                "--chunks", "16,32", "--budget-s", "5",
                                "--plan-cache", path]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    last = lines[-1]
    assert last["recorded"] and last["recorded_wildcard"]
    assert last["fused_em_chunk"] in (16, 32)
    assert all(x["docs_per_sec"] > 0 for x in lines[:-1])
    backend = plans.plan_backend("cuda", _cuda.estep_kernels())
    assert last["backend"] == backend
    store = plans.PlanStore(path)
    assert store.lookup("fused_em_chunk", backend, "k20.v8192.b1024.l128") \
        .value == last["fused_em_chunk"]
    assert store.lookup("fused_em_chunk", backend, "*").value == \
        last["fused_em_chunk"]
