"""The replicated fleet's scoring on the card: three in-process replicas
on `cuda` behind a FleetRouter, every flush sent to the card
(device_score_min=1: a flush of one event or more scores there), held
to the float64 host scorer.

This file imports no JAX, so it runs on a machine with a card and no
JAX (the variable keeps tests/conftest.py from importing jax):

    ONI_ML_TPU_TESTS_ON_TPU=1 python -m pytest -m cuda tests/test_torch_router_card.py

Without a CUDA device every test here skips.  Tolerance: the card's
gather-dot runs in float32 over the same k order, so routed scores are
within rel 1e-6 of the host scorer's, the fleet's bound
(tests/test_torch_fleet_card.py)."""

import numpy as np
import pytest
import torch

from oni_ml_tpu_torch.config import ServingConfig
from oni_ml_tpu_torch.runner.serve import _perturbed_model, _synthetic_day
from oni_ml_tpu_torch.serving import (DnsEventFeaturizer, FleetRouter,
                                      ReplicaServer, TenantSpec,
                                      score_features)

RTOL = 1e-6
WAIT_S = 60.0


@pytest.fixture()
def card_fleet():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replicas score on the card")
    cfg = ServingConfig(fleet_max_batch=64, fleet_max_wait_ms=5.0,
                        device_score_min=1)
    replicas = {}
    router = FleetRouter(cfg)
    days = {}
    try:
        for i in range(3):
            rid = f"r{i}"
            replicas[rid] = ReplicaServer(rid, cfg, device="cuda")
            router.connect_replica(rid, replicas[rid].host,
                                   replicas[rid].port)
        for i in range(6):
            t = f"t{i}"
            days[t] = _synthetic_day(n_events=96, seed=900 + i)
            rows, model, cuts = days[t]
            router.add_tenant(TenantSpec(tenant=t, dsource="dns"), cuts,
                              model)
        router.start()
        yield router, replicas, days
    finally:
        router.close()
        for rep in replicas.values():
            rep.stop()


def _check(router, days, models, n):
    futs = {t: router.submit_many(t, days[t][0][:n]) for t in days}
    router.flush()
    for t, fs in futs.items():
        got = np.array([f.result(timeout=WAIT_S)[0] for f in fs])
        rows, _, cuts = days[t]
        want = score_features(models[t], DnsEventFeaturizer(cuts)(rows[:n]),
                              "dns")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_card_replicas_score_within_the_fleet_bound(card_fleet):
    router, replicas, days = card_fleet
    models = {t: d[1] for t, d in days.items()}
    _check(router, days, models, 96)
    stats = router.replica_stats()
    assert all(s["device"].startswith("cuda") for s in stats.values())
    assert all(s["cuda_peak_bytes"] > 0 for s in stats.values())
    assert sum(s["events_scored"] for s in stats.values()) == 6 * 96


@pytest.mark.cuda
def test_card_replicas_publish_and_kill(card_fleet):
    """A publish reaches primary and shadow, and after a replica is
    killed the promoted shadows score the published model on the card
    within the bound; no future fails."""
    router, replicas, days = card_fleet
    models = {t: d[1] for t, d in days.items()}
    models["t0"] = _perturbed_model(models["t0"], seed=3)
    assert router.publish("t0", models["t0"]) == 2
    victim = router.placement()["t0"].primary
    futs = {t: router.submit_many(t, days[t][0][:48]) for t in days}
    replicas[victim].kill()
    router.flush()
    for fs in futs.values():
        for f in fs:
            f.result(timeout=WAIT_S)
    _check(router, days, models, 96)
    assert victim not in router.stats()["replicas"]


@pytest.mark.cuda
def test_card_route_dry_run_scores_on_the_card(capsys):
    """`ml_ops route --dry-run synthetic:6x3 --device cuda`: the
    in-process replicas send every flush to the card, and the dry run
    holds their scores to the host scorer within the fleet's bound
    through the kill and the redeploy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replicas score on the card")
    import json

    from oni_ml_tpu_torch.runner import ml_ops

    rc = ml_ops.main(["route", "--dry-run", "synthetic:6x3",
                      "--device", "cuda"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary
    assert summary["route_dry_run"] == "ok"
    assert summary["scoring"] == {"device": "cuda", "engine": "device",
                                  "rtol": RTOL}
    assert summary["chaos_dropped"] == 0
