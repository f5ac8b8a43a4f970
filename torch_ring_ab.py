"""A/B of the port's same-host shared-memory rings against TCP.

    python3 torch_ring_ab.py --refits [--rounds 3] [--out FILE]
    python3 torch_ring_ab.py --route [--device cpu] [--rounds 2]
    python3 torch_ring_ab.py --cli [--out FILE]

`--refits` (on one NVIDIA GPU): `continuous --replicated 2`
(chip_smoke.repl_continuous) over the smoke's 2M-event flow and DNS
days' first event hour, over TCP and on rings in turns: each round runs
the two forward, the next backward, after one discarded warm-up run.
Each run's first refits are fitted before the router binding scores,
beside two idle ring readers or none, so their walls price the readers'
GIL traffic.  Prints one `ab` line per run (the first refit walls) and
a summary line (per transport the median of the two tenants' summed
first-refit walls, and its ratio to TCP's).

`--route`: `ml_ops route`'s per-event stream through the library: two
spawned `ml_ops replica` processes (on `--device`, host scoring) behind
a FleetRouter, four synthetic DNS tenants, 14,400 events submitted one
call per event as the CLI does, rings and TCP in turns.  Prints each
run's events/s and route latency p50/p99.

`--cli` (on one NVIDIA GPU): chip_smoke.py's `route` CLI run alone
(`repl_cli`: three replicas on rings over the TCP KV, the autoscaler, a
rolling redeploy halfway) after the smoke's own 2M-event flow and DNS
pipelines have made its two days' models.  Prints the run's record
(decisions, each replica's events scored, events/s, route p50/p99); the
smoke's checks fail it as they fail the smoke.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# variant -> wire_shm.
TRANSPORTS = {"tcp": False, "rings": True}


def refits(rounds: int, out) -> None:
    import chip_smoke as cs
    from oni_ml_tpu_torch import native_build
    from oni_ml_tpu_torch.ops import _cuda
    from oni_ml_tpu_torch.synth import write_dns_day, write_flow_day

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card", smi, flush=True)
    native_build.build(list(native_build.SOURCES))
    _cuda.build([cs.sparse_estep.KERNEL, cs.dense_estep.KERNEL,
                 cs.pallas_estep.KERNEL])
    tmp = tempfile.mkdtemp(prefix="ring_ab_")
    os.environ["ONI_ML_TPU_PLAN_CACHE"] = os.path.join(tmp, "plans.jsonl")
    rows = []
    try:
        with open(os.path.join(tmp, "flow_day.csv"), "w") as f:
            write_flow_day(f, cs.PIPELINE_EVENTS, n_src=40_000,
                           n_dst=8_000, seed=11)
        with open(os.path.join(tmp, "dns_day.csv"), "w") as f:
            write_dns_day(f, cs.DNS_EVENTS, n_clients=20_000, n_doms=5_000,
                          seed=13)
        # The first run measures the engine crossover into the plan
        # cache; the runs after it read the plan.
        cs.repl_continuous(tmp, "warmup", 1, False, kill=False)
        names = list(TRANSPORTS)
        for r in range(rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                rec, _ = cs.repl_continuous(tmp, f"{name}_{r}", 1,
                                            TRANSPORTS[name], kill=False)
                row = {"variant": name, "round": r, "card": smi,
                       "first": {t: w[0] for t, w in
                                 rec["refit_walls"].items()},
                       "wall_s": rec["wall_s"]}
                rows.append(row)
                print("ab " + json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sums = {}
    for row in rows:
        sums.setdefault(row["variant"], []).append(
            sum(w[4] for w in row["first"].values()))
    base = statistics.median(sums["tcp"])
    summary = {name: {"sums_s": v, "median_s": statistics.median(v),
                      "over_tcp": statistics.median(v) / base}
               for name, v in sums.items()}
    print("summary " + json.dumps(summary), flush=True)
    if out:
        with open(out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
            f.write(json.dumps({"summary": summary}) + "\n")


def cli(out) -> None:
    import chip_smoke as cs
    from oni_ml_tpu_torch import native_build
    from oni_ml_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card", smi, flush=True)
    native_build.build(list(native_build.SOURCES))
    _cuda.build([cs.sparse_estep.KERNEL, cs.dense_estep.KERNEL,
                 cs.pallas_estep.KERNEL])
    tmp = tempfile.mkdtemp(prefix="ring_ab_")
    os.environ["ONI_ML_TPU_PLAN_CACHE"] = os.path.join(tmp, "plans.jsonl")
    try:
        cs.pipeline(tmp)
        cs.pipeline_dns(tmp)
        rec = cs.repl_cli(tmp, cs.repl_tenants(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["card"] = smi
    print("cli " + json.dumps(rec, default=str), flush=True)
    if out:
        with open(out, "w") as f:
            f.write(json.dumps(rec, default=str) + "\n")


def _day_dir(path, rows, model) -> None:
    """A completed DNS day directory as the port writes one."""
    import pickle

    import numpy as np

    from oni_ml_tpu_torch.features.dns import featurize_dns
    from oni_ml_tpu_torch.io import formats

    os.makedirs(path, exist_ok=True)
    ips = sorted(model.ip_index, key=model.ip_index.get)
    vocab = sorted(model.word_index, key=model.word_index.get)
    formats.write_doc_results(os.path.join(path, "doc_results.csv"), ips,
                              model.theta[:-1])
    formats.write_word_results(
        os.path.join(path, "word_results.csv"), vocab,
        np.log(np.asarray(model.p[:-1], np.float64)).T)
    with open(os.path.join(path, "features.pkl"), "wb") as f:
        pickle.dump(featurize_dns(rows), f)


def route(device: str, rounds: int) -> None:
    from oni_ml_tpu_torch.config import ScoringConfig, ServingConfig
    from oni_ml_tpu_torch.runner.route import _spawn_replicas
    from oni_ml_tpu_torch.runner.serve import _load_featurizer, _synthetic_day
    from oni_ml_tpu_torch.serving import FleetRouter, ModelRegistry, TenantSpec
    from oni_ml_tpu_torch.sources import get as get_source
    from oni_ml_tpu_torch.telemetry.spans import Recorder

    tmp = tempfile.mkdtemp(prefix="ring_route_")
    try:
        tenants, per = {}, {}
        for i, t in enumerate(("alpha", "beta", "gamma", "delta")):
            rows, model, _ = _synthetic_day(seed=80 + i)
            day = os.path.join(tmp, t)
            _day_dir(day, rows, model)
            tenants[t] = (ModelRegistry().load_day(
                day, get_source("dns").fallback(ScoringConfig())).model,
                _load_featurizer(day, None))
            per[t] = [",".join(r) for r in rows[:90]]
        stream = [(t, per[t][j]) for j in range(90) for t in per] * 40
        for r in range(rounds):
            for shm in ((True, False) if r % 2 == 0 else (False, True)):
                cfg = ServingConfig(wire_shm=shm)
                rec = Recorder()
                router = FleetRouter(cfg, recorder=rec)
                spawned = _spawn_replicas(
                    ["r0", "r1"], os.path.join(tmp, "kv"), tmp,
                    ["--device", device, "--device-score-min", "none"])
                try:
                    for rid, (_, host, port) in spawned.items():
                        router.connect_replica(rid, host, port)
                    for t, (model, fz) in tenants.items():
                        router.add_tenant(TenantSpec(tenant=t,
                                                     dsource="dns"),
                                          (), model, featurizer=fz)
                    router.start()
                    t0 = time.perf_counter()
                    futs = [router.submit(t, line) for t, line in stream]
                    router.flush()
                    for f in futs:
                        f.result(timeout=300.0)
                    wall = time.perf_counter() - t0
                    hop = rec.histogram("route.hop_ms").summary()
                    print("route " + json.dumps({
                        "shm": shm, "device": device,
                        "links": router.wire(), "events": len(stream),
                        "events_per_s": len(stream) / wall,
                        "p50_ms": hop["p50"], "p99_ms": hop["p99"]}),
                        flush=True)
                finally:
                    router.close()
                    for proc, _, _ in spawned.values():
                        proc.terminate()
                    for proc, _, _ in spawned.values():
                        proc.wait(timeout=60.0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--refits", action="store_true")
    mode.add_argument("--route", action="store_true")
    mode.add_argument("--cli", action="store_true")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args()
    if args.refits:
        refits(args.rounds or 3, args.out)
    elif args.cli:
        cli(args.out)
    else:
        route(args.device, args.rounds or 2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
