"""The plan cache's probes on the card, beside what they tune, on one
NVIDIA GPU:

    python3 torch_plans_probe.py [--out FILE]

Builds the kernels and the C++ host libraries, writes chip_smoke.py's
small days and its 2M-event flow and DNS days, runs e2e's sparse card
day of the small flow day, then chip_smoke.plans_phase (the four probes
into a store of their own, the --no-plans --no-compilation-cache day)
and plans_rerun_join (the day on the probes' store in a fresh process).
Then the 2M flow day's EM (sparse pinned) with the probes' plan and with
--no-plans, in turns (plan, off, off, plan): each run's EM wall, and the
bytes of a plan run and an off run, which must be equal; then the
chunk, score and crossover probes over their whole spaces without a
budget; then tests/test_torch_plans_card.py, which must pass.  Prints
one JSON line per step (also to FILE), the card's name and power limit,
and {"ok": true} last; exits non-zero on a failed check.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from oni_ml_tpu_torch import native_build  # noqa: E402
from oni_ml_tpu_torch.ops import (  # noqa: E402
    _cuda, dense_estep, pallas_estep, sparse_estep)

HERE = os.path.dirname(os.path.abspath(__file__))


def em_turns(tmp, store):
    """The 2M flow day's EM with the probes' plan and with --no-plans,
    in turns: {mode: [its lda record's walls and knobs]}."""
    em = {"plan": [], "off": []}
    for i, mode in enumerate(["plan", "off", "off", "plan"]):
        extra = (["--plan-cache", store] if mode == "plan"
                 else ["--no-plans"])
        os.environ["ONI_ML_TPU_ESTEP"] = "sparse"
        try:
            _, recs = cs.ml_ops_day(
                "flow", 1e-20, os.path.join(tmp, "flow_day.csv"),
                os.path.join(tmp, f"em_{mode}_{i}"), "--device", "cuda",
                *extra)
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP", None)
        lda = recs["lda"]
        em[mode].append({k: lda[k] for k in ("em_s", "wall_s", "em_iters",
                                             "host_syncs", "plans")})
    same = cs.same_files(
        os.path.join(tmp, "em_plan_0", "20160122"),
        os.path.join(tmp, "em_off_1", "20160122"),
        ["final.beta", "final.gamma", "final.other", "flow_results.csv"])
    cs.log("em_2m " + json.dumps({"runs": em, "bytes_equal": same}))
    if not all(same.values()):
        cs.fail(f"em_2m: plan and --no-plans bytes differ: {same}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe needs one GPU")
    if args.out:
        log = cs.log
        out = open(args.out, "a")

        def tee(msg):
            log(msg)
            out.write(msg + "\n")
            out.flush()
        cs.log = tee
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"device {smi} cores {os.cpu_count()}")
    t0 = time.perf_counter()
    native = threading.Thread(
        target=lambda: native_build.build(list(native_build.SOURCES)))
    native.start()
    _cuda.build([sparse_estep.KERNEL, dense_estep.KERNEL,
                 pallas_estep.KERNEL])
    native.join()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="oni_plans_probe_")
    os.environ["ONI_ML_TPU_PLAN_CACHE"] = os.path.join(tmp, "plans.jsonl")
    started = None
    try:
        raws = cs.small_days(tmp)
        started = cs.plans_off_start(tmp, raws["flow"])
        cs.run_day("flow", raws["flow"],
                   os.path.join(tmp, "small_flow_sparse_cuda"), "cuda",
                   "sparse", 5)
        from oni_ml_tpu_torch.synth import write_dns_day, write_flow_day

        with open(os.path.join(tmp, "flow_day.csv"), "w") as f:
            write_flow_day(f, cs.PIPELINE_EVENTS, n_src=40_000,
                           n_dst=8_000, seed=11)
        with open(os.path.join(tmp, "dns_day.csv"), "w") as f:
            write_dns_day(f, cs.DNS_EVENTS, n_clients=20_000,
                          n_doms=5_000, seed=13)
        t1 = time.perf_counter()
        state = cs.plans_phase(tmp, raws, started)
        cs.log(f"wall plans: {time.perf_counter() - t1:.1f} s")
        cs.log("plans launches " + json.dumps(
            cs.plans_rerun_join(tmp, state)))
        em_turns(tmp, os.path.join(tmp, "probes.jsonl"))
        full = ["--plan-cache", os.path.join(tmp, "full.jsonl")]
        for tool in ("em_chunk_probe", "score_probe", "estep_probe"):
            cs.run_tool(tool, full)
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "cuda", "-q",
             "tests/test_torch_plans_card.py"],
            env=dict(os.environ, ONI_ML_TPU_TESTS_ON_TPU="1"),
            capture_output=True, text=True, cwd=HERE)
        cs.log(f"card test rc {r.returncode} {r.stdout[-400:]}")
        if r.returncode != 0:
            cs.fail("tests/test_torch_plans_card.py failed")
    finally:
        if started is not None and started["proc"].poll() is None:
            started["proc"].kill()
            started["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
