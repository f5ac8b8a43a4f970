"""A/B of the oni_ml_tpu_torch port's flow day wall between two
checkouts, on one NVIDIA GPU.

    python3 torch_day_ab.py --other DIR [--events N] [--out FILE]

DIR is another checkout of this repo (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists).
The script writes a synthetic flow day once (oni_ml_tpu_torch.synth,
the smoke run's 2,000,000-event day by default) and builds each
checkout's kernels (`build/` under each) before any timed run.  Then
each checkout, in a process of its own, in the order other, this, this,
other, runs the whole day through its CLI,

    python -m oni_ml_tpu_torch.runner.ml_ops 20160122 flow 1e-20 \\
        --flow-path DAY --data-dir FRESH_DIR

with a fresh plan cache (so the crossover is measured in every run, as
in the smoke run).  Each run prints one JSON line: its stage walls
(metrics.json), the writes that ran behind the stages and the wait for
them at the end (run_journal.jsonl's run_end, where the checkout writes
one), the day wall (the stage walls plus that wait), the process wall,
and the engine the day trained.  The script then prints a summary line
(each checkout's day and stage walls from its two runs) and writes
every line to FILE.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FDATE = "20160122"
STAGES = ("pre", "corpus", "lda", "score")


def write_day(path: str, events: int) -> None:
    sys.path.insert(0, HERE)
    from oni_ml_tpu_torch.synth import write_flow_day

    with open(path, "w") as f:
        write_flow_day(f, events, n_src=40_000, n_dst=8_000, seed=11)


def env_for(root: str, plans: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root),
               ONI_ML_TPU_PLAN_CACHE=plans)
    env.pop("ONI_ML_TPU_ESTEP", None)
    return env


def build(root: str) -> float:
    """Compile the checkout's kernels; -> seconds."""
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(root, "oni_ml_tpu_torch", "csrc", "*.cu")))
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-c", "import sys; from oni_ml_tpu_torch.ops "
         "import _cuda; _cuda.build(sys.argv[1:])", *names],
        cwd=root, env=env_for(root, os.devnull), check=True, timeout=600)
    return time.perf_counter() - t0


def run_day(root: str, raw: str, work: str) -> dict:
    """One day through the checkout's CLI -> its walls."""
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", FDATE,
         "flow", "1e-20", "--flow-path", raw, "--data-dir", data],
        cwd=root, env=env_for(root, os.path.join(work, "plans.jsonl")),
        capture_output=True, text=True, timeout=900)
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{root}: ml_ops returned {proc.returncode}")
    day = os.path.join(data, FDATE)
    with open(os.path.join(day, "metrics.json")) as f:
        recs = {r["stage"]: r for r in json.load(f)}
    walls = {s: recs[s]["wall_s"] for s in STAGES}
    write_s = wait_s = 0.0
    journal = os.path.join(day, "run_journal.jsonl")
    if os.path.exists(journal):
        with open(journal) as f:
            run_end = [json.loads(line) for line in f][-1]
        write_s = run_end.get("write_s", 0.0)
        wait_s = run_end.get("write_wait_s", 0.0)
    return {"stage_wall_s": walls, "write_s": write_s,
            "write_wait_s": wait_s,
            "day_wall_s": sum(walls.values()) + wait_s,
            "process_s": process_s, "engine": recs["lda"]["engine"],
            "member": recs["lda"]["member"],
            "em_iters": recs["lda"]["em_iters"],
            "em_s": recs["lda"]["em_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--events", type=int, default=2_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(args.other, "oni_ml_tpu_torch")):
        raise SystemExit("--other must be a checkout with oni_ml_tpu_torch/")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the A/B needs one GPU")
    tmp = tempfile.mkdtemp(prefix="oni_day_ab_")
    lines = []
    runs = {"other": [], "this": []}
    try:
        raw = os.path.join(tmp, "flow_day.csv")
        t0 = time.perf_counter()
        write_day(raw, args.events)
        lines.append({"events": args.events,
                      "write_day_s": time.perf_counter() - t0,
                      "build_s": {"other": build(args.other),
                                  "this": build(HERE)}})
        print(json.dumps(lines[-1]), flush=True)
        for i, label in enumerate(("other", "this", "this", "other")):
            root = args.other if label == "other" else HERE
            work = os.path.join(tmp, f"run{i}")
            rec = dict(run_day(root, raw, work), label=label)
            shutil.rmtree(work, ignore_errors=True)
            runs[label].append(rec)
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {}
    for label, recs in runs.items():
        summary[f"{label}_day_wall_s"] = [r["day_wall_s"] for r in recs]
        for s in STAGES:
            summary[f"{label}_{s}_s"] = [r["stage_wall_s"][s] for r in recs]
        summary[f"{label}_write_wait_s"] = [r["write_wait_s"] for r in recs]
    lines.append({"summary": summary})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
