"""A/B of the oni_ml_tpu_torch port's CUDA build wall between two
checkouts, on the machine with the GPU (nvcc needs the CUDA toolkit).

    python3 torch_build_ab.py --other DIR [--rounds 2] [--out FILE]

DIR is another checkout of this repo (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists).
Each checkout, in a process of its own and in the order other, this,
this, other (per round), builds every E-step library its ops modules
name (each `KERNEL*` of ops/sparse_estep.py, ops/dense_estep.py and
ops/pallas_estep.py) with its own ops/_cuda.py `build`, into a fresh
temporary directory: one nvcc per library, all started together, as
chip_smoke.py's build phase starts them (without its g++ builds).  Each
process prints one JSON line (the libraries, the wall, the card's name
and power limit); the script then prints a summary line and writes
every line to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# Run in each checkout's own process: its ops modules and its _cuda.build.
CHILD = r"""
import json, os, subprocess, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
from oni_ml_tpu_torch.ops import _cuda, dense_estep, pallas_estep, sparse_estep
names = [getattr(m, a) for m in (sparse_estep, dense_estep, pallas_estep)
         for a in sorted(dir(m)) if a.startswith("KERNEL")]
_cuda.BUILD_DIR = tempfile.mkdtemp(prefix="oni_build_ab_")
t0 = time.perf_counter()
_cuda.build(names)
wall = time.perf_counter() - t0
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
print(json.dumps({"tree": sys.argv[2], "libraries": names,
                  "wall_s": wall, "card": smi}))
"""


def build_once(tree: str, label: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, tree, label],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True,
                   help="another checkout of this repo")
    p.add_argument("--rounds", type=int, default=2,
                   help="rounds of other, this, this, other")
    p.add_argument("--out", default=None, help="write every line here")
    args = p.parse_args(argv)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    lines = []
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            rec = build_once(trees[label], label)
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    summary = {"summary": {label: [round(r["wall_s"], 2) for r in lines
                                   if r["tree"] == label]
                           for label in trees}}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines + [summary]:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
