"""Time the dense and fixed-point E-step kernels under a few launch
geometries on one NVIDIA GPU, at chip_smoke.py's shapes and inputs.

    python3 torch_kernel_sweep.py [--out sweep.jsonl]

The fixed-point kernel at each TOKENS_PER_WARP (warps per document
follow from it, ops/pallas_estep.py launch_geometry) and the dense kernel
at each number of warps per document (its launch_geometry otherwise as
it picks it), fresh start, ms per launch by CUDA events
(chip_smoke.time_ms).  Each variant runs twice, in turns
(a, b, ..., b, a), and both times are printed.  One JSON line per
variant, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from oni_ml_tpu_torch.ops import dense_estep, pallas_estep, sparse_estep  # noqa: E402

FIXED_CASES = (("main", 1024, 128, 65, 200, 1e-4), ("long", 8, 4096, 2049, 20, 1e-6),
               ("cluster", 2, 16384, 8193, 20, 1e-6))
DENSE_CASES = (("main_wmajor", 1024, 128, 65, True, 200, 1e-4),
               ("main_rowmajor", 1024, 128, 65, False, 200, 1e-4),
               ("long_wmajor", 8, 4096, 2049, True, 20, 1e-6))
TOKENS_PER_WARP = (32, 64, 128, 256)
WARPS_PER_DOC = (1, 2, 4, 8)
_DENSE_GEOMETRY = dense_estep.launch_geometry


def fixed_runs():
    runs = []
    for label, b, l, lo, cap, tol in FIXED_CASES:
        case = smoke.random_bucket(b, l, lo, seed=b + l + 3, warm=False)
        slab = pallas_estep.gather_slab(
            sparse_estep.exp_beta_table(case["log_beta"]), case["word"])
        args = (slab, case["alpha"], case["counts"], case["mask"], cap, tol)
        for tpw in TOKENS_PER_WARP:
            def fn(args=args, tpw=tpw):
                pallas_estep.TOKENS_PER_WARP = tpw
                return pallas_estep.fixed_point_blocks(*args)

            runs.append(({"kernel": "fixed_point_estep", "case": label,
                          "tokens_per_warp": tpw}, fn,
                         lambda b=b, l=l, tpw=tpw: geometry_fixed(b, l, tpw)))
    return runs


def geometry_fixed(b, l, tpw):
    pallas_estep.TOKENS_PER_WARP = tpw
    return pallas_estep.launch_geometry(b, l, smoke.K)


def dense_runs():
    runs = []
    for label, b, l, lo, wmajor, cap, tol in DENSE_CASES:
        case = smoke.random_bucket(b, l, lo, seed=b + 7 + (0 if l == 128 else l),
                                   warm=False)
        dense = dense_estep.densify(case["word"], case["counts"], smoke.V)
        c = dense.t().contiguous() if wmajor else dense
        eb = dense_estep.padded_exp_beta(case["log_beta"], smoke.W)
        args = (eb, case["alpha"], c, case["mask"], cap, tol)
        block = dense_estep.pick_block(b, smoke.W, smoke.K)
        for wpd in WARPS_PER_DOC:
            if 32 * block * wpd > 256:
                continue

            def fn(args=args, wpd=wpd, wmajor=wmajor, l=l):
                dense_estep.launch_geometry = (
                    lambda *a, wpd=wpd: forced_dense(wpd, *a))
                try:
                    return dense_estep.fixed_point_blocks(*args, wmajor=wmajor,
                                                          cells=l)
                finally:
                    dense_estep.launch_geometry = _DENSE_GEOMETRY

            runs.append(({"kernel": "dense_estep", "case": label,
                          "warps_per_doc": wpd}, fn,
                         lambda b=b, l=l, wpd=wpd: forced_dense(
                             wpd, b, smoke.W, smoke.K, None, l)))
    return runs


def forced_dense(wpd, b, w, k, block=None, cells=None):
    """The dense kernel's geometry with `wpd` warps per document."""
    geom = _DENSE_GEOMETRY(b, w, k, block, cells)
    return dict(geom, warps_per_doc=wpd, threads=32 * geom["block"] * wpd)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the sweep needs one GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = fixed_runs() + dense_runs()
    times = [[] for _ in runs]
    for order in (range(len(runs)), reversed(range(len(runs)))):
        for i in order:
            times[i].append(smoke.time_ms(runs[i][1], 10))
    out = open(args.out, "w") if args.out else None
    for (rec, fn, geom), t in zip(runs, times):
        iters = fn()[-1]
        line = json.dumps(dict(rec, ms=t, iters_mean=float(iters.float().mean()),
                               geometry=geom()))
        print("sweep " + line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
