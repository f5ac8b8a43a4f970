"""Dense-vs-sparse E-step crossover per corpus density: measure and
record the `estep_engine` plan entries (port of part 2 of
tools/estep_probe.py):

    python -m oni_ml_tpu_torch.tools.estep_probe [--k 20] [--v 8192]
        [--b 1024] [--densities 0.5,1,2,5,10] [--precision f32|bf16]
        [--device cuda|cpu] [--budget-s S] [--plan-cache PATH]

Per density the document length L is density x V, padded to the
power-of-two bucket the bucketed layout would pick (floored at the
resolved `sparse_estep_l`); `ops/sparse_estep.engine_crossover(...,
force=True)` then times one E-step through each engine at (K, V, B, L)
(`measure_crossover`: 8 fixed-point iterations each, the densified
batch made outside the dense timing) and records the winner under the
exact shape key and the density-band key, keyed by the device and both
kernels' build hashes, as the trainer's own crossover does, and by the
precision (a bf16 day reads only bf16 entries).  No density
starts after `--budget-s` (the first always runs).  One JSON line per
density, then the `plan_cache_update` line.

Part 1 of the JAX probe, the sweep of the sparse kernel's doc block,
has no port: on the card the block is a rule of the kernel's geometry
and also its stop group (plans/knobs.py).
"""

from __future__ import annotations

import sys
import time

from ._common import emit, parser, plan_store

DEFAULT_DENSITIES = (0.5, 1.0, 2.0, 5.0, 10.0)


def bucket_len(n: int, min_len: int) -> int:
    b = min_len
    while b < n:
        b *= 2
    return b


def sweep(k: int = 20, v: int = 8192, b: int = 1024,
          densities=DEFAULT_DENSITIES, *, device: str = "cuda",
          budget_s: "float | None" = None, precision: str = "f32") -> dict:
    """The crossover at every density (until the budget); -> the
    plan_cache_update record."""
    from .. import plans
    from ..device import resolve_device
    from ..ops import sparse_estep

    dev = resolve_device(device)
    min_len, _ = sparse_estep.resolve_layout_len(None, device=dev)
    kernels = sparse_estep.crossover_kernels()
    t0 = time.perf_counter()
    points = []
    for density in densities:
        if points and budget_s is not None and \
                time.perf_counter() - t0 >= budget_s:
            break
        l = bucket_len(max(1, round(density / 100.0 * v)), min_len)
        cross = sparse_estep.engine_crossover(k, v, b, l, force=True,
                                              precision=precision,
                                              device=dev)
        exact, band = sparse_estep.crossover_shapes(k, v, b, l, precision)
        recorded = all(
            plans.lookup_value("estep_engine", shape, dev, kernels)
            is not None for shape in (exact, band))
        emit({"probe": "estep_crossover", "device": str(dev),
              "density_pct": density, **cross})
        points.append({"density_pct": density, "b": b, "l": l,
                       "shape": exact, "band": band,
                       "engine": cross["engine"], "recorded": recorded})
    return {"probe": "plan_cache_update",
            "recorded": all(p["recorded"] for p in points),
            "store": getattr(plans.current_store(), "path", None),
            "backend": plans.plan_backend(dev, kernels),
            "knobs_recorded": ["estep_engine"], "points": points,
            "truncated": len(points) < len(densities),
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = parser("estep_probe",
               "measure the dense-vs-sparse E-step crossover per density "
               "and record it into the plan cache")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--v", type=int, default=8192)
    p.add_argument("--b", type=int, default=1024)
    p.add_argument("--densities", default=None,
                   help="comma list of densities in percent (default "
                   "0.5,1,2,5,10)")
    p.add_argument("--precision", choices=["f32", "bf16"], default="f32",
                   help="the E-steps' storage mode the crossover times "
                   "(LDAConfig.dense_precision; keys its entries)")
    args = p.parse_args(argv)
    densities = (tuple(float(d) for d in args.densities.split(","))
                 if args.densities else DEFAULT_DENSITIES)
    with plan_store(args.plan_cache):
        emit(sweep(args.k, args.v, args.b, densities, device=args.device,
                   budget_s=args.budget_s, precision=args.precision))
    return 0


if __name__ == "__main__":
    sys.exit(main())
