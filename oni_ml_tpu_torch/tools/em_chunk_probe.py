"""EM chunk sweep: time the chunk runner per candidate of
`fused_em_chunk` and record the winner (port of tools/tpu_probes.py
`chunk_sweep`):

    python -m oni_ml_tpu_torch.tools.em_chunk_probe [--k 20] [--v 8192]
        [--b 4096] [--l 128] [--rounds 3] [--device cuda|cpu]
        [--budget-s S] [--plan-cache PATH]

At the bench shape (K=20, V=8192, B=4096, L=128, float32) one batch of
random documents trains through `models/fused.make_chunk_runner` with
the sparse E-step kernel, as the chunk driver runs it.  Per candidate
the runner enqueues `chunk` EM iterations a dispatch (em_tol 0, so no
dispatch stops early): one warm-up dispatch, then `--rounds` timed ones,
each timed to its host sync; the metric is docs/s at the best time per
EM iteration.  The sweep runs through plans.autotune under `--budget-s`,
and the winner is recorded under the exact shape key (plans.em_shape of
the batch) and under "*", as the JAX sweep records it, keyed by the
device and the E-step kernels' build hashes.  One JSON line per
candidate, then the `plan_cache_update` line.

A fit runs min(fused_em_chunk, host_sync_every) iterations a dispatch
(models/lda.py `_fused_loop`): at the default sync of 16 any recorded
chunk of 16 or more dispatches as the default does.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ._common import emit, parser, plan_store

K, V, B, L = 20, 8192, 4096, 128


def bench_batch(k: int, v: int, b: int, l: int, seed: int = 7):
    """One batch of `b` documents of `l` tokens each: word ids uniform
    over the vocabulary, counts 1-4."""
    from ..io import Batch

    rng = np.random.default_rng(seed)
    return Batch(word_idx=rng.integers(0, v, size=(b, l)).astype(np.int32),
                 counts=rng.integers(1, 5, size=(b, l)).astype(np.float32),
                 doc_index=np.arange(b, dtype=np.int32),
                 doc_mask=np.ones(b, np.float32))


def sweep(k: int = K, v: int = V, b: int = B, l: int = L, *,
          device: str = "cuda", budget_s: "float | None" = None,
          rounds: int = 3, candidates=None) -> dict:
    """Time every candidate chunk (the knob's space, or `candidates`)
    and record the winner; -> the plan_cache_update record."""
    import torch

    from .. import plans
    from ..config import LDAConfig
    from ..device import resolve_device
    from ..models import fused
    from ..models.lda import init_log_beta
    from ..ops import _cuda, sparse_estep

    dev = resolve_device(device)
    cfg = LDAConfig(num_topics=k)
    batch = bench_batch(k, v, b, l)
    groups = fused.stack_batches([batch], dev)
    lb0 = init_log_beta(torch.Generator().manual_seed(cfg.seed), k, v,
                        device=dev)

    def measure(chunk: int) -> float:
        run = fused.make_chunk_runner(
            num_docs=b, num_topics=k, num_terms=v, chunk=chunk,
            var_max_iters=cfg.var_max_iters, var_tol=cfg.var_tol,
            em_tol=0.0, estimate_alpha=cfg.estimate_alpha,
            e_step_fn=sparse_estep.e_step, dense_wmajor=cfg.dense_wmajor,
            warm_start=cfg.warm_start_gamma,
            alpha_max_iters=cfg.alpha_max_iters)
        res = run(lb0, cfg.alpha_init, float("nan"), groups.arrays, chunk)
        int(res.steps_done)                   # the warm-up's host sync
        best = float("inf")
        for _ in range(rounds):
            t0 = time.perf_counter()
            res = run(res.log_beta, res.alpha, res.ll_prev, groups.arrays,
                      chunk, res.gammas, True)
            steps = int(res.steps_done)        # the host sync
            best = min(best, (time.perf_counter() - t0) / steps)
        ll = float(res.lls[steps - 1])
        if not np.isfinite(ll):
            raise RuntimeError(f"chunk {chunk}: likelihood {ll}")
        emit({"probe": "chunk_sweep", "device": str(dev), "chunk": chunk,
              "k": k, "v": v, "b": b, "l": l,
              "t_iter_ms": best * 1e3, "docs_per_sec": b / best})
        return b / best

    kernels = _cuda.estep_kernels()
    shape = plans.em_shape(k, v, [batch])
    res = plans.autotune("fused_em_chunk", measure, candidates=candidates,
                         shape=shape, budget_s=budget_s, mode="max",
                         device=dev, kernels=kernels, unit="docs/sec",
                         rounds=rounds)
    recorded = plans.lookup_value("fused_em_chunk", shape, dev,
                                  kernels) == res.value
    # The wildcard projection, as the JAX sweep writes it: the chunk
    # amortizes the per-dispatch host cost, which the shape barely moves.
    recorded_wild = plans.record_value(
        "fused_em_chunk", res.value, shape="*", source="probe",
        measurements=res.measurements, device=dev, kernels=kernels,
        unit="docs/sec", from_shape=shape)
    return {"probe": "plan_cache_update", "recorded": recorded,
            "recorded_wildcard": recorded_wild,
            "store": getattr(plans.current_store(), "path", None),
            "backend": plans.plan_backend(dev, kernels), "shape": shape,
            "fused_em_chunk": res.value, "truncated": res.truncated,
            "measurements": res.measurements, "wall_s": res.wall_s}


def main(argv=None) -> int:
    p = parser("em_chunk_probe",
               "sweep fused_em_chunk at the bench shape and record the "
               "winner into the plan cache")
    p.add_argument("--k", type=int, default=K)
    p.add_argument("--v", type=int, default=V)
    p.add_argument("--b", type=int, default=B)
    p.add_argument("--l", type=int, default=L)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--chunks", default=None,
                   help="comma list of candidates (default: the knob's "
                   "space, 16,32,64,128,256)")
    args = p.parse_args(argv)
    cands = (tuple(int(c) for c in args.chunks.split(","))
             if args.chunks else None)
    with plan_store(args.plan_cache):
        emit(sweep(args.k, args.v, args.b, args.l, device=args.device,
                   budget_s=args.budget_s, rounds=args.rounds,
                   candidates=cands))
    return 0


if __name__ == "__main__":
    sys.exit(main())
