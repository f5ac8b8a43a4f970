"""Device-scorer chunk sweep: time the flow scoring pipeline per
candidate of `score_device_chunk` and record the winner, then the
host-or-device dispatch calibration (port of tools/score_probe.py):

    python -m oni_ml_tpu_torch.tools.score_probe [--events 400000]
        [--chunks 8192,...] [--reps 3] [--device cuda|cpu]
        [--budget-s S] [--plan-cache PATH]

A random K=20 model of 40,000 IPs and 8,000 words scores `--events`
flow events through `scoring/pipeline.filtered_flow_scores` (two
gather-dots, min, threshold and compaction per chunk) at a threshold
that keeps about half of them.  Per chunk: one warm-up call, then the
best of `--reps` calls, each timed to its end (the survivors are read
back); the metric is events/s.  The sweep runs through plans.autotune
under `--budget-s` and records the winner for the device ("*" shape).
Then `scoring.dispatch_calibration(force=True)` measures and records
the break-even.  One JSON line per chunk, the calibration's line, then
the `plan_cache_update` line.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ._common import emit, parser, plan_store


def sweep(n_events: int = 400_000, chunks=None, *, device: str = "cuda",
          budget_s: "float | None" = None, reps: int = 3,
          k: int = 20, n_ips: int = 40_000, n_words: int = 8_000) -> dict:
    """Time every candidate chunk (the knob's space, or `chunks`),
    record the winner and the calibration; -> the plan_cache_update
    record."""
    from .. import plans
    from ..device import resolve_device
    from ..scoring import (DispatchStats, ScoringModel, dispatch_calibration,
                           filtered_flow_scores)
    from ..scoring.score import _batched_scores

    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    model = ScoringModel(ip_index={}, theta=rng.random((n_ips + 1, k)),
                         word_index={}, p=rng.random((n_words + 1, k)))
    sa, da = (rng.integers(0, n_ips, n_events).astype(np.int32)
              for _ in range(2))
    sw, dw = (rng.integers(0, n_words, n_events).astype(np.int32)
              for _ in range(2))
    # About half the events survive: a real threshold's load without
    # hanging on the synthetic score distribution.
    threshold = float(np.median(np.minimum(_batched_scores(model, sa, sw),
                                           _batched_scores(model, da, dw))))

    def measure(chunk: int) -> float:
        filtered_flow_scores(model, sa, sw, da, dw, threshold, chunk=chunk,
                             device=dev)
        best, stats = float("inf"), None
        for _ in range(reps):
            st = DispatchStats()
            t0 = time.perf_counter()
            out = filtered_flow_scores(model, sa, sw, da, dw, threshold,
                                       chunk=chunk, stats=st, device=dev)
            dt = time.perf_counter() - t0
            if dt < best:
                best, stats = dt, st
        if not len(out[0]):
            raise RuntimeError(f"chunk {chunk}: no survivor")
        emit({"probe": "score_chunk_sweep", "device": str(dev),
              "chunk": chunk, "n_events": n_events,
              "events_per_sec": n_events / best, "wall_ms": best * 1e3,
              "dispatches": stats.dispatches, "h2d_bytes": stats.h2d_bytes,
              "d2h_bytes": stats.d2h_bytes, "survivors": stats.survivors})
        return n_events / best

    res = plans.autotune("score_device_chunk", measure, candidates=chunks,
                         budget_s=budget_s, mode="max", device=dev,
                         unit="events/sec", n_events=n_events)
    recorded = plans.lookup_value("score_device_chunk", "*", dev) \
        == res.value
    # force=True measures again and records its own plan entry.
    cal = dispatch_calibration(force=True, device=dev)
    emit({"probe": "score_dispatch_calibration", "device": str(dev), **cal})
    return {"probe": "plan_cache_update", "recorded": recorded,
            "calibration_recorded":
                plans.lookup_value("dispatch_calibration", "*", dev)
                is not None,
            "store": getattr(plans.current_store(), "path", None),
            "backend": plans.plan_backend(dev),
            "score_device_chunk": res.value, "truncated": res.truncated,
            "measurements": res.measurements, "wall_s": res.wall_s,
            "knobs_recorded": ["score_device_chunk", "dispatch_calibration"]}


def main(argv=None) -> int:
    p = parser("score_probe",
               "sweep score_device_chunk and measure the dispatch "
               "calibration, recording both into the plan cache")
    p.add_argument("--events", type=int, default=400_000)
    p.add_argument("--chunks", default=None,
                   help="comma list of candidates (default: the knob's "
                   "space, 8192 ... 262144)")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    chunks = (tuple(int(c) for c in args.chunks.split(","))
              if args.chunks else None)
    with plan_store(args.plan_cache):
        emit(sweep(args.events, chunks, device=args.device,
                   budget_s=args.budget_s, reps=args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
