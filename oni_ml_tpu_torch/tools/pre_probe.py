"""Pre-stage worker sweep: time the featurizers per worker count and
record this host's `pre_workers` (port of tools/pre_probe.py):

    python -m oni_ml_tpu_torch.tools.pre_probe [--events 2000000]
        [--workers 1,2,4,8,0] [--flow-path F] [--dns-path F] [--reps 2]
        [--budget-s S] [--plan-cache PATH] [--device cuda|cpu]

Without paths it writes synth.py's flow day of `--events` events and a
DNS day of half as many into a temporary directory; given a path, it
measures the days it is given.  Per worker count (0 is auto, the host's
cores; counts that resolve alike run once) each day's featurizer
(native_flow.featurize_flow_file, native_dns.featurize_dns_sources:
parse, cuts, word build, word-count merge) runs `--reps` times at that
explicit count, and the metric is the sum of the days' events/s at
their best walls.  The sweep
runs through plans.autotune under `--budget-s`; the knob is
host-scoped, so the winner keys by the host's fingerprint and `--device`
(accepted for the probes' common command line) changes nothing.  The
worker count never changes a byte of the output
(tests/test_torch_pre_parallel.py).  One JSON line per day and count,
then the `plan_cache_update` line.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

from ._common import emit, parser, plan_store

DEFAULT_WORKERS = (1, 2, 4, 8, 0)   # 0 = auto (the host's cores)


def _write_days(tmp: str, n_events: int) -> "tuple[str, str]":
    from ..synth import write_dns_day, write_flow_day

    flow, dns = (os.path.join(tmp, f"{name}_day.csv")
                 for name in ("flow", "dns"))
    with open(flow, "w") as f:
        write_flow_day(f, n_events)
    with open(dns, "w") as f:
        write_dns_day(f, max(n_events // 2, 1))
    return flow, dns


def sweep(n_events: int = 2_000_000, workers=DEFAULT_WORKERS, *,
          flow_path: "str | None" = None, dns_path: "str | None" = None,
          budget_s: "float | None" = None, reps: int = 2) -> dict:
    """Time every worker count over the flow and the DNS day (synthetic
    ones when neither path is given, else the given ones) and record the
    winner; -> the plan_cache_update record."""
    from .. import native_build, plans
    from ..features import native_dns, native_flow

    auto = max(1, os.cpu_count() or 1)
    # By resolved count: auto resolves from the cores here, never from
    # the plan this sweep exists to fill.
    legs = []
    for w in workers:
        if (w or auto) not in legs:
            legs.append(w or auto)
    tmp = None
    if not (flow_path or dns_path):
        tmp = tempfile.mkdtemp(prefix="oni_pre_probe_")
    try:
        if tmp is not None:
            flow_path, dns_path = _write_days(tmp, n_events)
        days = [(dsource, fn) for dsource, path, fn in (
            ("flow", flow_path, lambda w, t: native_flow.featurize_flow_file(
                flow_path, workers=w, timings=t)),
            ("dns", dns_path, lambda w, t: native_dns.featurize_dns_sources(
                [dns_path], workers=w, timings=t))) if path]

        def measure(w: int) -> float:
            total = 0.0
            for dsource, fn in days:
                best, best_t, events = float("inf"), {}, 0
                for _ in range(reps):
                    timings: dict = {}
                    t0 = time.perf_counter()
                    feats = fn(w, timings)
                    dt = time.perf_counter() - t0
                    if dt < best:
                        best, best_t = dt, timings
                    events = feats.num_events
                total += events / best
                emit({"probe": "pre_worker_sweep", "dsource": dsource,
                      "pre_engine": best_t.get("pre_engine"), "workers": w,
                      "events": events, "events_per_sec": events / best,
                      "wall_s": best, "merge_s": best_t.get("merge_s"),
                      "passes": {key: val for key, val in best_t.items()
                                 if key.endswith("_s")
                                 and key != "merge_s"}})
            return total

        res = plans.autotune("pre_workers", measure, candidates=legs,
                             budget_s=budget_s, mode="max",
                             unit="events/sec (sum over "
                             f"{'+'.join(d for d, _ in days)})",
                             native=native_build.enabled())
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"probe": "plan_cache_update",
            "recorded": plans.lookup_value("pre_workers") == res.value,
            "store": getattr(plans.current_store(), "path", None),
            "host": plans.host_fingerprint(), "pre_workers": res.value,
            "truncated": res.truncated,
            "aggregate_events_per_sec": res.measurements,
            "wall_s": res.wall_s}


def main(argv=None) -> int:
    p = parser("pre_probe",
               "sweep pre_workers over a flow and a DNS day (or the days "
               "given) and record this host's winner into the plan cache")
    p.add_argument("--events", type=int, default=2_000_000)
    p.add_argument("--workers", default=None,
                   help="comma list of worker counts, 0 = auto (default "
                   "1,2,4,8,0)")
    p.add_argument("--flow-path", default=None)
    p.add_argument("--dns-path", default=None)
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    workers = (tuple(int(w) for w in args.workers.split(","))
               if args.workers else DEFAULT_WORKERS)
    with plan_store(args.plan_cache):
        emit(sweep(args.events, workers, flow_path=args.flow_path,
                   dns_path=args.dns_path, budget_s=args.budget_s,
                   reps=args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
