"""Show, clear or export the plan cache (port of tools/plan_cache.py):

    python -m oni_ml_tpu_torch.tools.plan_cache show [--knob NAME]
        [--all-backends] [--device cuda|cpu | --no-device]
    python -m oni_ml_tpu_torch.tools.plan_cache clear
    python -m oni_ml_tpu_torch.tools.plan_cache export [DEST] [--knob NAME]

Each takes `--plan-cache PATH` (default: ONI_ML_TPU_PLAN_CACHE, else
~/.cache/oni_ml_tpu_torch/plans.jsonl).

`show` prints a header (the store, the schema, this host's and this
device's fingerprints, the seed files, the records dropped at load),
then one JSON line per resolved entry (the latest per knob, backend and
shape, seeds included).  By default only entries of this host and of
this device (any kernel build) print; `--all-backends` prints all.
`--no-device` skips the device fingerprint, so it starts no CUDA.

`clear` removes the live file; seed files are code and stay.

`export` writes the resolved entries as JSONL in the seed format (to
stdout, or DEST): a file of it under oni_ml_tpu_torch/plans/seeds/ loads
beneath every store.  The port ships none yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _store(path: "str | None"):
    from .. import plans

    return plans.PlanStore(path) if path else plans.default_store()


def _matches(backend: str, fps: set) -> bool:
    """Whether an entry's backend is one of `fps`, with or without a
    kernel-build suffix (plans.plan_backend)."""
    return backend.split("|src:", 1)[0] in fps


def cmd_show(args) -> int:
    from .. import plans

    store = _store(args.plan_cache)
    fps = {plans.host_fingerprint()}
    header = {"store": store.path, "schema": plans.SCHEMA_VERSION,
              "host": plans.host_fingerprint(), "seeds": plans.seed_paths(),
              "dropped_records": store.dropped_records}
    if not args.no_device:
        header["backend"] = plans.device_fingerprint(args.device)
        fps.add(header["backend"])
    print(json.dumps(header), flush=True)
    for e in sorted(store.entries(), key=lambda e: e.key):
        if args.knob and e.knob != args.knob:
            continue
        if not args.all_backends and not _matches(e.backend, fps):
            continue
        print(json.dumps({
            "knob": e.knob, "backend": e.backend, "shape": e.shape,
            "value": e.value, "source": e.source,
            **({"measurements": e.measurements} if e.measurements else {}),
        }), flush=True)
    return 0


def cmd_clear(args) -> int:
    store = _store(args.plan_cache)
    existed = os.path.exists(store.path)
    store.clear()
    print(json.dumps({
        "cleared": store.path, "existed": existed,
        "note": "seed plans under oni_ml_tpu_torch/plans/seeds/ are code "
                "and were not touched"}), flush=True)
    return 0


def cmd_export(args) -> int:
    from ..plans.store import SCHEMA_VERSION

    store = _store(args.plan_cache)
    out = open(args.dest, "w") if args.dest else sys.stdout
    try:
        for e in sorted(store.entries(), key=lambda e: e.key):
            if args.knob and e.knob != args.knob:
                continue
            rec = {k: v for k, v in e.record.items()
                   if k not in ("seq", "t", "mono_ns")}
            rec["schema"] = SCHEMA_VERSION
            out.write(json.dumps(rec) + "\n")
    finally:
        if args.dest:
            out.close()
            print(json.dumps({"exported": args.dest}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="plan_cache",
        description="show/clear/export the measured-plan cache "
        "(oni_ml_tpu_torch/plans)")
    store = argparse.ArgumentParser(add_help=False)
    store.add_argument("--plan-cache", default=None, metavar="PATH")
    sub = p.add_subparsers(dest="cmd", required=True)
    show = sub.add_parser("show", parents=[store],
                          help="print resolved entries")
    show.add_argument("--knob", default=None)
    show.add_argument("--all-backends", action="store_true",
                      help="include entries of other fingerprints")
    show.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                      help="the device whose entries print (default: the "
                      "card)")
    show.add_argument("--no-device", action="store_true",
                      help="host entries only; starts no CUDA")
    sub.add_parser("clear", parents=[store],
                   help="remove the live cache file")
    exp = sub.add_parser("export", parents=[store],
                         help="write entries as a seed-format JSONL stream")
    exp.add_argument("dest", nargs="?", default=None)
    exp.add_argument("--knob", default=None)
    args = p.parse_args(argv)
    return {"show": cmd_show, "clear": cmd_clear,
            "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
