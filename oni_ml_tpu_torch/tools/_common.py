"""What the probes share: their command line (--device, --budget-s,
--plan-cache), the plan-store scope and the JSON-line output."""

from __future__ import annotations

import argparse
import contextlib
import json


def parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the measured work runs (default: the card; "
                   "a CPU measurement keys a CPU plan only)")
    p.add_argument("--budget-s", type=float, default=None, metavar="S",
                   help="wall-clock budget of the sweep: no candidate "
                   "starts after it (the first always runs)")
    p.add_argument("--plan-cache", default=None, metavar="PATH",
                   help="plan-cache file to record into (default: "
                   "ONI_ML_TPU_PLAN_CACHE, else ~/.cache/oni_ml_tpu_torch/"
                   "plans.jsonl)")
    return p


@contextlib.contextmanager
def plan_store(path: "str | None"):
    """The store the probe records into: `path` for the call, else the
    default store.  Yields the store's path."""
    from .. import plans

    if not path:
        yield plans.default_path()
        return
    store = plans.PlanStore(path)
    try:
        with plans.use_store(store):
            yield path
    finally:
        store.close()


def emit(rec: dict) -> None:
    print(json.dumps(rec, default=str), flush=True)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
