"""Worker count of the parallel pre stage (port of the part of
oni_ml_tpu/features/shards.py the port runs).

The native featurizers shard a day file themselves (std::thread workers
behind `ffz_ingest_file_parallel` / `dfz_ingest_csv_file_parallel`,
native_src/common.h `shard_bounds`): line-aligned byte ranges with a
first-seen merge, so workers=N writes the bytes of workers=1.  The
pure-Python featurizers read their input in one sequential pass.
"""

from __future__ import annotations

import os


def resolve_pre_workers(workers: int, with_source: bool = False):
    """`pre_workers` as configured: 0 = auto, 1 = the sequential path,
    N = that many shard workers.  Auto consults the plan cache first
    (host-scoped knob `pre_workers`, which tools.pre_probe records for
    this host), else one worker per host core.  The worker count never
    changes an output byte, so a plan entry here is a throughput choice
    only.  `with_source=True` returns (workers, "config" | "plan" |
    "default")."""
    if workers < 0:
        raise ValueError(f"pre_workers must be >= 0, got {workers}")
    auto = max(1, os.cpu_count() or 1)
    if workers:
        out = (workers, "config")
    else:
        from ..plans import lookup_value

        planned = lookup_value("pre_workers")
        # An operator-editable entry counts only inside a sane band: a
        # corrupt 1,000,000 degrades to untuned, not a million threads.
        # 4x the cores covers any oversubscription a probe could win.
        if planned and 1 <= int(planned) <= 4 * auto:
            out = (int(planned), "plan")
        else:
            out = (auto, "default")
    return out if with_source else out[0]
