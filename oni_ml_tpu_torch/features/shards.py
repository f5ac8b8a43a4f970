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
    """`pre_workers` as configured: 0 = auto (one worker per host core),
    1 = the sequential path, N = that many shard workers.  The worker
    count never changes an output byte.  `with_source=True` returns
    (workers, "config" | "default")."""
    if workers < 0:
        raise ValueError(f"pre_workers must be >= 0, got {workers}")
    out = (workers, "config") if workers else (
        max(1, os.cpu_count() or 1), "default")
    return out if with_source else out[0]
