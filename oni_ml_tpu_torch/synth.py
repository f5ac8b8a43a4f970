"""Synthetic 27-column netflow days, in the JAX package's benchmark
format (bench.py `_write_flow_day`, default mode): uniform source and
destination populations, a fixed service-port mix, seeded numpy draws.
The same seed and arguments give the same bytes as the benchmark's
writer."""

from __future__ import annotations

import numpy as np


def write_flow_day(f, n_events: int, n_src: int = 4000, n_dst: int = 2000,
                   seed: int = 11, chunk: int = 200_000) -> None:
    """Write `n_events` rows (no header) to the open text file `f`, in
    chunks so multi-million-event days never sit in memory whole.
    Populations above 65,536 hosts switch to three-octet, disjoint
    address spaces (10.a.b.c / 11.a.b.c), as the benchmark's writer
    does."""
    if n_src > (1 << 24) or n_dst > (1 << 24):
        raise ValueError("IP populations cap at 2^24 per side")
    rng = np.random.default_rng(seed)
    svc = np.asarray([80, 443, 22, 53, 8080, 25])
    if n_src > 65536 or n_dst > 65536:
        def fmt_src(v):
            return f"10.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"

        def fmt_dst(v):
            return f"11.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"
    else:
        def fmt_src(v):
            return f"10.0.{v >> 8}.{v & 255}"

        def fmt_dst(v):
            return f"10.1.{v >> 8}.{v & 255}"

    for start in range(0, n_events, chunk):
        m = min(chunk, n_events - start)
        hours = rng.integers(0, 24, size=m)
        mins = rng.integers(0, 60, size=m)
        secs = rng.integers(0, 60, size=m)
        sip_i = rng.integers(0, n_src, size=m)
        dip_i = rng.integers(0, n_dst, size=m)
        sports = rng.integers(1024, 60000, size=m)
        dports = svc[rng.integers(0, len(svc), size=m)]
        ipkts = rng.integers(1, 100, size=m)
        ibyts = rng.integers(40, 100_000, size=m)
        f.write("\n".join(
            "2016-01-22 00:00:00,2016,1,22,"
            f"{hours[i]},{mins[i]},{secs[i]},0.0,"
            f"{fmt_src(sip_i[i])},"
            f"{fmt_dst(dip_i[i])},"
            f"{sports[i]},{dports[i]},TCP,,0,0,{ipkts[i]},{ibyts[i]},"
            "0,0,0,0,0,0,0,0,0"
            for i in range(m)
        ) + "\n")
