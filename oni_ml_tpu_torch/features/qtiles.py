"""Precomputed flow quantile cuts (port of oni_ml_tpu/features/qtiles.py):
the reference's offline qtiles side path (gen_qtiles.sh + qtiles.py).

The cuts of a flow day are computed once, offline, and stored as one
line

    <ibyt cuts>,<ipkt cuts>,<time cuts>

each list space-separated (the field order of the reference's consumer,
flow_pre_lda.scala:95-98).  The runner reads the file with `--qtiles`,
which skips the in-run ECDF pass and pins word identity across days.

CLI:  python -m oni_ml_tpu_torch.features.qtiles raw_flow.csv flow_qtiles
"""

from __future__ import annotations

import sys
from typing import Iterable

import numpy as np

from ..io.formats import contract_open
from .flow import FLOW_COLUMNS, NUM_FLOW_COLUMNS, _to_double
from .quantiles import DECILES, QUINTILES, ecdf_cuts


def write_flow_qtiles(path: str, time_cuts: np.ndarray,
                      ibyt_cuts: np.ndarray, ipkt_cuts: np.ndarray) -> None:
    def fmt(xs):
        return " ".join(repr(float(x)) for x in xs)

    with open(path, "w") as f:
        f.write(f"{fmt(ibyt_cuts)},{fmt(ipkt_cuts)},{fmt(time_cuts)}\n")


def read_flow_qtiles(path: str):
    """-> (time_cuts, ibyt_cuts, ipkt_cuts), the order of featurize_flow's
    `precomputed_cuts`."""
    with contract_open(path) as f:
        line = f.read().strip()
    parts = line.split(",")
    if len(parts) != 3:
        raise ValueError(
            f"{path}: expected 3 comma-separated cut lists, got {len(parts)}")
    ibyt, ipkt, time = (
        np.array([float(x) for x in p.split()], dtype=np.float64)
        for p in parts)
    return time, ibyt, ipkt


def compute_flow_qtiles(lines: Iterable[str], skip_header: bool = True):
    """One pass over raw flow CSV -> (time_cuts, ibyt_cuts, ipkt_cuts),
    the in-run ECDF's cuts (features/quantiles.py)."""
    c = FLOW_COLUMNS
    times, ibyts, ipkts = [], [], []
    header = None
    for line in lines:
        if skip_header:
            if header is None:
                header = line
                continue
            if line == header:
                continue
        parts = line.strip().split(",")
        if len(parts) != NUM_FLOW_COLUMNS:
            continue
        times.append(_to_double(parts[c["hour"]])
                     + _to_double(parts[c["minute"]]) / 60.0
                     + _to_double(parts[c["second"]]) / 3600.0)
        ibyts.append(_to_double(parts[c["ibyt"]]))
        ipkts.append(_to_double(parts[c["ipkt"]]))
    return (ecdf_cuts(np.array(times), DECILES),
            ecdf_cuts(np.array(ibyts), DECILES),
            ecdf_cuts(np.array(ipkts), QUINTILES))


def main(argv: "list[str] | None" = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    wants_help = bool(args) and args[0] in ("-h", "--help")
    if wants_help or len(args) != 2:
        print("usage: python -m oni_ml_tpu_torch.features.qtiles "
              "<raw_flow.csv> <out_qtiles>",
              file=sys.stdout if wants_help else sys.stderr)
        return 0 if wants_help else 2
    with open(args[0]) as f:
        time_cuts, ibyt_cuts, ipkt_cuts = compute_flow_qtiles(
            line.rstrip("\n") for line in f)
    write_flow_qtiles(args[1], time_cuts, ibyt_cuts, ipkt_cuts)
    print(f"wrote {args[1]}: time={time_cuts} ibyt={ibyt_cuts} "
          f"ipkt={ipkt_cuts}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
