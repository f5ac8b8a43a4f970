"""Analyst feedback ingestion for the flow day (port of the flow half of
oni_ml_tpu/features/feedback.py).

Rows an analyst marked non-threatening (severity 3) in
``flow_scores.csv`` are replicated DUPFACTOR times into the corpus so
their probability rises above the suspicion threshold (ml_ops.sh:31,
flow_pre_lda.scala:253-268).  The reference's 22-column -> 27-column
converter loses its commas (flow_pre_lda.scala:243-245); like the JAX
package we build real comma-separated rows, with the reference's "##"
filler for unknown fields.
"""

from __future__ import annotations

import os

from ..io.formats import contract_open as _open

# flow_scores.csv schema (flow_pre_lda.scala:150-171)
_FLOW_FB_SEV = 0
_FLOW_FB_TSTART = 1
_FLOW_FB_SRCIP = 2
_FLOW_FB_DSTIP = 3
_FLOW_FB_SPORT = 4
_FLOW_FB_DPORT = 5
_FLOW_FB_IPKT = 8
_FLOW_FB_IBYT = 9
_FLOW_FB_NUM_FIELDS = 22


def _flow_feedback_to_flow_row(fields: list[str]) -> str:
    """22-col feedback row -> 27-col flow CSV.  tstart is
    'YYYY-MM-DD HH:MM:SS'; hour/min/sec land in cols 4-6."""
    hms = fields[_FLOW_FB_TSTART].split(" ")[1].split(":")
    out = ["##"] * 27
    out[4], out[5], out[6] = hms[0], hms[1], hms[2]
    out[8] = fields[_FLOW_FB_SRCIP]
    out[9] = fields[_FLOW_FB_DSTIP]
    out[10] = fields[_FLOW_FB_SPORT]
    out[11] = fields[_FLOW_FB_DPORT]
    out[16] = fields[_FLOW_FB_IPKT]
    out[17] = fields[_FLOW_FB_IBYT]
    return ",".join(out)


def read_flow_feedback_rows(
    path: str, dup_factor: int, severity: int = 3
) -> list[str]:
    """flow_scores.csv -> duplicated 27-column CSV rows.  A missing file
    means no feedback (flow_pre_lda.scala:253)."""
    if not os.path.exists(path):
        return []
    with _open(path) as f:
        lines = f.read().splitlines()[1:]  # drop header
    out: list[str] = []
    for line in lines:
        fields = line.split(",")
        if len(fields) != _FLOW_FB_NUM_FIELDS:
            continue
        try:
            if int(fields[_FLOW_FB_SEV]) != severity:
                continue
            row = _flow_feedback_to_flow_row(fields)
        except (ValueError, IndexError):
            # Malformed severity or tstart: skip the row, keep the day.
            continue
        out.extend([row] * dup_factor)
    return out
