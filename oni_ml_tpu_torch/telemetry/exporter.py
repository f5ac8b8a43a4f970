"""OpenMetrics text rendering of the shared telemetry registry (the
text half of oni_ml_tpu/telemetry/exporter.py, stdlib only; its HTTP
endpoint and file sink wait for a caller, the serving slice).

Counters, the fixed-boundary log-bucket histograms (spans.Histogram —
cumulative `le` buckets, `_sum`, `_count`), and gauges (including the
roofline layer's `roofline.<phase>.*` utilization) render as
OpenMetrics 1.0 text by `render_openmetrics(recorder)`.

Metric naming: registry names are dotted (`em.chunk_dispatches`,
`roofline.em.run_chunk.flops_pct`); the exporter maps them to
OpenMetrics names by replacing every non-alphanumeric with `_`.
Counters gain the mandated `_total` suffix.
"""

from __future__ import annotations

import math
import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] == "_"):
        n = "_" + n
    return n


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_openmetrics(recorder) -> str:
    """The recorder's counters/histograms/gauges as OpenMetrics 1.0
    text (ending in `# EOF`)."""
    with recorder._lock:
        counters = {n: c.value for n, c in recorder.counters.items()}
        histograms = list(recorder.histograms.values())
        gauges = dict(recorder.gauges)
    lines: list[str] = []
    for name in sorted(counters):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}_total {_fmt(counters[name])}")
    for name in sorted(gauges):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(gauges[name])}")
    for h in sorted(histograms, key=lambda h: h.name):
        m = _metric_name(h.name)
        # One lock acquisition for summary AND buckets: an observe
        # landing between separate reads would make `_count` disagree
        # with the `+Inf` bucket — an invalid exposition a strict
        # OpenMetrics parser rejects.
        s, buckets = h.openmetrics_snapshot()
        lines.append(f"# TYPE {m} histogram")
        for le, cum in buckets:
            lines.append(f'{m}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f"{m}_sum {_fmt(s['sum'])}")
        lines.append(f"{m}_count {s['count']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
