"""OpenMetrics text exporter over the shared telemetry registry (port of
oni_ml_tpu/telemetry/exporter.py, stdlib only).

Counters, the fixed-boundary log-bucket histograms (spans.Histogram —
cumulative `le` buckets, `_sum`, `_count`), and gauges (including the
roofline layer's `roofline.<phase>.*` utilization) render as
OpenMetrics 1.0 text, served three ways:

- `render_openmetrics(recorder)` — the text, for tests and tools;
- `MetricsServer(recorder, port)` — a daemon-threaded HTTP endpoint
  (`GET /metrics`) for `ml_ops serve --metrics-port`, so a live serve
  process is scrapeable by any Prometheus-compatible collector;
- `write_openmetrics(path, recorder)` — a file sink for headless runs,
  the same bytes as a scrape.

Metric naming: registry names are dotted (`serve.latency_ms`,
`roofline.em.run_chunk.flops_pct`); the exporter maps them to
OpenMetrics names by replacing every non-alphanumeric with `_`.
Counters gain the mandated `_total` suffix.  A `refresh` callback runs
before each render, so gauges computed at scrape time (the live serve
roofline) stay current without an updater thread.
"""

from __future__ import annotations

import math
import re
import threading

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

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


def render_openmetrics(recorder, *, refresh=None) -> str:
    """The recorder's counters/histograms/gauges as OpenMetrics 1.0
    text (ending in `# EOF`).  `refresh` (a callable) runs first: the
    scrape-time gauges."""
    if refresh is not None:
        try:
            refresh()
        except Exception:
            pass  # a broken refresher must not take the scrape down
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


def write_openmetrics(path: str, recorder, *, refresh=None) -> None:
    """File sink for headless runs: the bytes of a scrape."""
    text = render_openmetrics(recorder, refresh=refresh)
    with open(path, "w") as f:
        f.write(text)


class MetricsServer:
    """Daemon-threaded HTTP endpoint serving `GET /metrics`.

    `port=0` binds an ephemeral port (`.port` reads it back).  The
    handler renders from the live recorder at request time; `close()`
    stops it.  Binds loopback by default: the exposition names backend
    and model internals, so an all-interfaces bind ("0.0.0.0") is an
    explicit choice."""

    def __init__(self, recorder, port: int = 8040,
                 host: str = "127.0.0.1", refresh=None) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = render_openmetrics(
                        exporter.recorder, refresh=exporter.refresh).encode()
                except Exception as e:
                    self.send_error(500, repr(e)[:100])
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:
                pass  # scrapes must not spam the serve stdout stream

        self.recorder = recorder
        self.refresh = refresh
        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="oni-metrics-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
