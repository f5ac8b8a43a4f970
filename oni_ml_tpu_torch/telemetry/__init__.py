"""The run's flight recorder (port of oni_ml_tpu/telemetry):

    journal.py    append-only JSONL run journal: atomic line writes,
                  bounded-loss fsync cadence, truncated-tail-tolerant
                  replay; RunJournal is the day's record vocabulary and
                  resume contract.
    spans.py      span/counter/histogram registry on monotonic clocks
                  with Chrome trace-event export; maybe_span() is the
                  zero-cost library hook.
    heartbeat.py  background device-liveness prober; a dead device
                  becomes a clean BackendLost instead of a hang.
    roofline.py   analytic FLOP and byte counts per entry point, against
                  the card's published peaks, journaled as
                  {"kind": "roofline"} records.
    exporter.py   OpenMetrics text of the shared registry, its HTTP
                  endpoint (MetricsServer) and file sink.
"""

from .exporter import MetricsServer, render_openmetrics, write_openmetrics
from .heartbeat import BackendLost, HeartbeatMonitor
from .journal import Journal, RunJournal
from .spans import Recorder, current_recorder, maybe_span, use_recorder

__all__ = [
    "BackendLost",
    "HeartbeatMonitor",
    "Journal",
    "MetricsServer",
    "Recorder",
    "RunJournal",
    "current_recorder",
    "maybe_span",
    "render_openmetrics",
    "use_recorder",
    "write_openmetrics",
]
