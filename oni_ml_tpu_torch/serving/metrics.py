"""Per-flush serving metrics as JSON lines, on the shared telemetry
registry (port of oni_ml_tpu/serving/metrics.py).

The runner's convention (one json.dumps'd dict per line to stdout, the
records kept for a file) extends to serving: a consumer tailing the
stream sees {"stage": "serve", ...} lines where it sees {"stage":
"lda", ...} ones in a day's metrics.  The emitter is a thin sink over
the telemetry Recorder: every emit feeds its counters (serve.emits,
serve.events, serve.flagged, serve.errors) and its fixed-boundary
histograms (latency, queue wait, score and demux time, queue depth),
whose p50/p99/p999 the OpenMetrics endpoint and the shutdown snapshot
report; with a journal attached every record is also a crash-safe
{"kind": "serve", ...} line.  A record with a `tenant` field (the
fleet's per-tenant segment records) feeds the tenant's own namespace,
serve.<tenant>.*, so per-tenant and fleet-wide numbers never count each
other.
"""

from __future__ import annotations

import json
import threading
from collections import deque

from ..telemetry.spans import Recorder, current_recorder

# Record fields accumulated as counters (field -> counter name).
_COUNT_FIELDS = (
    ("events", "serve.events"),
    ("flagged", "serve.flagged"),
)
# Record fields observed into histograms (field -> histogram name): the
# end-to-end latency of a flush's oldest event and its parts along the
# path the batcher walks (queue wait, featurize + score, demux).
_HIST_FIELDS = (
    ("latency_ms", "serve.latency_ms"),
    ("queue_wait_ms", "serve.queue_wait_ms"),
    ("score_ms", "serve.score_ms"),
    ("demux_ms", "serve.demux_ms"),
    ("queue_depth", "serve.queue_depth"),
)


def _scoped(name: str, tenant: "str | None") -> str:
    """serve.X -> serve.<tenant>.X for a tenant's record."""
    if not tenant:
        return name
    return f"serve.{tenant}.{name[len('serve.'):]}"


class MetricsEmitter:
    """Thread-safe JSON-lines emitter over a telemetry Recorder.  `path`
    appends each line to a file as it is emitted (flushed per line);
    `to_stdout=False` for library and test embedding.  `records` keeps
    the latest `keep_records` only (a serve process flushing every 50 ms
    would otherwise grow without bound); the durable history is the
    file, stdout or the journal.

    `recorder` defaults to the recorder active at construction (the
    worker thread that emits does not inherit context variables) or a
    private one; `journal` (telemetry Journal or RunJournal) makes every
    record a journal line."""

    def __init__(self, path: str = "", to_stdout: bool = True,
                 keep_records: int = 4096, recorder=None,
                 journal=None) -> None:
        self._lock = threading.Lock()
        self._to_stdout = to_stdout
        self._file = open(path, "a") if path else None
        self.records: "deque[dict]" = deque(maxlen=keep_records)
        self.recorder: Recorder = recorder or current_recorder() or Recorder()
        self._journal = getattr(journal, "journal", journal)

    def emit(self, record: dict) -> None:
        line = json.dumps(record)
        with self._lock:
            self.records.append(record)
            if self._to_stdout:
                print(line, flush=True)
            if self._file is not None:
                self._file.write(line + "\n")
                self._file.flush()
        self._count(record)
        if self._journal is not None:
            self._journal.append({"kind": "serve", **record})

    def _count(self, record: dict) -> None:
        """Fold one record into the Recorder's aggregates: a tenant's
        record into serve.<tenant>.*, any other (single-model flushes,
        the fleet's per-flush aggregate) into serve.*.  Flush-level
        single-model device records also feed serve.device_score_ms /
        serve.device_events, which the serve roofline prices; the fleet
        feeds those per device dispatch itself (its per-tenant records
        repeat the flush's score_ms, and its aggregate spans host and
        device groups, so either would price host work as device
        dispatches)."""
        rec = self.recorder
        tenant = record.get("tenant")
        prefix = f"serve.{tenant}" if tenant else "serve"
        rec.counter(f"{prefix}.emits").add(1)
        if "error" in record or "on_batch_error" in record:
            rec.counter(f"{prefix}.errors").add(1)
        for field, name in _COUNT_FIELDS:
            v = record.get(field)
            if isinstance(v, (int, float)):
                rec.counter(_scoped(name, tenant)).add(int(v))
        for field, name in _HIST_FIELDS:
            v = record.get(field)
            if isinstance(v, (int, float)):
                rec.histogram(_scoped(name, tenant)).observe(float(v))
        if record.get("scorer") == "device" and not tenant \
                and "segments" not in record:
            v = record.get("score_ms")
            if isinstance(v, (int, float)):
                rec.histogram("serve.device_score_ms").observe(float(v))
            ev = record.get("events")
            if isinstance(ev, (int, float)):
                rec.counter("serve.device_events").add(int(ev))

    def snapshot(self) -> dict:
        """The Recorder's aggregate view (what `ml_ops serve` prints at
        shutdown): counters and histogram summaries with p50/p99/p999
        read off the fixed log-bucket boundaries."""
        return self.recorder.snapshot()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
