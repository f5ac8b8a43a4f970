"""Nestable span / counter / histogram telemetry on monotonic clocks
(port of oni_ml_tpu/telemetry/spans.py, stdlib only).

The one shared vocabulary of the run's flight recorder:

    rec = Recorder(journal=journal)
    with use_recorder(rec):
        with rec.span("stage.lda", fdate="20160122"):
            ...
            rec.counter("em.chunk_dispatches").add(1)
            rec.histogram("em.host_sync_s").observe(0.012)

Spans nest (per-thread depth tracking), time exclusively on the
MONOTONIC clock (`time.monotonic_ns`: the wall clock can step backwards
under NTP), and export as Chrome trace-event JSON (`chrome_trace()`),
loadable in Perfetto / chrome://tracing.  When the Recorder is bound to
a journal (telemetry/journal.py), every completed span also appends a
crash-safe `{"kind": "span", ...}` line, so a run killed mid-flight
still leaves its timeline on disk.

Instrumented library code must not pay when nobody is recording:
`current_recorder()` is a contextvar that defaults to None, and
`maybe_span(...)` collapses to a no-op context manager when no recorder
is active, so hot paths (the scoring chunk loop, the EM drivers' host
syncs) carry spans at no cost outside an instrumented run.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import math
import os
import threading
import time
from collections import deque

# Monotonic nanosecond clock — the ONLY clock spans use.  time.time()
# is reserved for wall-clock *timestamps* (journal record `t` fields),
# never durations.
now_ns = time.monotonic_ns

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "oni_ml_tpu_torch_recorder", default=None
)


def current_recorder():
    """The Recorder active in this context, or None (the default:
    nothing records, instrumented code short-circuits)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_recorder(recorder):
    """Bind `recorder` as the context's active Recorder.  Contextvars
    do not propagate into threads started inside the block; pass the
    recorder explicitly to long-lived workers (the heartbeat monitor
    binds it at construction for exactly this reason)."""
    token = _ACTIVE.set(recorder)
    try:
        yield recorder
    finally:
        _ACTIVE.reset(token)


def maybe_span(name: str, **args):
    """A span on the active recorder, or a no-op when none is active —
    what library call sites use so uninstrumented runs pay nothing."""
    rec = _ACTIVE.get()
    if rec is None:
        return contextlib.nullcontext()
    return rec.span(name, **args)


class Counter:
    """Monotonic event counter (thread-safe via the recorder lock)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock) -> None:
        self.name = name
        self.value = 0
        self._lock = lock

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Streaming summary (count/sum/min/max) plus FIXED log-boundary
    buckets — enough to see a latency distribution, and to estimate its
    quantiles correctly, without retaining samples.

    Bucket i covers (2^((i-1)/GRID), 2^(i/GRID)]: four buckets per
    octave (~19% relative width), so a quantile read off the bucket
    boundaries carries at most ~±9% relative error — tight enough for
    p50/p99/p999 SLO reporting, wide enough that a serve process's
    histogram stays a few hundred ints across any latency range.
    Non-positive observations land in a dedicated zero bucket (they
    have no log position).  The boundaries are FIXED (value-independent)
    so histograms merge/export consistently across processes and the
    OpenMetrics exporter (telemetry/exporter.py) can emit cumulative
    `le` buckets without re-binning.

    This is the one quantile implementation in the package: consumers
    observe into a shared histogram and read `quantile()` /
    `summary()["p99"]` back."""

    GRID = 4                       # buckets per octave (2^(1/4) spacing)
    _IDX_MIN, _IDX_MAX = -480, 480  # clamp: 2^-120 .. 2^120

    __slots__ = ("name", "count", "total", "min", "max", "buckets",
                 "zero_count", "_lock")

    def __init__(self, name: str, lock) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        # bucket index -> count; index i covers (2^((i-1)/GRID), 2^(i/GRID)]
        self.buckets: dict[int, int] = {}
        self.zero_count = 0        # observations <= 0
        self._lock = lock

    @classmethod
    def bucket_bound(cls, i: int) -> float:
        """Upper boundary of bucket i (inclusive)."""
        return 2.0 ** (i / cls.GRID)

    @classmethod
    def _bucket_index(cls, v: float) -> int:
        i = math.ceil(cls.GRID * math.log2(v))
        # A value sitting exactly ON a boundary must land in the bucket
        # it bounds (le semantics); float log jitter can push it one up.
        if cls.bucket_bound(i - 1) >= v:
            i -= 1
        return max(cls._IDX_MIN, min(cls._IDX_MAX, i))

    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            # A single NaN folded into total would poison sum/mean for
            # the life of the process (and render an invalid OpenMetrics
            # `_sum`); +/-inf has no bucket.  Drop non-finite
            # observations entirely — count and the +Inf bucket stay
            # equal, the exposition stays parseable.
            return
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if v <= 0:
                self.zero_count += 1
                return
            i = self._bucket_index(v)
            self.buckets[i] = self.buckets.get(i, 0) + 1

    def _quantile_locked(self, q: float) -> "float | None":
        if self.count == 0:
            return None
        rank = q * self.count
        cum = self.zero_count
        if self.zero_count and rank <= cum:
            # All we know about the zero bucket is (min, 0]; report the
            # conservative edge.  (Guarded on a non-empty zero bucket:
            # q=0 on an all-positive histogram must clamp to the
            # observed min below, not fabricate a 0.)
            return min(self.min, 0.0)
        for i in sorted(self.buckets):
            n = self.buckets[i]
            if rank <= cum + n:
                # Log-linear interpolation inside (lo, hi]: the fixed
                # boundaries bound the error at half a bucket width.
                lo, hi = self.bucket_bound(i - 1), self.bucket_bound(i)
                frac = (rank - cum) / n
                est = lo * (hi / lo) ** frac
                # Never report outside the observed range.
                return min(max(est, self.min), self.max)
            cum += n
        return self.max

    def quantile(self, q: float) -> "float | None":
        """Quantile estimate from the fixed bucket boundaries (None when
        empty).  q in [0, 1]."""
        with self._lock:
            return self._quantile_locked(q)

    def summary(self) -> dict:
        with self._lock:
            mean = self.total / self.count if self.count else None
            return {
                "count": self.count,
                "sum": self.total,
                "min": self.min,
                "max": self.max,
                "mean": mean,
                "p50": self._quantile_locked(0.50),
                "p99": self._quantile_locked(0.99),
                "p999": self._quantile_locked(0.999),
            }

    def openmetrics_buckets(self) -> "list[tuple[float, int]]":
        """Cumulative (le_boundary, count) pairs over the non-empty
        bucket range, ending with (inf, count) — what the OpenMetrics
        exporter renders as `_bucket{le=...}` lines."""
        with self._lock:
            out: list[tuple[float, int]] = []
            cum = 0
            if self.zero_count:
                cum += self.zero_count
                out.append((0.0, cum))
            for i in sorted(self.buckets):
                cum += self.buckets[i]
                out.append((self.bucket_bound(i), cum))
            out.append((math.inf, self.count))
            return out

    def openmetrics_snapshot(self) -> "tuple[dict, list[tuple[float, int]]]":
        """(summary, cumulative buckets) read under ONE lock
        acquisition, so `_count` and the `+Inf` bucket cannot disagree
        when an observe lands mid-scrape — the OpenMetrics invariant the
        exporter's exposition must hold."""
        with self._lock:          # RLock: the nested reads re-enter
            return self.summary(), self.openmetrics_buckets()


class _Span:
    """One in-flight span; created by Recorder.span()."""

    __slots__ = ("_rec", "name", "args", "start_ns", "depth", "tid")

    def __init__(self, rec, name: str, args: dict) -> None:
        self._rec = rec
        self.name = name
        self.args = args
        self.start_ns = 0
        self.depth = 0
        self.tid = 0

    def __enter__(self):
        self.tid = threading.get_ident()
        self.depth = self._rec._enter_depth()
        self.start_ns = now_ns()
        return self

    def annotate(self, **kw) -> None:
        """Attach more args mid-span (e.g. a result count discovered
        after the work)."""
        self.args.update(kw)

    def __exit__(self, exc_type, exc, tb):
        dur = now_ns() - self.start_ns
        self._rec._exit_depth()
        if exc_type is not None:
            self.args.setdefault("error", repr(exc)[:200])
        self._rec._finish(self, dur)
        return False


class Recorder:
    """The shared registry: spans + counters + histograms, one lock.

    `max_events` bounds span retention (a serve process would otherwise
    grow without bound — the durable history is the journal); counters
    and histograms are aggregates and never grow with run length."""

    def __init__(self, journal=None, max_events: int = 65536,
                 journal_spans: bool = True) -> None:
        self._lock = threading.RLock()
        self.events: deque = deque(maxlen=max_events)
        self.counters: dict[str, Counter] = {}
        self.histograms: dict[str, Histogram] = {}
        self.gauges: dict[str, float] = {}
        self._journal = journal
        self._journal_spans = journal_spans and journal is not None
        self._tls = threading.local()
        self._t0_ns = now_ns()

    # -- spans -----------------------------------------------------------
    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _enter_depth(self) -> int:
        d = getattr(self._tls, "depth", 0)
        self._tls.depth = d + 1
        return d

    def _exit_depth(self) -> None:
        self._tls.depth = max(0, getattr(self._tls, "depth", 1) - 1)

    def _finish(self, span: _Span, dur_ns: int) -> None:
        ev = {
            "name": span.name,
            "start_ns": span.start_ns,
            "dur_ns": dur_ns,
            "tid": span.tid,
            "depth": span.depth,
            "args": span.args,
        }
        with self._lock:
            self.events.append(ev)
        self.histogram(f"span.{span.name}_s").observe(dur_ns / 1e9)
        if self._journal_spans:
            self._journal.append({
                "kind": "span",
                "name": span.name,
                "mono_ns": span.start_ns,
                "dur_ns": dur_ns,
                "tid": span.tid,
                "depth": span.depth,
                "args": span.args,
            })

    # -- counters / histograms ------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self.counters.get(name)
            if c is None:
                c = self.counters[name] = Counter(name, self._lock)
            return c

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(name, self._lock)
            return h

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge (last write wins) — what the
        roofline layer publishes utilization through and the OpenMetrics
        exporter renders as `gauge` metrics."""
        with self._lock:
            self.gauges[name] = float(value)

    def journal_record(self, record: dict, sync: bool = False) -> None:
        """Append an arbitrary record to the bound journal (no-op when
        none is bound) — the hook telemetry layers (roofline) use to
        land their own record kinds next to spans."""
        if self._journal is not None:
            self._journal.append(record, sync=sync)

    def snapshot(self) -> dict:
        """JSON-safe aggregate view (counters + histogram summaries +
        gauges)."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self.counters.items()},
                "histograms": {
                    n: h.summary() for n, h in self.histograms.items()
                },
                "gauges": dict(self.gauges),
            }

    # -- Chrome trace-event export --------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the object form: {"traceEvents":
        [...]}) — complete ("X") events in microseconds relative to the
        recorder's epoch, loadable in Perfetto / chrome://tracing."""
        with self._lock:
            events = list(self.events)
            counters = {n: c.value for n, c in self.counters.items()}
        pid = os.getpid()
        t0 = min((e["start_ns"] for e in events), default=self._t0_ns)
        trace = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "oni_ml_tpu_torch"},
        }]
        end_us = 0.0
        for e in events:
            ts = (e["start_ns"] - t0) / 1e3
            dur = e["dur_ns"] / 1e3
            end_us = max(end_us, ts + dur)
            trace.append({
                "name": e["name"], "ph": "X", "cat": "span",
                "ts": ts, "dur": dur, "pid": pid, "tid": e["tid"],
                "args": e["args"],
            })
        for name, value in counters.items():
            trace.append({
                "name": name, "ph": "C", "ts": end_us, "pid": pid,
                "tid": 0, "args": {"value": value},
            })
        return {"traceEvents": trace, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
