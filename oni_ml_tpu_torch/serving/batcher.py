"""BatchScorer: micro-batch accumulation and exactly-once scoring (port
of oni_ml_tpu/serving/batcher.py).

Arriving events enqueue with a per-event future; one worker thread
flushes the queue into featurize + score calls whenever either trigger
fires:

    max_batch    the queue holds a full batch (throughput trigger), or
    max_wait_ms  the oldest queued event has waited that long (latency
                 trigger).

Both resolve through the plan cache (knobs `serve_max_batch` and
`serve_max_wait_ms`, host-scoped): a ServingConfig value that differs
from the default wins, else this host's plan entry, else the default; a
plan max_batch above queue_max falls back to the default.  Each flush
takes ONE registry snapshot, so a hot-swap that
lands mid-flush is invisible to that flush and the next one scores on
the new model.

Exactly-once: events are validated at submit (a malformed event raises
to the caller and never enters the queue: the featurizers drop
malformed rows, which would desync scores from futures), each dequeued
event's future resolves once, and close() drains the queue before the
worker stops.  Backpressure: submit() blocks once queue_max events are
pending.  A flush that raises (a featurizer bug, a device failure) fails
its futures with the cause; an `on_batch` consumer that raises is
recorded (`on_batch_error`) and the worker serves on.

Each flush scores on the host or on `device` by the shared rule
(scoring.use_device_path), and emits one metrics record
(serving/metrics.py).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque

import numpy as np

from ..config import ServingConfig
from ..scoring import use_device_path
from .events import score_features
from .metrics import MetricsEmitter
from .registry import ModelRegistry


class ScoreFuture:
    """One event's result handle: result() blocks until its flush scored
    it (or failed it)."""

    __slots__ = ("_event", "_score", "_version", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._score = None
        self._version = None
        self._error = None

    def _resolve(self, score: float, version: int) -> None:
        if self._event.is_set():
            return  # exactly-once: the first resolution wins
        self._score = score
        self._version = version
        self._event.set()

    def _fail(self, error: Exception) -> None:
        if self._event.is_set():
            return  # a delivered score never turns into an error
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: "float | None" = None) -> "tuple[float, int]":
        """(score, model_version); raises the flush's error if it failed,
        TimeoutError if not resolved in time."""
        if not self._event.wait(timeout):
            raise TimeoutError("event not scored within timeout")
        if self._error is not None:
            raise self._error
        return self._score, self._version


class _Pending:
    __slots__ = ("raw", "t_enqueue", "future")

    def __init__(self, raw, t_enqueue: float) -> None:
        self.raw = raw
        self.t_enqueue = t_enqueue
        self.future = ScoreFuture()


class BatchScorer:
    """Micro-batching scoring front end over a ModelRegistry.

    `featurizer` is a serving featurizer (serving/events.py): it
    validates single events, turns a list of them into a feature
    container and names its dsource.  `on_batch(snapshot, feats,
    scores)` runs on the worker after each flush (the flagged-event
    output and the refresh loop hang off it).  `device` is where a flush
    that takes the device path scores (None: the card)."""

    def __init__(self, registry: ModelRegistry, featurizer,
                 config: "ServingConfig | None" = None,
                 metrics: "MetricsEmitter | None" = None,
                 on_batch=None, device=None) -> None:
        from ..device import resolve_device
        from ..plans import NullStore, current_store
        from ..telemetry.spans import current_recorder

        self.registry = registry
        self.featurizer = featurizer
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        # The flush triggers resolve through the plan layer (host-scoped
        # knobs: no CUDA for a host-pinned scorer): a config value that
        # differs from the default wins, else this host's plan entry,
        # else the default.  `self.plan` names each source for serve's
        # records.
        from ..plans import resolve

        mb, mb_src = resolve("serve_max_batch", self.config.max_batch)
        mw, mw_src = resolve("serve_max_wait_ms", self.config.max_wait_ms)
        if mb_src == "plan" and int(mb) > self.config.queue_max:
            # A plan flush size above the backpressure bound would make
            # the max_batch trigger unreachable (submit blocks at
            # queue_max first) and every flush the timer's: fall back to
            # the default.
            mb, mb_src = self.config.max_batch, "default"
        self.max_batch = int(mb)
        self.max_wait_ms = float(mw)
        self.plan = {
            "max_batch": {"value": self.max_batch, "source": mb_src},
            "max_wait_ms": {"value": self.max_wait_ms, "source": mw_src},
        }
        if self.max_batch < 1 or self.config.queue_max < 1:
            # max_batch 0 would make the first flush empty, which the
            # worker reads as shutdown; queue_max 0 deadlocks the first
            # submit.
            raise ValueError(
                f"max_batch ({self.max_batch}) and queue_max "
                f"({self.config.queue_max}) must both be >= 1")
        if self.max_wait_ms <= 0:
            raise ValueError(f"max_wait_ms must be > 0, got {self.max_wait_ms}")
        self.metrics = metrics
        self.on_batch = on_batch
        if self.config.device_score_min in (0, "auto"):
            # The calibration's measurement (or plan read) runs here, not
            # inside the first flush, whose latency max_wait_ms bounds.
            from ..scoring import dispatch_calibration

            dispatch_calibration(device=self.device)
        self._pending: "deque[_Pending]" = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._force_flush = False
        self._batch_seq = 0
        self._events_scored = 0
        # Context variables do not cross a thread start: the plan store
        # the caller reads (a NullStore where plans are off, so
        # --no-plans binds the worker too) and the active telemetry
        # Recorder are handed to the worker explicitly.
        self._plan_store = current_store() or NullStore()
        self._recorder = current_recorder()
        self._worker = threading.Thread(target=self._run,
                                        name="oni-batch-scorer", daemon=True)
        self._worker.start()

    # -- producer side ------------------------------------------------------

    def submit(self, raw) -> ScoreFuture:
        """Enqueue one raw event; raises ValueError at once on a
        malformed event (never enqueued), RuntimeError after close().
        Blocks while queue_max events are pending."""
        validated = self.featurizer.validate(raw)
        with self._cond:
            while not self._closed and \
                    len(self._pending) >= self.config.queue_max:
                self._cond.wait()
            if self._closed:
                raise RuntimeError("BatchScorer is closed")
            p = _Pending(validated, time.perf_counter())
            self._pending.append(p)
            self._cond.notify_all()
            return p.future

    def submit_many(self, raws) -> "list[ScoreFuture]":
        return [self.submit(r) for r in raws]

    def flush(self) -> None:
        """Flush what is queued without waiting for a trigger; a no-op on
        an empty queue (an armed flag would flush the NEXT event alone)."""
        with self._cond:
            if self._pending:
                self._force_flush = True
                self._cond.notify_all()

    def close(self, timeout: "float | None" = None) -> bool:
        """Drain the queue, then stop the worker.  With timeout None this
        blocks until every event submitted before close() is scored.  A
        drain that outlives a finite timeout fails the still-queued
        futures and returns False."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout)
        if not self._worker.is_alive():
            return True
        with self._cond:
            undrained = list(self._pending)
            self._pending.clear()
        err = RuntimeError(
            f"BatchScorer.close timed out after {timeout}s with "
            f"{len(undrained)} events undrained")
        for p in undrained:
            p.future._fail(err)
        return False

    @property
    def events_scored(self) -> int:
        with self._cond:
            return self._events_scored

    @property
    def batches_flushed(self) -> int:
        with self._cond:
            return self._batch_seq

    # -- worker side --------------------------------------------------------

    def _take_batch(self) -> "tuple[list[_Pending], str, int]":
        """Block until a trigger fires -> (batch, trigger, queue depth
        after).  An empty batch means shutdown."""
        max_wait_s = self.max_wait_ms / 1e3
        with self._cond:
            while not self._pending and not self._closed:
                self._cond.wait()
            if not self._pending:
                return [], "shutdown", 0
            trigger = "close" if self._closed else None
            while trigger is None:
                if self._force_flush:
                    trigger = "flush"
                    break
                if len(self._pending) >= self.max_batch:
                    trigger = "max_batch"
                    break
                waited = time.perf_counter() - self._pending[0].t_enqueue
                if waited >= max_wait_s:
                    trigger = "max_wait"
                    break
                self._cond.wait(max_wait_s - waited)
                if self._closed:
                    trigger = "close"
            self._force_flush = False
            batch = [self._pending.popleft()
                     for _ in range(min(len(self._pending), self.max_batch))]
            self._cond.notify_all()  # release submitters blocked on queue_max
            return batch, trigger, len(self._pending)

    def _run(self) -> None:
        from ..plans import use_store
        from ..telemetry.spans import use_recorder

        with use_store(self._plan_store), (
                use_recorder(self._recorder) if self._recorder is not None
                else contextlib.nullcontext()):
            while True:
                batch, trigger, depth = self._take_batch()
                if not batch:
                    return
                try:
                    self._score_batch(batch, trigger, depth)
                except Exception as e:
                    # The worker survives anything a flush throws (a
                    # dead worker would hang every later submit):
                    # resolved futures keep their scores, the rest fail
                    # with the cause.
                    for p in batch:
                        p.future._fail(e)

    def _score_batch(self, batch: "list[_Pending]", trigger: str,
                     depth: int) -> None:
        cfg = self.config
        t0 = time.perf_counter()
        try:
            snap = self.registry.active()
            feats = self.featurizer([p.raw for p in batch])
            if feats.num_raw_events != len(batch):
                # submit()'s validation makes this unreachable; a
                # featurizer that drops a validated row must fail the
                # flush, not score the wrong rows.
                raise RuntimeError(
                    f"featurizer returned {feats.num_raw_events} rows "
                    f"for {len(batch)} events")
            scores = score_features(snap.model, feats,
                                    self.featurizer.dsource,
                                    device_min=cfg.device_score_min,
                                    device=self.device)
        except Exception as e:
            for p in batch:
                p.future._fail(e)
            with self._cond:
                seq = self._batch_seq
                self._batch_seq += 1
            self._emit_safe({"stage": "serve", "batch": seq,
                             "events": len(batch), "error": repr(e),
                             "trigger": trigger})
            return
        t1 = time.perf_counter()
        for p, s in zip(batch, scores):
            p.future._resolve(float(s), snap.version)
        t2 = time.perf_counter()   # every future delivered
        with self._cond:
            self._events_scored += len(batch)
            seq = self._batch_seq
            self._batch_seq += 1
        # The consumers run before the metrics emit (a metrics failure
        # must not cost the flush its output or its refresh evidence),
        # and each is isolated: neither can kill the worker.
        if self.on_batch is not None:
            try:
                self.on_batch(snap, feats, scores)
            except Exception as e:
                self._emit_safe({"stage": "serve", "batch": seq,
                                 "on_batch_error": repr(e)})
        n = len(batch)
        score_s = t1 - t0
        self._emit_safe({
            "stage": "serve",
            "batch": seq,
            "events": n,
            "trigger": trigger,
            "model_version": snap.version,
            # The predicate score_features dispatched on, so the label
            # cannot drift from the path taken.
            "scorer": ("device" if use_device_path(
                n, cfg.device_score_min, self.device) else "host"),
            # The oldest event's latency, enqueue -> scored, and its
            # parts: queue wait (enqueue -> flush start), score
            # (featurize + host or device scoring), demux (scores ->
            # every future delivered).
            "latency_ms": round((t1 - batch[0].t_enqueue) * 1e3, 3),
            "queue_wait_ms": round((t0 - batch[0].t_enqueue) * 1e3, 3),
            "score_ms": round(score_s * 1e3, 3),
            "demux_ms": round((t2 - t1) * 1e3, 3),
            "events_per_sec": round(n / score_s, 1) if score_s else None,
            "queue_depth": depth,
            "flagged": int(np.sum(scores < cfg.threshold)),
        })

    def _emit_safe(self, record: dict) -> None:
        """A metrics emit that cannot take anything down with it."""
        if self.metrics is None:
            return
        try:
            self.metrics.emit(record)
        except Exception as e:
            print(f"serving metrics emit failed: {e!r}", file=sys.stderr)
