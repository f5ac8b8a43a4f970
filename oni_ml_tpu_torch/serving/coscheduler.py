"""Cooperative two-priority device scheduler: refresh fits against
scoring (port of oni_ml_tpu/serving/coscheduler.py).

The continuous service (`ml_ops continuous --stream ...`) runs its
window refresh fits on a worker thread of the same process, and on the
same card, that its scorer dispatches from.  Without arbitration a
refresh fit blocks scoring for its whole wall.  Here the refresh fit is
the low-priority stage, micro-batch scoring the high-priority one, and
the EM driver's dispatch boundary is the yield point:

* a refresh fit enqueues one chunk (fused driver) or one EM iteration
  (stepwise driver) at a time under `train_chunk()`;
* a scoring flush runs under `serve_slot()` and always wins the next
  dispatch slot: the trainer's chunk entry waits while any serve slot is
  pending or running;
* serve slots never wait on each other, only on an in-flight chunk, so
  their worst-case wait is one chunk's enqueue; and they wait at all
  only when scoring shares the trainer's stream (the in-process scorer,
  `serve_slot(wait=True)`); `wait=False` registers the same pressure
  without blocking.

The scheduler is cooperative and host-side: it orders dispatch enqueue,
which on one CUDA stream orders execution on the card.  Both waits are
priced as recorder histograms (`cosched.yield_wait_s` for the trainer
giving way, `cosched.preempt_wait_s` for a flush waiting out a chunk)
plus a `{"kind": "cosched"}` journal record per contended wait; an
uncontended entry costs two lock acquisitions and writes nothing.
`CoScheduler(enabled=False)` is the uncoordinated control (`--no-cosched`):
the same counters and refresh-active tagging, no waits.

One departure from the JAX package: a tenant's first fit (no model
published yet: `train_fit(first_publish=True)`) stops yielding once its
summed yield wait reaches `starvation_s`.
The per-wait cap alone bounds each wait but not their sum, so under a
scoring plane that never drains a first fit could yield for a whole
stream and its tenant never be served.  Later fits keep the per-wait
cap only.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class CoScheduler:
    """Two-priority cooperative dispatch token (train yields to serve).

    `starvation_s` bounds trainer livelock under a saturated serve
    plane: a chunk entry that has waited longer than this proceeds
    anyway (journaled with `capped: true`).  Scoring still wins every
    slot the trainer is not actively holding.  It also bounds the summed
    yield wait of a first fit (`train_fit(first_publish=True)`); past it
    the fit's chunks enter without waiting.

    `enabled=False` is the observe-only mode of the uncoordinated
    control: every bracket still counts chunks and slots and
    `refresh_active` still flips (so the serve-latency split is measured
    the same way), but nothing ever waits: train and serve dispatch
    head to head.
    """

    def __init__(self, *, recorder=None, journal=None,
                 starvation_s: float = 5.0, enabled: bool = True) -> None:
        self._cond = threading.Condition()
        self._train_active = False   # a chunk holds the dispatch slot
        self._serve_waiting = 0      # flushes blocked on the slot
        self._serve_busy = 0         # flushes currently dispatching
        self._fit_active = 0         # refresh fits in flight (0 or 1)
        self._journal = getattr(journal, "journal", journal)
        self._recorder = recorder
        self.enabled = bool(enabled)
        self.starvation_s = float(starvation_s)
        self.train_chunks = 0
        self.serve_slots = 0
        self.yields = 0              # contended chunk entries
        self.preempts = 0            # contended serve entries
        self.yield_wait_s = 0.0
        self.preempt_wait_s = 0.0
        self._fit_yields = 0         # per-fit running tallies
        self._fit_yield_wait_s = 0.0
        self._fit_chunks = 0
        self._fit_capped = 0
        self._fit_first = False      # the fit in flight is a first fit
        self._fit_bound_chunk = None  # its chunk where the bound acted

    # -- introspection ----------------------------------------------------

    @property
    def refresh_active(self) -> bool:
        """True while any refresh fit is between train_fit() entry and
        exit: the tag the serve-latency split (p99 during refresh against
        idle) keys on.  Read without the lock: a boolean flip, and the
        consumers only bucket latency samples."""
        return self._fit_active > 0

    def _journal_safe(self, record: dict) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(record)
        except Exception:
            pass     # telemetry must never take down the service

    # -- train side -------------------------------------------------------

    @contextmanager
    def train_fit(self, tenant: str = "", first_publish: bool = False):
        """Brackets one whole refresh fit.  Flips `refresh_active` and
        aggregates the fit's chunk/yield tallies into one journal
        record at exit (the per-wait records stay individually
        journaled; this is the fit-level rollup).  `first_publish`: the
        tenant has no published model yet, so the fit's summed yield
        wait is bounded by `starvation_s`; its record then adds
        `first_publish` and `first_fit_bound_chunk`, the fit's chunk at
        which the bound stopped the yielding (None: it never acted)."""
        t0 = time.perf_counter()
        with self._cond:
            self._fit_active += 1
            self._fit_yields = 0
            self._fit_yield_wait_s = 0.0
            self._fit_chunks = 0
            self._fit_capped = 0
            self._fit_first = bool(first_publish)
            self._fit_bound_chunk = None
        try:
            yield self
        finally:
            wall = time.perf_counter() - t0
            with self._cond:
                self._fit_active -= 1
                chunks = self._fit_chunks
                yields = self._fit_yields
                ywait = self._fit_yield_wait_s
                capped = self._fit_capped
                bound_chunk = self._fit_bound_chunk
                self._fit_first = False
                self._cond.notify_all()
            record = {
                "kind": "cosched", "event": "fit", "tenant": tenant,
                "wall_s": round(wall, 6), "chunks": chunks,
                "yields": yields, "yield_wait_s": round(ywait, 6),
                "capped": capped,
            }
            if first_publish:
                record.update(first_publish=True,
                              first_fit_bound_chunk=bound_chunk)
            self._journal_safe(record)

    @contextmanager
    def train_chunk(self):
        """One preemptible chunk dispatch.  Entry is the yield point:
        wait while any scoring flush is pending or running (bounded by
        `starvation_s`, and in a first fit by what is left of the fit's
        `starvation_s` of summed waits), then hold the slot for the
        dispatch."""
        t0 = time.perf_counter()
        deadline = t0 + self.starvation_s
        capped = False
        with self._cond:
            contended = self.enabled and (
                self._serve_waiting > 0 or self._serve_busy > 0)
            if contended and self._fit_first:
                left = self.starvation_s - self._fit_yield_wait_s
                if left <= 0:
                    # The bound has acted: this first fit yields no more.
                    contended = False
                    if self._fit_bound_chunk is None:
                        self._fit_bound_chunk = self._fit_chunks + 1
                elif left < self.starvation_s:
                    deadline = t0 + left
            while contended and (
                    self._serve_waiting > 0 or self._serve_busy > 0):
                remain = deadline - time.perf_counter()
                if remain <= 0:
                    capped = True
                    break
                self._cond.wait(timeout=remain)
            self._train_active = self.enabled
            self.train_chunks += 1
            self._fit_chunks += 1
            wait = time.perf_counter() - t0
            if contended:
                self.yields += 1
                self.yield_wait_s += wait
                self._fit_yields += 1
                self._fit_yield_wait_s += wait
                self._fit_capped += capped
                if (self._fit_first and self._fit_bound_chunk is None
                        and self._fit_yield_wait_s
                        >= self.starvation_s):
                    self._fit_bound_chunk = self._fit_chunks
        if contended:
            if self._recorder is not None:
                self._recorder.histogram(
                    "cosched.yield_wait_s").observe(wait)
            self._journal_safe({
                "kind": "cosched", "event": "yield",
                "wait_ms": round(wait * 1e3, 3), "capped": capped,
            })
        try:
            yield
        finally:
            with self._cond:
                self._train_active = False
                self._cond.notify_all()

    # -- serve side -------------------------------------------------------

    @contextmanager
    def serve_slot(self, *, wait: bool = True):
        """One scoring dispatch (submit burst + flush).  With
        `wait=True` (the in-process scorer: train and serve share one
        stream) it waits out at most the chunk currently being enqueued,
        registering as waiting first, so the trainer's next chunk entry
        sees the pressure and gives way.  With `wait=False` (remote
        scoring, no shared stream) it registers the same pressure
        without blocking: the flush dispatches at once and the trainer
        still defers its next chunk until the slot drains."""
        t0 = time.perf_counter()
        with self._cond:
            self._serve_waiting += 1
            contended = self.enabled and wait and self._train_active
            while contended and self._train_active:
                self._cond.wait()
            self._serve_waiting -= 1
            self._serve_busy += 1
            self.serve_slots += 1
            wait = time.perf_counter() - t0
            if contended:
                self.preempts += 1
                self.preempt_wait_s += wait
        if contended:
            if self._recorder is not None:
                self._recorder.histogram(
                    "cosched.preempt_wait_s").observe(wait)
            self._journal_safe({
                "kind": "cosched", "event": "preempt",
                "wait_ms": round(wait * 1e3, 3),
            })
        try:
            yield
        finally:
            with self._cond:
                self._serve_busy -= 1
                if not self._serve_busy and not self._serve_waiting:
                    self._cond.notify_all()

    # -- the trainer-facing hook ------------------------------------------

    @property
    def yield_hook(self):
        """The context-manager factory `LDATrainer`/`WindowTrainer`
        accept as `yield_hook=`: each EM chunk (fused driver) or EM
        iteration (stepwise driver) is enqueued inside one
        `train_chunk()` slot."""
        return self.train_chunk

    def summary(self) -> dict:
        with self._cond:
            def _q(name, q):
                if self._recorder is None:
                    return None
                v = self._recorder.histogram(name).quantile(q)
                return round(v, 6) if v is not None else None

            return {
                "enabled": self.enabled,
                "train_chunks": self.train_chunks,
                "serve_slots": self.serve_slots,
                "yields": self.yields,
                "preempts": self.preempts,
                "yield_wait_s": round(self.yield_wait_s, 6),
                "preempt_wait_s": round(self.preempt_wait_s, 6),
                "yield_wait_p99_s": _q("cosched.yield_wait_s", 0.99),
                "preempt_wait_p99_s": _q("cosched.preempt_wait_s", 0.99),
            }
