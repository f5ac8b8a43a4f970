"""Background checkpoint sinks and overlap tasks (port of
oni_ml_tpu/dataplane/sinks.py).

The dataplane demotes the pipeline's inter-stage files to *optional
checkpoints*: the live hand-off travels in memory, and the file — still
the resume/audit contract when enabled — is written by a background
sink whose wall overlaps downstream compute.

Two primitives:

* `CheckpointSinks` — a small thread pool of named writers.  Every
  write is atomic (tmp + os.replace, so a contract filename only ever
  names a COMPLETE file), spanned (`dataplane.checkpoint.<name>`),
  journaled (`{"kind": "dataplane", "event": "task"}`), and joined —
  with errors re-surfaced — before `run_pipeline` returns.

* `Task` — one named overlap computation on its own thread (the
  scoring-prep-during-EM and wc-stream producers), with the same
  span/journal treatment and a `result()` join that re-raises.

Threads are plumbed their telemetry explicitly (contextvars do not
propagate into threads started inside a `use_recorder` block).  The
work on these threads is host work on numpy arrays and files: it never
touches a tensor, so it needs no CUDA stream of its own.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

# Concurrent background checkpoint writers.
SINK_WORKERS = 2


class _Completion:
    """Shared bookkeeping for a finished sink/task (name, stage
    attribution, wall, outcome) — the rows of the run's dataplane
    record.  `stall_s` is the portion of the wall spent blocked on
    channel backpressure (a producer task waiting in put()): idle
    time, not work — the plane's `background_wall_s` subtracts it so a
    backpressured producer cannot count its consumer's inline wall as
    hidden background work."""

    __slots__ = ("name", "stage", "wall_s", "stall_s", "ok", "error")

    def __init__(self, name, stage):
        self.name = name
        self.stage = stage
        self.wall_s = 0.0
        self.stall_s = 0.0
        self.ok = False
        self.error: "BaseException | None" = None

    def row(self) -> dict:
        out = {"stage": self.stage, "wall_s": round(self.wall_s, 3),
               "ok": self.ok}
        if self.stall_s:
            out["stall_s"] = round(self.stall_s, 3)
        if self.error is not None:
            out["error"] = repr(self.error)[:200]
        return out


def _run_instrumented(kind: str, comp: _Completion, fn, recorder,
                      journal, stall_fn=None):
    """Execute fn under the dataplane's telemetry contract; stores the
    outcome on `comp` and returns fn's value (or raises).  `stall_fn`
    (called after fn finishes) reports the seconds fn spent blocked on
    channel backpressure, recorded as comp.stall_s."""
    from ..telemetry.spans import use_recorder

    span_name = f"dataplane.{kind}.{comp.name}"
    t0 = time.perf_counter()
    try:
        if recorder is not None:
            with use_recorder(recorder), \
                    recorder.span(span_name, stage=comp.stage):
                out = fn()
        else:
            out = fn()
        comp.ok = True
        return out
    except BaseException as e:
        comp.error = e
        raise
    finally:
        comp.wall_s = time.perf_counter() - t0
        if stall_fn is not None:
            try:
                comp.stall_s = float(stall_fn())
            except Exception:
                comp.stall_s = 0.0
        if journal is not None:
            rec = {
                "kind": "dataplane", "event": "task",
                "name": comp.name, "stage": comp.stage,
                "wall_s": round(comp.wall_s, 3), "ok": comp.ok,
            }
            if comp.stall_s:
                rec["stall_s"] = round(comp.stall_s, 3)
            journal.append(rec)


class Task:
    """One overlap computation on a dedicated thread.  `result()`
    joins and re-raises; `consumed` marks an error as surfaced so the
    plane's drain does not double-report it."""

    def __init__(self, name: str, fn, stage: "str | None" = None,
                 recorder=None, journal=None, stall_fn=None) -> None:
        self.completion = _Completion(name, stage)
        self._value = None
        self._done = threading.Event()
        self.consumed = False

        def _run():
            try:
                self._value = _run_instrumented(
                    "task", self.completion, fn, recorder, journal,
                    stall_fn=stall_fn,
                )
            except BaseException:
                pass           # kept on completion.error; raised at join
            finally:
                self._done.set()

        self._thread = threading.Thread(
            target=_run, name=f"dataplane-{name}", daemon=True
        )
        self._thread.start()

    def result(self):
        self._done.wait()
        self._thread.join()
        self.consumed = True
        if self.completion.error is not None:
            raise self.completion.error
        return self._value

    def join_quiet(self) -> None:
        self._done.wait()
        self._thread.join()


class CheckpointSinks:
    """Named background writers on a bounded pool.  Submission order is
    preserved per worker; `drain()` joins everything and returns the
    completion rows plus any unsurfaced errors (the caller decides how
    loudly to fail — run_pipeline fails the run)."""

    def __init__(self, workers: int, recorder=None, journal=None) -> None:
        self._ex = ThreadPoolExecutor(
            max_workers=max(1, int(workers)),
            thread_name_prefix="dataplane-sink",
        )
        self._lock = threading.Lock()
        self._pending: list = []       # (completion, future)
        self._recorder = recorder
        self._journal = journal

    def submit(self, name: str, fn, stage: "str | None" = None):
        comp = _Completion(name, stage)
        fut = self._ex.submit(
            _run_instrumented, "checkpoint", comp, fn,
            self._recorder, self._journal,
        )
        with self._lock:
            self._pending.append((comp, fut))
        return fut

    def drain(self) -> "tuple[dict, list]":
        """Join every submitted write; returns ({name: row}, errors).
        Never raises — a failing checkpoint must not mask the run's own
        exception path; run_pipeline re-raises after its finally."""
        with self._lock:
            pending = list(self._pending)
            self._pending = []
        rows: dict = {}
        errors: list = []
        for comp, fut in pending:
            try:
                fut.result()
            except BaseException:
                errors.append(
                    (comp.name, comp.error if comp.error is not None
                     else RuntimeError(f"checkpoint {comp.name} failed"))
                )
            rows[comp.name] = comp.row()
        return rows, errors

    def close(self) -> None:
        self._ex.shutdown(wait=True)
