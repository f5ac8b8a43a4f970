"""Per-run dataplane orchestrator (port of
oni_ml_tpu/dataplane/plane.py).

One `Dataplane` instance lives for one `run_pipeline` invocation and
owns every asynchronous moving part the streaming pipeline creates:

* **checkpoint sinks** — the demoted file artifacts (features.pkl,
  word_counts.dat, the LDA-C corpus triplet, final.*, the results
  CSVs), written in the background while downstream stages compute.
  `checkpoints=False` (--no-checkpoints) turns them into no-ops:
  the run produces only its product artifacts, and a later resume is
  *refused* against the missing file contract rather than silently
  degraded.
* **overlap tasks** — named computations on dedicated threads (the
  wc-stream producer, scoring prep during EM).
* **channels** — bounded inter-stage edges with priced stalls.

`drain()` joins everything (it runs inside run_pipeline's `finally`),
journals per-edge
summaries, and returns the run's dataplane record — per-task walls
with stage attribution plus per-edge stall accounting — without
raising; the caller surfaces collected errors after its finally block
so a background-write failure fails the run without masking the run's
own exception.
"""

from __future__ import annotations

import time

from .channel import CHANNEL_CAPACITY, Channel
from .sinks import SINK_WORKERS, CheckpointSinks, Task


class Dataplane:
    def __init__(self, config, recorder=None, journal=None) -> None:
        self.config = config
        self.checkpoints = bool(config.checkpoints)
        self._recorder = recorder
        self._journal = journal
        self._sinks = CheckpointSinks(
            SINK_WORKERS, recorder=recorder, journal=journal
        )
        self._tasks: list = []
        self._channels: list = []
        self._drained: "dict | None" = None
        self._errors: list = []

    # -- primitives ------------------------------------------------------

    def checkpoint(self, name: str, fn, stage: "str | None" = None):
        """Submit a demoted file artifact write; no-op (returns None)
        when checkpoints are disabled."""
        if not self.checkpoints:
            return None
        return self._sinks.submit(name, fn, stage=stage)

    def output(self, name: str, fn, stage: "str | None" = None):
        """Submit a PRODUCT artifact write (the results CSV): always
        written, checkpoints on or off — demotion makes the write
        asynchronous, never optional."""
        return self._sinks.submit(name, fn, stage=stage)

    def spawn(self, name: str, fn, stage: "str | None" = None,
              stall=None) -> Task:
        """Run fn on a dedicated overlap thread.  `stall` (optional
        zero-arg callable, read after fn finishes) reports the seconds
        fn spent blocked on channel backpressure — idle wait excluded
        from the task's work accounting."""
        task = Task(name, fn, stage=stage, recorder=self._recorder,
                    journal=self._journal, stall_fn=stall)
        self._tasks.append(task)
        return task

    def channel(self, edge: str) -> Channel:
        ch = Channel(edge, CHANNEL_CAPACITY,
                     recorder=self._recorder, journal=self._journal)
        self._channels.append(ch)
        return ch

    # -- lifecycle -------------------------------------------------------

    def drain(self) -> dict:
        """Join every task and sink; never raises.  Errors accumulate
        on `.errors` (tasks whose failure was already consumed via
        `result()` are not double-counted)."""
        if self._drained is not None:
            return self._drained
        t0 = time.perf_counter()
        tasks: dict = {}
        for task in self._tasks:
            task.join_quiet()
            comp = task.completion
            tasks[comp.name] = comp.row()
            if comp.error is not None and not task.consumed:
                self._errors.append((comp.name, comp.error))
        sink_rows, sink_errors = self._sinks.drain()
        self._sinks.close()
        tasks.update(sink_rows)
        self._errors.extend(sink_errors)
        edges = {}
        for ch in self._channels:
            st = ch.stats()
            edges[st.pop("edge")] = st
            if self._journal is not None:
                self._journal.append({
                    "kind": "dataplane", "event": "edge", "edge": ch.edge,
                    "capacity": st["capacity"], "puts": st["puts"],
                    "gets": st["gets"],
                    "put_stall_s": st["put_stall_s"],
                    "get_stall_s": st["get_stall_s"],
                    "max_depth": st["max_depth"],
                })
        background = sum(
            row["wall_s"] - row.get("stall_s", 0.0)
            for row in tasks.values() if row.get("ok")
        )
        self._drained = {
            "checkpoints": self.checkpoints,
            "tasks": tasks,
            "edges": edges,
            "background_wall_s": round(background, 3),
            "join_wall_s": round(time.perf_counter() - t0, 3),
        }
        return self._drained

    @property
    def errors(self) -> list:
        return self._errors
