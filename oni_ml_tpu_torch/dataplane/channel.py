"""Bounded hand-off channel between overlapped pipeline stages (port of
oni_ml_tpu/dataplane/channel.py).

A `Channel` is the dataplane's one inter-stage transport: a bounded
deque guarded by a condition variable, with close/failure semantics a
streaming producer/consumer pair needs (a producer error surfaces at
the consumer's next `get`, and vice versa), and *priced* waits — every
blocking put/get is measured, journaled as a `{"kind": "dataplane"}`
record, observed into the shared histogram registry, and (when a
recorder is active) wrapped in a `dataplane.stall` span so a starved
consumer or a backpressured producer is visible in the trace next to
the stage spans rather than hiding inside a stage wall.

Capacity bounds the in-flight buffer: a fast featurizer can run at
most `capacity` chunks ahead of the corpus builder, so the overlap
never degenerates into materializing the whole stream twice.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

# Chunks a producer may run ahead of its consumer before put() stalls
# (the stall is priced as a dataplane.stall span).
CHANNEL_CAPACITY = 4


class ChannelClosed(Exception):
    """Raised by get() once the channel is closed and drained."""


class ChannelError(RuntimeError):
    """The peer failed; carries the original exception as __cause__."""


class Channel:
    """Bounded producer→consumer edge with priced stalls.

    Thread-safe; one producer and one consumer is the intended shape
    (multiple are safe, ordering then unspecified).  `recorder` /
    `journal` are optional telemetry hooks (spans/histograms and raw
    journal appends respectively); without them the channel is just a
    bounded queue.
    """

    def __init__(self, edge: str, capacity: int, recorder=None,
                 journal=None) -> None:
        self.edge = edge
        self.capacity = max(1, int(capacity))
        self._cond = threading.Condition()
        self._buf: deque = deque()
        self._closed = False
        self._error: "BaseException | None" = None
        self._puts = 0
        self._gets = 0
        self._put_stall_ns = 0
        self._get_stall_ns = 0
        self._max_depth = 0
        self._recorder = recorder
        self._journal = journal

    # -- producer side ---------------------------------------------------

    def put(self, item) -> None:
        """Append one item; blocks while the buffer is full.  Raises
        ChannelError if the consumer failed, ValueError on a closed
        channel (a producer bug)."""
        with self._maybe_stall_span("put"):
            with self._cond:
                wait_ns = 0
                t0 = None
                while (len(self._buf) >= self.capacity
                       and self._error is None and not self._closed):
                    if t0 is None:
                        t0 = time.perf_counter_ns()
                    self._cond.wait()
                if t0 is not None:
                    wait_ns = time.perf_counter_ns() - t0
                    self._put_stall_ns += wait_ns
                if self._error is not None:
                    raise ChannelError(
                        f"dataplane edge {self.edge!r}: consumer failed"
                    ) from self._error
                if self._closed:
                    raise ValueError(
                        f"put() on closed dataplane edge {self.edge!r}"
                    )
                self._buf.append(item)
                self._puts += 1
                depth = len(self._buf)
                self._max_depth = max(self._max_depth, depth)
                self._cond.notify_all()
        self._note("put", depth, wait_ns)

    def close(self) -> None:
        """Producer is done; the consumer drains what is buffered then
        sees ChannelClosed."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Poison the channel: both sides raise from now on (first
        failure wins)."""
        with self._cond:
            if self._error is None:
                self._error = exc
            self._closed = True
            self._cond.notify_all()

    # -- consumer side ---------------------------------------------------

    def get(self):
        """Next item; blocks while empty.  Raises ChannelClosed when
        closed and drained, ChannelError if the producer failed."""
        with self._maybe_stall_span("get"):
            with self._cond:
                wait_ns = 0
                t0 = None
                while not self._buf and self._error is None \
                        and not self._closed:
                    if t0 is None:
                        t0 = time.perf_counter_ns()
                    self._cond.wait()
                if t0 is not None:
                    wait_ns = time.perf_counter_ns() - t0
                    self._get_stall_ns += wait_ns
                if self._buf:
                    item = self._buf.popleft()
                    self._gets += 1
                    depth = len(self._buf)
                    self._cond.notify_all()
                elif self._error is not None:
                    raise ChannelError(
                        f"dataplane edge {self.edge!r}: producer failed"
                    ) from self._error
                else:
                    raise ChannelClosed(self.edge)
        self._note("get", depth, wait_ns)
        return item

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except ChannelClosed:
                return

    # -- telemetry -------------------------------------------------------

    def _maybe_stall_span(self, side: str):
        """A `dataplane.stall` span covering the blocking section, only
        when the channel *looks* like it will block (peeked without the
        lock — the span's existence is best-effort; the exact wait time
        always rides the journal record and histogram)."""
        rec = self._recorder
        if rec is None:
            return contextlib.nullcontext()
        blocked = (len(self._buf) >= self.capacity if side == "put"
                   else not self._buf) and not self._closed
        if not blocked:
            return contextlib.nullcontext()
        return rec.span("dataplane.stall", edge=self.edge, side=side)

    def _note(self, side: str, depth: int, wait_ns: int) -> None:
        rec = self._recorder
        if rec is not None:
            rec.gauge(f"dataplane.{self.edge}.depth", depth)
            if wait_ns:
                rec.histogram(
                    f"dataplane.{self.edge}.{side}_stall_s"
                ).observe(wait_ns / 1e9)
        if self._journal is not None:
            record = {
                "kind": "dataplane", "event": "depth", "edge": self.edge,
                "side": side, "depth": depth,
            }
            if wait_ns:
                record["wait_s"] = round(wait_ns / 1e9, 6)
            self._journal.append(record)

    def stats(self) -> dict:
        """Per-edge accounting for the run's dataplane record."""
        with self._cond:
            return {
                "edge": self.edge,
                "capacity": self.capacity,
                "puts": self._puts,
                "gets": self._gets,
                "put_stall_s": round(self._put_stall_ns / 1e9, 6),
                "get_stall_s": round(self._get_stall_ns / 1e9, 6),
                "max_depth": self._max_depth,
            }
