"""Crash-safe append-only JSONL run journal (port of
oni_ml_tpu/telemetry/journal.py, stdlib only).

The flight recorder's durable core: one JSON object per line, appended
with a SINGLE `os.write` per record (on POSIX, O_APPEND writes of a
line-sized buffer land contiguously, so concurrent writers and a
mid-write kill can truncate only the final line, never interleave or
corrupt earlier ones), fsynced on a bounded cadence so a SIGKILL'd run
loses at most `fsync_every` records.

Replay is truncated-tail-tolerant: a half-written final line (the
signature of a hard kill mid-append) is dropped silently; undecodable
lines ANYWHERE else are dropped too but counted, so a consumer can
distinguish "clean tail truncation" from "the file is damaged".

Record shape: every append stamps

    {"seq": N, "t": <wall epoch s>, "mono_ns": <monotonic ns>, ...}

`t` is wall-clock (time.time, a timestamp); `mono_ns` is the monotonic
clock, so records order consistently even across an NTP step.  `seq`
restarts per Journal instance; replayed consumers order by file
position, which O_APPEND makes authoritative.

`RunJournal` layers the batch day's record vocabulary on top (run and
stage begin/end/skip, EM likelihood points, the scoring pipeline's
DispatchStats, heartbeats and a lost backend, phases and free-form
annotations; the JAX package's serving records come with that layer)
and owns the resume contract:
`RunJournal.completed_stages(records)` is what the runner consults so
`--stages` resume picks up from the journal without re-running
completed stages.
"""

from __future__ import annotations

import json
import os
import threading
import time


class Journal:
    """Append-only JSONL file with atomic line writes and bounded-loss
    fsync cadence.  Thread-safe; usable as a context manager."""

    def __init__(self, path: str, fsync_every: int = 16) -> None:
        self.path = path
        self._fd = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self._lock = threading.Lock()
        self._fsync_every = max(0, int(fsync_every))
        self._since_sync = 0
        self._seq = 0
        self._closed = False

    def append(self, record: dict, sync: bool = False) -> dict:
        """Append one record (stamped with seq/t/mono_ns) as a single
        write.  `sync=True` forces an immediate fsync — stage
        boundaries use it so the resume contract is durable the moment
        a stage completes, whatever the cadence."""
        with self._lock:
            if self._closed:
                return record
            rec = {
                "seq": self._seq,
                "t": round(time.time(), 6),  # wall-clock timestamp
                "mono_ns": time.monotonic_ns(),
                **record,
            }
            self._seq += 1
            data = (
                json.dumps(rec, separators=(",", ":"), default=str) + "\n"
            ).encode()
            os.write(self._fd, data)
            self._since_sync += 1
            if sync or (
                self._fsync_every and self._since_sync >= self._fsync_every
            ):
                os.fsync(self._fd)
                self._since_sync = 0
            return rec

    def sync(self) -> None:
        with self._lock:
            if not self._closed:
                os.fsync(self._fd)
                self._since_sync = 0

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                os.fsync(self._fd)
                os.close(self._fd)
                self._closed = True

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- replay ----------------------------------------------------------
    @staticmethod
    def replay(path: str) -> list[dict]:
        """Records in file order; a missing file is an empty journal."""
        records, _ = Journal.replay_report(path)
        return records

    @staticmethod
    def replay_report(path: str) -> tuple[list[dict], int]:
        """(records, dropped_line_count).  The final line, when
        undecodable, is the expected hard-kill truncation signature and
        does NOT count as dropped; undecodable lines elsewhere do."""
        if not os.path.exists(path):
            return [], 0
        with open(path, "rb") as f:
            raw = f.read()
        records: list[dict] = []
        dropped = 0
        lines = raw.split(b"\n")
        # A well-formed journal ends with b"" after the final newline,
        # so index len-1 is only a real (partial) record after a kill
        # mid-append — that one is tolerated without counting.
        last_idx = len(lines) - 1
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if i != last_idx:
                    dropped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            elif i != last_idx:
                dropped += 1
        return records, dropped


class RunJournal:
    """The pipeline's record vocabulary over a Journal (or over nothing:
    every method tolerates journal=None so call sites need no guards)."""

    def __init__(self, journal: "Journal | None") -> None:
        self.journal = journal

    def append(self, record: dict, sync: bool = False) -> None:
        if self.journal is not None:
            self.journal.append(record, sync=sync)

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()

    # -- run / stage lifecycle ------------------------------------------
    def run_start(self, force: bool = False, **info) -> None:
        # **info first: the reserved kind/force fields win a collision.
        self.append(
            {**info, "kind": "run_start", "force": bool(force)}, sync=True
        )

    def run_end(self, ok: bool = True, **info) -> None:
        self.append({**info, "kind": "run_end", "ok": bool(ok)}, sync=True)

    def stage_begin(self, stage: str, **info) -> None:
        self.append({"kind": "stage", "stage": stage, "status": "begin",
                     **info})

    def stage_end(self, stage: str, ok: bool = True, wall_s=None,
                  **info) -> None:
        rec = {"kind": "stage", "stage": stage,
               "status": "end" if ok else "failed"}
        if wall_s is not None:
            rec["wall_s"] = wall_s
        rec.update(info)
        self.append(rec, sync=True)  # the resume contract: durable now

    def stage_skipped(self, stage: str, reason: str) -> None:
        self.append({"kind": "stage", "stage": stage, "status": "skipped",
                     "reason": reason})

    # -- point records ---------------------------------------------------
    def em_likelihood(self, it: int, ll: float, conv: float) -> None:
        """One EM likelihood point — streamed at the fused driver's
        host-sync cadence (LDAConfig.host_sync_every), so a crashed fit
        leaves its sub-run likelihood trajectory on disk."""
        self.append({"kind": "em_ll", "iter": int(it), "ll": float(ll),
                     "conv": float(conv)})

    def dispatch_stats(self, record: dict, **info) -> None:
        """Scoring pipeline DispatchStats.as_record() payload."""
        self.append({"kind": "dispatch", **info, "stats": record})

    def heartbeat(self, ok: bool, **info) -> None:
        self.append({"kind": "heartbeat", "ok": bool(ok), **info})

    def backend_lost(self, **info) -> None:
        self.append({"kind": "backend_lost", **info}, sync=True)

    def phase(self, name: str, ok: bool = True, **info) -> None:
        """A named phase's completion or failure (a smoke or bench run)."""
        self.append({"kind": "phase", "name": name, "ok": bool(ok),
                     **info}, sync=True)

    def annotation(self, kind: str, **info) -> None:
        self.append({"kind": kind, **info})

    # -- resume contract -------------------------------------------------
    @staticmethod
    def completed_stages(records: list[dict]) -> set:
        """Stage names recorded complete, honoring force boundaries: a
        `run_start` with force=True invalidates everything before it
        (that run re-executes every stage, so earlier completions no
        longer describe the artifacts on disk)."""
        done: set = set()
        for rec in records:
            kind = rec.get("kind")
            if kind == "run_start" and rec.get("force"):
                done.clear()
            elif kind == "stage" and rec.get("status") == "end":
                stage = rec.get("stage")
                if stage:
                    done.add(stage)
        return done

    @staticmethod
    def likelihood_points(records: list[dict]) -> list[tuple]:
        """(iter, ll, conv) points from em_ll records, in order."""
        return [
            (r.get("iter"), r.get("ll"), r.get("conv"))
            for r in records
            if r.get("kind") == "em_ll"
        ]
