"""Versioned on-disk plan store: JSONL, atomic appends, corrupt-tail
tolerant, keyed by (knob, backend fingerprint, shape signature) under a
code schema version (port of oni_ml_tpu/plans/store.py, same schema).

One `os.write` per line (O_APPEND), so concurrent writers and a
mid-write kill can truncate only the final line, and replay tolerates
exactly that truncation.  A plan entry is never load-bearing for
correctness: every consumer validates what it reads and falls back to
config/defaults, so a damaged store degrades to "untuned".

Entry shape (one JSON line, stamped with seq/t/mono_ns as the JAX
package's journal stamps it):

    {"schema": 1, "knob": "estep_engine",
     "backend": "cuda:nvidia_h100_80gb_hbm3:1", "shape": "k20.v5568...",
     "value": {...}, "source": "autotune", "measurements": {...}}

Invalidation is by omission: entries of another `schema` are dropped at
load, and lookups match the run's backend fingerprint, so a cache
written on one backend misses on another.  The latest entry per (knob,
backend, shape) wins.

Seed plans: JSONL files under `plans/seeds/` load beneath the live
file, so a live measurement always overrides a seed (`PlanStore(path,
seeds=True)`).  The port ships no seed file: the JAX package's seeds
were measured on a TPU, and no benchmark has measured the card's yet.
`python -m oni_ml_tpu_torch.tools.plan_cache export` writes a store's
entries in the seed format.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import NamedTuple

SCHEMA_VERSION = 1

ENV_PATH = "ONI_ML_TPU_PLAN_CACHE"


def cache_base() -> str:
    """$XDG_CACHE_HOME or ~/.cache, then oni_ml_tpu_torch/."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "oni_ml_tpu_torch")


def default_path() -> str:
    """Live store path: ONI_ML_TPU_PLAN_CACHE, else
    <cache_base()>/plans.jsonl."""
    return os.environ.get(ENV_PATH) or os.path.join(cache_base(),
                                                    "plans.jsonl")


def seed_paths() -> "list[str]":
    """The seed plan files under plans/seeds/, sorted for a fixed
    layering order."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "seeds")
    return sorted(glob.glob(os.path.join(here, "*.jsonl")))


class PlanEntry(NamedTuple):
    knob: str
    backend: str
    shape: str
    value: object
    source: str          # "autotune" | "probe" | "seed" | ...
    measurements: "dict | None"
    record: dict         # the full on-disk record (provenance)

    @property
    def key(self):
        return (self.knob, self.backend, self.shape)


def _entry_from_record(rec: dict) -> "PlanEntry | None":
    """Schema gate + field extraction; None drops the record."""
    if not isinstance(rec, dict) or rec.get("schema") != SCHEMA_VERSION:
        return None
    knob, backend = rec.get("knob"), rec.get("backend")
    if not knob or not backend or "value" not in rec:
        return None
    meas = rec.get("measurements")
    return PlanEntry(
        knob=str(knob), backend=str(backend),
        shape=str(rec.get("shape") or "*"), value=rec["value"],
        source=str(rec.get("source") or "unknown"),
        measurements=meas if isinstance(meas, dict) else None, record=rec,
    )


def replay_report(path: str) -> "tuple[list[dict], int]":
    """(records, dropped_line_count) of a JSONL file.  An undecodable
    final line is the hard-kill truncation signature and does not count
    as dropped; undecodable lines elsewhere do.  A missing file is
    empty."""
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    records: list = []
    dropped = 0
    last_idx = len(lines) - 1
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            dropped += i != last_idx
            continue
        if isinstance(rec, dict):
            records.append(rec)
        elif i != last_idx:
            dropped += 1
    return records, dropped


class PlanStore:
    """Lazy-loaded plan cache over one JSONL file plus the seed files
    beneath it (`seeds`).  The in-memory map updates on record(), so a
    process sees its own appends without re-reading the file."""

    def __init__(self, path: str, seeds: bool = True) -> None:
        self.path = path
        self._seeds = seeds
        self._entries: "dict | None" = None   # key -> PlanEntry
        self._dropped = 0
        self._fd: "int | None" = None
        self._seq = 0

    def _load(self) -> dict:
        if self._entries is None:
            entries: dict = {}
            dropped = 0
            for path in (seed_paths() if self._seeds else []) + [self.path]:
                records, bad = replay_report(path)
                dropped += bad
                for rec in records:
                    entry = _entry_from_record(rec)
                    if entry is None:
                        dropped += 1
                        continue
                    if path != self.path and entry.source == "unknown":
                        entry = entry._replace(source="seed")
                    entries[entry.key] = entry   # latest (and live) wins
            self._entries, self._dropped = entries, dropped
        return self._entries

    def reload(self) -> None:
        self._entries = None

    @property
    def dropped_records(self) -> int:
        """Undecodable or other-schema records seen at load."""
        self._load()
        return self._dropped

    def entries(self) -> "list[PlanEntry]":
        return list(self._load().values())

    def lookup(self, knob: str, backend: str,
               shape: str = "*") -> "PlanEntry | None":
        """Latest entry for (knob, backend): exact shape first, then the
        '*' wildcard.  A fingerprint or schema mismatch is a miss."""
        entries = self._load()
        hit = entries.get((knob, backend, shape))
        if hit is None and shape != "*":
            hit = entries.get((knob, backend, "*"))
        return hit

    def record(self, knob: str, backend: str, shape: str, value, *,
               source: str = "autotune", measurements=None,
               **info) -> dict:
        """Append one entry (one write, fsynced: each entry cost a
        measurement) and update the in-memory map."""
        rec = {"schema": SCHEMA_VERSION, "knob": knob, "backend": backend,
               "shape": shape or "*", "value": value, "source": source,
               **info}
        if measurements is not None:
            # JSON object keys are strings; normalize so round-trips
            # compare equal.
            rec["measurements"] = {str(k): v for k, v in
                                   dict(measurements).items()}
        if self._fd is None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fd = os.open(self.path,
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        stamped = {"seq": self._seq, "t": round(time.time(), 6),
                   "mono_ns": time.monotonic_ns(), **rec}
        self._seq += 1
        os.write(self._fd, (json.dumps(stamped, separators=(",", ":"),
                                       default=str) + "\n").encode())
        os.fsync(self._fd)
        entry = _entry_from_record(rec)
        if entry is not None:
            self._load()[entry.key] = entry
        return stamped

    def clear(self) -> None:
        """Remove the live file (seeds are code, not cache)."""
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._entries = None

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class NullStore:
    """The disabled store: every lookup misses, every record drops."""

    path = None

    def lookup(self, *a, **kw):
        return None

    def record(self, *a, **kw):
        return {}

    def entries(self):
        return []

    def clear(self) -> None:
        pass

    def close(self) -> None:
        pass
