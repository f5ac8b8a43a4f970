"""Measured execution plans: the persisted plan cache, the bounded
autotune harness that fills it, and the one precedence rule every tuned
knob resolves by (port of oni_ml_tpu/plans).

- `store.PlanStore` — a versioned JSONL store keyed by backend
  fingerprint + shape signature + schema version, at
  `ONI_ML_TPU_PLAN_CACHE` or `~/.cache/oni_ml_tpu_torch/plans.jsonl`,
  with the seed files under `plans/seeds/` layered beneath it.  The
  port ships no seed plans: the JAX package's were measured on a TPU.
- `knobs.KNOBS` — every knob with its default (from config.py), scope,
  sweep space and validator.
- `autotune.autotune` — a bounded sweep: measure a declared candidate
  space under a wall-clock budget and record the winner with its
  measurements.  The probes under `oni_ml_tpu_torch/tools/` run it.
- `resolve` — the one precedence rule: a config value that differs from
  the knob's default wins ("config"); else a plan entry for this
  backend and shape, exact before "*" ("plan"); else the default
  ("default").  Consumers name the source in their records.
- `lookup_value` / `record_value` — read and append one knob's entry.
- `counters` — plan hits, defaults, config wins and sweeps, which the
  day runner's `plans` record reports as deltas.
- Fingerprints: host knobs (`pre_workers`, the serving triggers) key by
  `host_fingerprint()` and never touch CUDA; device knobs by the RUN's
  device, `cuda:<name, normalized>:<device count>` on the card and
  `cpu:<machine>:<cores>` on the CPU, so a plan measured on the card
  never serves a CPU run.  A value measured through the port's CUDA
  kernels is keyed by their build hashes too (`plan_backend(...,
  kernels=)`), so a plan written with other kernel sources misses and
  is measured again (knobs.py names which knobs).

`ONI_ML_TPU_PLANS=0` disables every lookup and record.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import platform

from .autotune import AutotuneResult, autotune
from .knobs import KNOBS, Knob
from .store import (
    SCHEMA_VERSION,
    NullStore,
    PlanEntry,
    PlanStore,
    default_path,
    seed_paths,
)

__all__ = [
    "AutotuneResult", "KNOBS", "Knob", "NullStore", "PlanEntry", "PlanStore",
    "SCHEMA_VERSION", "autotune", "counters", "counters_snapshot",
    "current_store", "default_path", "default_store", "device_fingerprint",
    "em_shape", "fingerprint", "host_fingerprint", "lookup_value",
    "note_sweep", "plan_backend", "plans_enabled", "record_value", "resolve",
    "seed_paths", "use_store",
]


# Process-wide counters the records surface: plan lookups that hit,
# that fell to the default, config values that won, and measurement
# passes (an autotune sweep, the engine crossover, the dispatch
# calibration).
counters = {"plan_hits": 0, "defaults": 0, "config": 0,
            "autotune_sweeps": 0}


def note_sweep(knob: str) -> None:
    """Count one measurement pass of `knob`, so "a second run measures
    nothing" is assertable from the records."""
    counters["autotune_sweeps"] += 1


def counters_snapshot() -> dict:
    return dict(counters)


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def _norm(s: str) -> str:
    return s.strip().lower().replace(" ", "_")


def host_fingerprint() -> str:
    """Fingerprint of host-side knobs: machine and cores.  Imports no
    torch, so the pre stage and host-pinned serving never start CUDA."""
    return _norm(f"host:{platform.machine()}:{os.cpu_count() or 1}")


_DEVICE_FP: "dict[str, str]" = {}


def device_fingerprint(device=None) -> str:
    """Fingerprint of device-side knobs for a run on `device` (None:
    the card when there is one, else the CPU)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    key = str(dev)
    if key not in _DEVICE_FP:
        if dev.type == "cuda":
            idx = dev.index if dev.index is not None else 0
            _DEVICE_FP[key] = _norm(
                f"cuda:{torch.cuda.get_device_name(idx)}:"
                f"{torch.cuda.device_count()}")
        else:
            _DEVICE_FP[key] = _norm(
                f"{dev.type}:{platform.machine()}:{os.cpu_count() or 1}")
    return _DEVICE_FP[key]


def fingerprint(scope: str, device=None) -> str:
    """The fingerprint of a knob of `scope` ("host" or "device") for a
    run on `device`."""
    return host_fingerprint() if scope == "host" else \
        device_fingerprint(device)


# ---------------------------------------------------------------------------
# Store selection
# ---------------------------------------------------------------------------

_DEFAULT: "PlanStore | None" = None
_current: contextvars.ContextVar = contextvars.ContextVar(
    "oni_torch_plan_store", default=None)


def plans_enabled() -> bool:
    return os.environ.get("ONI_ML_TPU_PLANS", "1") not in ("0", "off", "no")


def default_store() -> PlanStore:
    """The process default store at `default_path()`, re-opened when
    the env path changes."""
    global _DEFAULT
    path = default_path()
    if _DEFAULT is None or _DEFAULT.path != path:
        if _DEFAULT is not None:
            _DEFAULT.close()
        _DEFAULT = PlanStore(path)
    return _DEFAULT


def current_store() -> "PlanStore | None":
    """The `use_store` context's store when one is active, else the
    default store; None when plans are disabled."""
    if not plans_enabled():
        return None
    store = _current.get()
    if store is not None:
        return None if isinstance(store, NullStore) else store
    return default_store()


@contextlib.contextmanager
def use_store(store: "PlanStore | NullStore | None"):
    """Scope the active plan store (a NullStore disables lookups)."""
    token = _current.set(store)
    try:
        yield store
    finally:
        _current.reset(token)


# ---------------------------------------------------------------------------
# Lookup and record
# ---------------------------------------------------------------------------


def plan_backend(device=None, kernels: "str | None" = None,
                 scope: str = "device") -> str:
    """The backend key of a plan entry: the fingerprint of `scope` and,
    for a value measured through the port's CUDA kernels, their build
    hashes (`kernels`), so a plan measured with other kernel sources
    misses."""
    fp = fingerprint(scope, device)
    return f"{fp}|src:{kernels}" if kernels else fp


def lookup_value(knob: str, shape: str = "*", device=None,
                 kernels: "str | None" = None):
    """The plan entry's value for `knob` at `shape` for a run on
    `device` with the kernels of build hash `kernels`, or None; never
    raises.  Counts nothing: the caller may still reject the value
    (resolve counts the knobs that ran from a plan)."""
    try:
        st = current_store()
        if st is None:
            return None
        spec = KNOBS[knob]
        entry = st.lookup(knob, plan_backend(device, kernels, spec.scope),
                          shape)
        if entry is not None and spec.valid(entry.value):
            return entry.value
    except Exception:
        return None
    return None


def record_value(knob: str, value, *, shape: str = "*",
                 source: str = "autotune", measurements=None, device=None,
                 kernels: "str | None" = None, **info) -> bool:
    """Append one plan entry for a knob of KNOBS to the active store,
    keyed by plan_backend(device, kernels, the knob's scope); never
    raises (a read-only cache must not fail the measurement).  Returns
    whether the entry was written."""
    try:
        st = current_store()
        if st is None:
            return False
        spec = KNOBS[knob]
        st.record(knob, plan_backend(device, kernels, spec.scope), shape,
                  value, source=source, measurements=measurements, **info)
        return True
    except Exception:
        return False


_UNSET = object()


def resolve(knob: str, config_value, *, shape: str = "*", store=_UNSET,
            device=None, kernels: "str | None" = None):
    """-> (value, source) for one knob.

    A config value that differs from the knob's shipped default wins
    ("config"); else a plan entry for this backend (plan_backend of
    `device`, `kernels` and the knob's scope) at `shape`, exact shape
    before the "*" wildcard ("plan"); else the default ("default").
    `config_value=None` means the caller has no config value for this
    knob and goes to the plan.  The comparison is by value: a knob set
    explicitly to its default cannot be told from one left alone, and a
    plan may override it.  `store=None` resolves from config and default
    only (a multi-rank run, whose ranks must agree)."""
    spec = KNOBS[knob]
    if config_value is not None and config_value != spec.default:
        counters["config"] += 1
        return config_value, "config"
    st = current_store() if store is _UNSET else store
    if st is not None:
        entry = st.lookup(knob, plan_backend(device, kernels, spec.scope),
                          shape)
        if entry is not None and spec.valid(entry.value):
            counters["plan_hits"] += 1
            return entry.value, "plan"
    counters["defaults"] += 1
    return (spec.default if config_value is None else config_value,
            "default")


# ---------------------------------------------------------------------------
# Shape signatures
# ---------------------------------------------------------------------------


def em_shape(k: int, v: int, batches=None) -> str:
    """Shape signature of the EM knobs: topics, vocabulary and the
    largest batch shape (the JAX package's format)."""
    sig = f"k{k}.v{v}"
    if batches:
        b, ln = max(tuple(int(n) for n in bt.word_idx.shape)
                    for bt in batches)
        sig += f".b{b}.l{ln}"
    return sig
