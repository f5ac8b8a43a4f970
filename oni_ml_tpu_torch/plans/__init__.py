"""Measured execution plans: the persisted plan cache that the engine
crossover (ops/sparse_estep.engine_crossover) and the serving dispatch
calibration (scoring.score.dispatch_calibration) read and write (port
of the store, the lookup/record half and `resolve` of oni_ml_tpu/plans;
the JAX package's autotune harness and compilation-cache warm-up are not
ported, and plans/warmup.py holds only the serving warm-up).

- `store.PlanStore` — a versioned JSONL store keyed by backend
  fingerprint + shape signature + schema version, at
  `ONI_ML_TPU_PLAN_CACHE` or `~/.cache/oni_ml_tpu_torch/plans.jsonl`.
  The port ships no seed plans: the JAX package's were measured on a
  TPU.
- `lookup_value` / `record_value` — read and append one knob's entry
  (knobs.KNOBS: the engine crossover, the serving dispatch
  calibration, the fleet's featurize break-even).
- `resolve` — the one precedence rule for a knob that also has a config
  field: config > plan > default, with the source named.
- `note_sweep` / `counters_snapshot` — count the measurement passes
  (the dispatch calibration's), which serve's `plans` record shows.
- A value measured through the port's CUDA kernels (the engine
  crossover) is keyed by their build hashes too (`plan_backend`), so a
  plan written with other kernel sources misses and is measured again.
- The device fingerprint is the RUN's device:
  `cuda:<torch.cuda.get_device_name, normalized>:<device count>` for a
  run on the card, `cpu:<machine>:<cores>` for a run on the CPU, so a
  plan measured on the card never serves a CPU run and a plan of one
  card model never serves another.

`ONI_ML_TPU_PLANS=0` disables every lookup and record.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import platform

from .knobs import KNOBS, Knob
from .store import SCHEMA_VERSION, NullStore, PlanEntry, PlanStore, default_path

__all__ = [
    "KNOBS", "Knob", "NullStore", "PlanEntry", "PlanStore", "SCHEMA_VERSION",
    "counters", "counters_snapshot", "current_store", "default_path",
    "default_store", "device_fingerprint", "lookup_value", "note_sweep",
    "plan_backend", "plans_enabled", "record_value", "resolve", "use_store",
]


# Process-wide count of measurement passes (the dispatch calibration's),
# which the serving records surface.
counters = {"autotune_sweeps": 0}


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


def plan_backend(device=None, kernels: "str | None" = None) -> str:
    """The backend key of a plan entry: the device fingerprint and, for a
    value measured through the port's CUDA kernels, their build hashes
    (`kernels`), so a plan measured with other kernel sources misses."""
    fp = device_fingerprint(device)
    return f"{fp}|src:{kernels}" if kernels else fp


def lookup_value(knob: str, shape: str = "*", device=None,
                 kernels: "str | None" = None):
    """The plan entry's value for `knob` at `shape` for a run on
    `device` with the kernels of build hash `kernels`, or None; never
    raises (the caller may still reject it)."""
    try:
        st = current_store()
        if st is None:
            return None
        spec = KNOBS[knob]
        entry = st.lookup(knob, plan_backend(device, kernels), shape)
        if entry is not None and spec.valid(entry.value):
            return entry.value
    except Exception:
        return None
    return None


def record_value(knob: str, value, *, shape: str = "*",
                 source: str = "autotune", measurements=None, device=None,
                 kernels: "str | None" = None, **info) -> bool:
    """Append one plan entry for a knob of KNOBS to the active store,
    keyed by plan_backend(device, kernels); never raises (a read-only
    cache must not fail the measurement).  Returns whether the entry
    was written."""
    try:
        st = current_store()
        if st is None or knob not in KNOBS:
            return False
        st.record(knob, plan_backend(device, kernels), shape, value,
                  source=source, measurements=measurements, **info)
        return True
    except Exception:
        return False


def resolve(knob: str, config_value, *, shape: str = "*", device=None):
    """-> (value, source) for one knob: a config value wins ("config");
    else this device's plan entry ("plan"); else None ("default", the
    caller's own default applies).  `config_value=None` means the caller
    has no config value and goes to the plan."""
    if config_value is not None:
        return config_value, "config"
    value = lookup_value(knob, shape, device)
    if value is not None:
        return value, "plan"
    return None, "default"
