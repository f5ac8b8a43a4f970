"""Bounded autotune harness: sweep a declared knob space under a
wall-clock budget and persist the winner with its measurements (port of
oni_ml_tpu/plans/autotune.py).

A sweep is always bounded (`budget_s`): the first candidate always
completes (a plan with no measurement is not a plan), later candidates
start only while budget remains, and a truncated sweep records itself as
such, so a consumer can tell "winner of the whole space" from "best seen
before the clock ran out".

The probes under oni_ml_tpu_torch/tools/ feed measurements through here
or through `plans.record_value`; the day job never runs a sweep inline.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

from .knobs import KNOBS


class AutotuneResult(NamedTuple):
    knob: str
    value: object                 # winning candidate
    measurements: dict            # candidate -> measured metric
    mode: str                     # "min" | "max"
    wall_s: float
    truncated: bool               # budget expired before the space did
    source: str = "autotune"


def autotune(
    knob: str,
    measure: Callable,
    *,
    candidates=None,
    shape: str = "*",
    budget_s: "float | None" = None,
    mode: str = "max",
    clock: Callable[[], float] = time.perf_counter,
    record: bool = True,
    device=None,
    kernels: "str | None" = None,
    **info,
) -> AutotuneResult:
    """Sweep `measure(candidate) -> metric` over the knob's declared
    candidate space (or an explicit `candidates`), starting no new
    candidate once `budget_s` of wall clock is spent, and record the
    winner to the active plan store for a run on `device` with the
    kernels of build hash `kernels` (plans.plan_backend).

    `mode="max"` treats the metric as a rate (higher wins), `mode="min"`
    as a cost.  `clock` is injectable so the budget contract is testable
    under a fake clock."""
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    spec = KNOBS[knob]
    cands = tuple(candidates) if candidates is not None else spec.candidates
    if not cands:
        raise ValueError(f"knob {knob!r} declares no candidate space")
    t0 = clock()
    measurements: dict = {}
    best = None
    truncated = False
    for c in cands:
        if measurements and budget_s is not None and \
                clock() - t0 >= budget_s:
            truncated = True
            break
        m = float(measure(c))
        measurements[c] = m
        if best is None or (
            m > measurements[best] if mode == "max" else m < measurements[best]
        ):
            best = c
    wall_s = clock() - t0

    from . import note_sweep, record_value

    note_sweep(knob)
    result = AutotuneResult(
        knob=knob, value=best, measurements=measurements, mode=mode,
        wall_s=wall_s, truncated=truncated,
    )
    if record:
        record_value(
            knob, best, shape=shape, source="autotune",
            measurements=measurements, device=device, kernels=kernels,
            mode=mode, wall_s=round(wall_s, 4), budget_s=budget_s,
            truncated=truncated, **info,
        )
    return result
