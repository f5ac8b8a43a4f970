"""The knob registry of the port's plan cache (the part of
oni_ml_tpu/plans/knobs.py the port records): each knob's name and what
a valid plan value is.

- `estep_engine`: the measured E-step engine crossover.
- `dispatch_calibration`: the serving scorer's measured host-or-device
  break-even (scoring.score.dispatch_calibration).
- `featurize_break_even`: the smallest fleet segment at which the device
  featurize path beats the host featurizer
  (sources/device.measure_break_even records it; resolve_break_even
  reads it through `plans.resolve`).

The EM driver's chunk and sync, the sparse layout's tile length, the
micro-batchers' flush triggers, the fleet's hot capacity and the
featurize engine and block are read from config.py, since nothing in the
port measures them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


def _calibration_dict(v) -> bool:
    if not isinstance(v, dict) or "break_even" not in v:
        return False
    be = v["break_even"]
    # break_even is a number or None ("the card can never win"); a
    # hand-edited "auto" is refused and the calibration measured again.
    return be is None or (
        isinstance(be, (int, float)) and not isinstance(be, bool)
    )


def _pos_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v > 0


def _engine_dict(v) -> bool:
    # The dense-vs-sparse crossover record (sparse_estep.engine_crossover):
    # engine must name a real family.
    return isinstance(v, dict) and v.get("engine") in ("dense", "sparse")


@dataclass(frozen=True)
class Knob:
    """One measured value; `valid` rejects garbage cache entries (a plan
    file is operator-editable, so consumers never trust it blindly)."""

    name: str
    valid: Callable
    doc: str = ""


KNOBS = {
    k.name: k
    for k in (
        Knob("estep_engine", valid=_engine_dict,
             doc="measured dense-vs-sparse E-step crossover "
                 "(sparse_estep.engine_crossover record, minus its "
                 "source/shape fields), keyed by exact shape and by "
                 "density band"),
        Knob("dispatch_calibration", valid=_calibration_dict,
             doc="measured host-or-device scoring break-even "
                 "(scoring.score.dispatch_calibration record, minus its "
                 "source field)"),
        Knob("featurize_break_even", valid=_pos_int,
             doc="smallest fleet segment (events) at which the device "
                 "featurize path beats the host featurizer "
                 "(sources/device.measure_break_even; 0 in ServingConfig "
                 "= use this knob)"),
    )
}
