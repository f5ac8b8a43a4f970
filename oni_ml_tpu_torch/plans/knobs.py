"""The knob registry of the port's plan cache (the part of
oni_ml_tpu/plans/knobs.py its trainer records): each knob's name and
what a valid plan value is.  The only knob is the measured E-step
engine crossover; the EM driver's chunk and sync and the sparse
layout's tile length are read from config.py, since nothing in the
port measures them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


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
    )
}
