"""Roofline accounting: an analytic cost per entry point, joined with
measured wall time, against the card's published peaks (port of
oni_ml_tpu/telemetry/roofline.py).

1. **Cost registry** — the code that knows the shapes registers the
   FLOPs and bytes of one dispatch under an entry name
   (`register_cost`): the scorer's chunk loop (scoring/pipeline.py
   `loop_cost`), the EM loop per iteration (ops/sparse_estep.py
   `em_iteration_cost`), a serving micro-batch (`micro_batch_cost`,
   registered by runner/serve.py over its device flushes).  The JAX package reads these off XLA's cost
   analysis of the compiled program; the port counts them from the
   shapes instead, so a share counts the same work whichever
   implementation (kernel, plain ops, another engine) ran it.  Each
   input is counted read once and each output written once.  The
   emitter says in the record's `count` whether that is the work the
   inputs need ("needed") or an upper count of it ("upper": the EM
   loop, which charges every token its iteration's largest fixed-point
   count).
2. **Peaks** — `peaks_for()` maps the plans-layer device fingerprint
   (`cuda:<name>:<count>`) to published peak FLOP/s and device-memory
   bytes/s (`PEAK_SPECS`, provenance carried per entry).  The CPU and
   unknown cards have NO peaks, so their records carry achieved rates
   only (`utilization: null`), never an exception.
3. **Join** — `emit(phase, wall_s, dispatches)` multiplies the entry's
   per-dispatch cost by the dispatch count, divides by the measured
   wall (monotonic clocks, telemetry/spans.py), and appends a
   `{"kind": "roofline", ...}` record to the active journal plus
   `roofline.<phase>.*` gauges on the active Recorder.  The runner folds
   the records of a run into metrics.json.

`bound_s` is the least time the card could take for a given count: the
larger of the bytes over the memory rate and the operations over the
FLOP rate.  chip_smoke.py's kernel bounds come from it too.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from .spans import current_recorder


# ---------------------------------------------------------------------------
# Peak-spec registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PeakSpec:
    """Published per-card peaks for one GPU model."""

    flops_per_s: float       # float32 outside the tensor cores
    hbm_bytes_per_s: float   # device-memory bandwidth
    provenance: str


# The kernels' arithmetic is float32 FMA on the CUDA cores, so the FLOP
# peak is the float32 (non-tensor-core) rate.
H100_SXM = PeakSpec(
    flops_per_s=67e12,
    hbm_bytes_per_s=3.35e12,
    provenance=(
        "NVIDIA H100 SXM5 data sheet: 67 TFLOP/s float32 outside the "
        "tensor cores (dense, no sparsity), 80 GB HBM3 at 3.35 TB/s; "
        "rates at the 700 W power limit"
    ),
)

# Matched as substrings against the plans-layer device fingerprint
# ("cuda:<device name>:<count>", lowercase, spaces -> _).  First match
# wins.  The CPU and unrecognized cards deliberately have NO entry:
# peaks_for() returns None and every record degrades to
# `utilization: null` instead of inventing a denominator.  The PCIe and
# NVL parts of the H100 have other peaks and are not listed.
PEAK_SPECS: "tuple[tuple[tuple[str, ...], PeakSpec], ...]" = (
    (("nvidia_h100_80gb_hbm3", "nvidia_h100_sxm"), H100_SXM),
)


def peaks_for(fingerprint: "str | None") -> "PeakSpec | None":
    """PeakSpec for a plans-layer device fingerprint, or None when the
    device has no registered peaks (CPU, unknown)."""
    if not fingerprint:
        return None
    fp = fingerprint.lower()
    if not fp.startswith("cuda:"):
        return None
    for patterns, spec in PEAK_SPECS:
        if any(p in fp for p in patterns):
            return spec
    return None


def bound_s(flops: float, nbytes: float,
            spec: PeakSpec = H100_SXM) -> "tuple[float, str]":
    """(least seconds the card could take, "bytes" or "operations"):
    the larger of bytes over the memory rate and FLOPs over the FLOP
    rate."""
    t_bytes = float(nbytes) / spec.hbm_bytes_per_s
    t_ops = float(flops) / spec.flops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _backend_fingerprint(device=None) -> str:
    """The plans-layer device fingerprint, without ever letting a
    fingerprint probe take the caller down."""
    try:
        from ..plans import device_fingerprint

        return device_fingerprint(device)
    except Exception:
        return "nodevice"


# ---------------------------------------------------------------------------
# Analytic cost registry — one per process
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_COSTS: "dict[str, dict]" = {}
# Roofline records emitted this process (bounded) — what the runner
# folds into metrics.json.
_EMITTED: deque = deque(maxlen=256)
_EMIT_COUNT = 0


def register_cost(name: str, *, flops: float, nbytes: float,
                  shape: str = "", device=None,
                  backend: "str | None" = None) -> dict:
    """Register the FLOPs and bytes of one dispatch of `name`, counted
    from its shapes, for a run on `device` (or under an explicit
    `backend` fingerprint).  Replaces an earlier entry of that name."""
    entry = {
        "flops": float(flops),
        "bytes": float(nbytes),
        "shape": shape,
        "backend": backend or _backend_fingerprint(device),
        "source": "analytic",
    }
    with _LOCK:
        _COSTS[name] = entry
    return dict(entry)


def micro_batch_cost(events: float, k: int) -> "tuple[float, float]":
    """(FLOPs, bytes) of scoring `events` serving events, counted from
    the shapes: per event two int32 row indices read, the two K-wide
    float32 rows they gather (theta's and p's), K multiply-adds and one
    float32 score written (the `serve.micro_batch` entry)."""
    return 2.0 * k * events, (2 * 4 + 2 * 4 * k + 4) * float(events)


def cost_for(name: str) -> "dict | None":
    with _LOCK:
        return dict(_COSTS[name]) if name in _COSTS else None


def reset() -> None:
    """Clear the process registries (tests)."""
    with _LOCK:
        _COSTS.clear()
        _EMITTED.clear()


# ---------------------------------------------------------------------------
# Record construction + emission
# ---------------------------------------------------------------------------


def roofline_record(phase: str, wall_s: float, *, entry: "str | None" = None,
                    dispatches: int = 1,
                    effective_flops: "float | None" = None,
                    **extra) -> dict:
    """Build one roofline record: the entry's per-dispatch cost times
    `dispatches`, over the measured wall, against the device's peaks.

    Always returns a record.  Without a registered cost: wall-time-only
    (`flops`/`bytes`/`utilization` null).  With a cost but no peaks
    (CPU): achieved FLOP/s and bytes/s, `utilization` null.  With peaks,
    `utilization` holds `flops_pct` and `hbm_pct` (each rate over its
    peak) and `roofline_pct`, the larger: the least time the card could
    take for the counted work over the wall, bound by `bound_by`.

    `effective_flops` (total over the wall) is the FLOPs the math
    needed where the registered count is of the work executed; the
    record then carries `effective_flops`/`effective_flops_per_s` and
    `utilization.useful_flops_pct`."""
    cost = cost_for(entry or phase)
    backend = (cost or {}).get("backend") or _backend_fingerprint()
    rec = {
        "kind": "roofline",
        "phase": phase,
        "entry": entry or phase,
        "backend": backend,
        "wall_s": round(float(wall_s), 6),
        "dispatches": int(dispatches),
        "cost_source": (cost or {}).get("source", "unregistered"),
        "flops": None,
        "bytes": None,
        "flops_per_s": None,
        "bytes_per_s": None,
        "effective_flops": None,
        "effective_flops_per_s": None,
        "peaks": None,
        "utilization": None,
        **extra,
    }
    if wall_s <= 0:
        return rec
    if effective_flops is not None:
        rec["effective_flops"] = float(effective_flops)
        rec["effective_flops_per_s"] = float(effective_flops) / wall_s
    spec = peaks_for(backend)
    if cost is not None:
        rec["flops"] = cost["flops"] * dispatches
        rec["flops_per_s"] = rec["flops"] / wall_s
        rec["bytes"] = cost["bytes"] * dispatches
        rec["bytes_per_s"] = rec["bytes"] / wall_s
    if spec is not None and (cost is not None
                             or rec["effective_flops_per_s"] is not None):
        rec["peaks"] = {
            "flops_per_s": spec.flops_per_s,
            "hbm_bytes_per_s": spec.hbm_bytes_per_s,
            "provenance": spec.provenance,
        }
        util = {}
        if rec["flops_per_s"] is not None:
            util["flops_pct"] = 100.0 * rec["flops_per_s"] / spec.flops_per_s
            util["hbm_pct"] = (100.0 * rec["bytes_per_s"]
                               / spec.hbm_bytes_per_s)
            least, by = bound_s(rec["flops"], rec["bytes"], spec)
            util["roofline_pct"] = 100.0 * least / wall_s
            rec["bound_s"] = least
            rec["bound_by"] = by
        if rec["effective_flops_per_s"] is not None:
            util["useful_flops_pct"] = (
                100.0 * rec["effective_flops_per_s"] / spec.flops_per_s)
        rec["utilization"] = util or None
    return rec


def emit(phase: str, wall_s: float, *, entry: "str | None" = None,
         dispatches: int = 1, effective_flops: "float | None" = None,
         recorder=None, journal=None, **extra) -> dict:
    """Build and publish one roofline record: set `roofline.<phase>.*`
    gauges on `recorder` (default: the active Recorder), append the
    record to `journal` (a Journal or RunJournal; default: the
    Recorder's journal), and keep it in the process ledger
    (`emitted_records()`) for the runner's metrics.json.  Never
    raises."""
    rec = roofline_record(phase, wall_s, entry=entry,
                          dispatches=dispatches,
                          effective_flops=effective_flops, **extra)
    try:
        r = recorder if recorder is not None else current_recorder()
        if r is not None:
            for key in ("flops_per_s", "bytes_per_s",
                        "effective_flops_per_s"):
                if rec[key] is not None:
                    r.gauge(f"roofline.{phase}.{key}", rec[key])
            for k, v in (rec.get("utilization") or {}).items():
                r.gauge(f"roofline.{phase}.{k}", v)
        if journal is not None:
            journal.append(dict(rec))
        elif r is not None:
            r.journal_record(rec)
        global _EMIT_COUNT
        with _LOCK:
            _EMITTED.append(rec)
            _EMIT_COUNT += 1
    except Exception:
        pass
    return rec


def emit_count() -> int:
    """Total emits this process — callers snapshot it to scope
    emitted_records() to their own run (tests drive several pipelines
    per process)."""
    with _LOCK:
        return _EMIT_COUNT


def emitted_records(since: int = 0) -> "list[dict]":
    """Records emitted after the `since` count (bounded by the ledger's
    retention)."""
    with _LOCK:
        new = _EMIT_COUNT - since
        recs = list(_EMITTED)[-new:] if new > 0 else []
        return [dict(r) for r in recs]
