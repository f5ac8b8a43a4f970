"""The tuned-knob registry of the port's plan cache (port of
oni_ml_tpu/plans/knobs.py): every constant the plan layer may own, with
its shipped default, fingerprint scope, declared sweep space and what a
valid plan value is.

Defaults are read from config.py, so resolve()'s config-override test
(a config value that differs from the default wins) cannot drift from
the dataclass defaults.

The JAX package's three doc-block knobs (`dense_estep_block`,
`dense_estep_block_w`, `sparse_estep_bb`) are not registered.  On the
card the doc block is a rule of the kernels' geometry
(ops/sparse_estep.py and ops/dense_estep.py `pick_block`), and that
block is also the stop group: the documents whose fixed point stops
together.  A measured block would therefore change the model's bytes,
and the port keeps plans a throughput-only layer, the JAX package's own
contract (a plans-on day writes the bytes of a plans-off day).

Which entries are keyed by the kernels' build hashes as well as by the
device (`plans.plan_backend(device, kernels)`), so that an edited
kernel measures again: `estep_engine` (the crossover times both E-step
kernels) and `fused_em_chunk` / `host_sync_every` (the chunk probe
times the chunk runner over the E-step kernels; lda's resolution keys
them by `ops/_cuda.estep_kernels()`).  Every other device knob is
measured through plain PyTorch ops or the host and is keyed by the
device alone; the host knobs by the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..config import LDAConfig, ScoringConfig, ServingConfig


def _pos_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v > 0


def _pos_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0


def _calibration_dict(v) -> bool:
    if not isinstance(v, dict) or "break_even" not in v:
        return False
    be = v["break_even"]
    # break_even is a number or None ("the card can never win"); a
    # hand-edited "auto" is refused and the calibration measured again.
    return be is None or (
        isinstance(be, (int, float)) and not isinstance(be, bool)
    )


def _engine_dict(v) -> bool:
    # The dense-vs-sparse crossover record (sparse_estep.engine_crossover):
    # engine must name a real family.
    return isinstance(v, dict) and v.get("engine") in ("dense", "sparse")


def _featurize_engine_dict(v) -> bool:
    # The featurize engine record: the same rule over sources/device.py's
    # engines.
    return isinstance(v, dict) and v.get("engine") in (
        "host", "device", "fused")


@dataclass(frozen=True)
class Knob:
    """One tunable: `scope` picks the fingerprint (a host knob such as
    pre_workers must survive a card swap, a device knob must not);
    `candidates` is the declared sweep space; `valid` rejects garbage
    cache entries (a plan file is operator-editable, so consumers never
    trust it blindly)."""

    name: str
    default: object
    scope: str = "device"              # "device" | "host"
    candidates: tuple = ()
    valid: Callable = field(default=_pos_int)
    doc: str = ""


KNOBS = {
    k.name: k
    for k in (
        Knob("fused_em_chunk", LDAConfig.fused_em_chunk,
             candidates=(16, 32, 64, 128, 256),
             doc="EM iterations per chunk-runner dispatch "
                 "(models/fused.py; tools.em_chunk_probe sweeps it), "
                 "keyed by the E-step kernels' build hashes"),
        Knob("host_sync_every", LDAConfig.host_sync_every,
             # 0 (sync only at chunk boundaries) is not in the plan
             # space and fails the validator: a throughput sweep would
             # always pick it and silently drop the likelihood cadence
             # config.py promises.  0 in config still works (a config
             # value bypasses plan validation).
             candidates=(8, 16, 32), valid=_pos_int,
             doc="EM iterations between host syncs, bounded "
                 "independently of fused_em_chunk; keyed like it"),
        Knob("sparse_estep_l", LDAConfig.sparse_min_bucket_len,
             candidates=(128, 256), valid=_pos_int,
             doc="minimum packed tile length of the sparse engine's "
                 "bucketed layout (sparse_estep.resolve_layout_len)"),
        Knob("estep_engine", None, valid=_engine_dict,
             doc="measured dense-vs-sparse E-step crossover "
                 "(sparse_estep.engine_crossover record, minus its "
                 "source/shape fields), keyed by exact shape and by "
                 "density band and by both kernels' build hashes"),
        Knob("score_device_chunk", ScoringConfig.device_chunk,
             candidates=(8192, 16384, 32768, 65536, 131072, 262144),
             doc="events per device dispatch of the device scorer "
                 "(scoring/pipeline.py; tools.score_probe sweeps it)"),
        Knob("dispatch_calibration", None, valid=_calibration_dict,
             doc="measured host-or-device scoring break-even "
                 "(scoring.score.dispatch_calibration record, minus its "
                 "source field)"),
        Knob("pre_workers", None, scope="host", candidates=(1, 2, 4, 8),
             doc="pre-stage shard workers for this host "
                 "(features/shards.resolve_pre_workers; "
                 "tools.pre_probe sweeps it)"),
        # The serving flush triggers are host-scoped: queueing policy,
        # not a property of the card, and a device fingerprint would
        # make a host-pinned BatchScorer start CUDA at construction.
        Knob("serve_max_batch", ServingConfig.max_batch, scope="host",
             candidates=(512, 1024, 2048, 4096, 8192),
             doc="serving micro-batch flush size (serving/batcher.py)"),
        Knob("serve_max_wait_ms", ServingConfig.max_wait_ms, scope="host",
             candidates=(10.0, 25.0, 50.0, 100.0), valid=_pos_num,
             doc="serving micro-batch latency trigger (ms)"),
        Knob("fleet_max_batch", ServingConfig.fleet_max_batch,
             scope="host", candidates=(512, 1024, 2048, 4096, 8192),
             doc="cross-tenant micro-batch flush size "
                 "(serving/fleet.py FleetScorer)"),
        Knob("fleet_max_wait_ms", ServingConfig.fleet_max_wait_ms,
             scope="host", candidates=(10.0, 25.0, 50.0, 100.0),
             valid=_pos_num,
             doc="cross-tenant micro-batch latency trigger (ms)"),
        Knob("featurize_engine", None, valid=_featurize_engine_dict,
             doc="measured featurize engine for this card "
                 "(sources/device.py resolve_engine; read only when "
                 "ServingConfig.featurize_engine is \"auto\" and "
                 "ONI_ML_TPU_FEATURIZE is unset)"),
        Knob("featurize_block", ServingConfig.featurize_block,
             candidates=(1024, 2048, 4096, 8192),
             doc="power-of-two pad floor of the fused featurize call's "
                 "micro-batch (ops/featurize_kernel.py)"),
        Knob("featurize_break_even", None, valid=_pos_int,
             candidates=(16, 32, 64, 128, 256, 512),
             doc="smallest fleet segment (events) at which the device "
                 "featurize path beats the host featurizer "
                 "(sources/device.measure_break_even; 0 in ServingConfig "
                 "= use this knob)"),
        # Device-scoped: the hot capacity is a property of the card's
        # memory.  ServingConfig's 0 ("unbounded") maps to None here
        # (serving/residency.resolve_hot_capacity), so a plan value
        # engages only where the operator left the knob unset.
        Knob("fleet_hot_tenants", None,
             candidates=(4, 8, 16, 32, 64),
             doc="hot stacked-snapshot tenant capacity per K-group "
                 "(serving/residency.py; 0 in config = unbounded)"),
    )
}
