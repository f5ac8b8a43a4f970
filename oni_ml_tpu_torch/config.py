"""Typed configuration for the port: the fields of the JAX package's
config that the flow, DNS and proxy days read, with the same defaults
(oni_ml_tpu/config.py LDAConfig, OnlineLDAConfig, FeedbackConfig,
ScoringConfig, TelemetryConfig, DataplaneConfig, the single-card fields
of ServingConfig, ContinuousConfig and the single-card part of
PipelineConfig)."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LDAConfig:
    """Variational-EM LDA hyperparameters.  Defaults mirror the
    reference invocation ``lda est 2.5 20 settings.txt`` and lda-c's
    stock settings (var max iter 20, em max iter 100, em convergence
    1e-4, alpha estimated)."""

    num_topics: int = 20
    alpha_init: float = 2.5
    estimate_alpha: bool = True
    # Newton cap for the alpha update; <= 16 takes the unrolled,
    # convergence-masked form (models/lda.update_alpha).
    alpha_max_iters: int = 8
    em_max_iters: int = 100
    em_tol: float = 1e-4
    var_max_iters: int = 20
    # Relative to the doc's mean gamma (alpha + N_d/K): see ops/stop.py.
    var_tol: float = 1e-6
    # Documents per E-step batch (the bucketed layout's batch cap, and
    # make_batches' batch size for the dense engine).
    batch_size: int = 1024
    # Floor of make_batches' power-of-two length buckets (dense engine).
    min_bucket_len: int = 16
    compute_dtype: str = "float32"
    seed: int = 0
    # EM iterations per dispatch of the chunk driver (models/fused.py):
    # the stop decision stays on the device and the host reads the
    # likelihoods once per dispatch.  0 or 1 runs the stepwise driver
    # (one host sync per EM iteration; the dense family then runs the
    # per-batch dispatch, as in the JAX package).
    fused_em_chunk: int = 128
    # At most this many EM iterations between host syncs of the chunk
    # driver, whatever fused_em_chunk is (0 = fused_em_chunk).
    host_sync_every: int = 16
    # E-step engine family: "sparse" (csrc/sparse_estep.cu over the
    # bucketed layout), "dense" (the dense family: full-V dense
    # csrc/dense_estep.cu, the compact-vocab variant, or the per-batch
    # dispatch ops/estep.e_step — gated by dense_em below) or "auto":
    # on the card the MEASURED dense-vs-sparse crossover, persisted in
    # the plan cache (sparse_estep.engine_crossover: measured once per
    # card and shape, source "plan" after), on the CPU the dense family.
    # ONI_ML_TPU_ESTEP overrides (models/lda.py resolve_estep_engine);
    # ONI_ML_TPU_ESTEP_ENGINE pins the crossover's answer.
    estep_engine: str = "auto"
    # Dense family, full-V dense E-step: "auto" densifies the corpus once
    # and runs the dense kernel when the run is on the card, the kernel
    # takes K, and the densified corpus (plus the sparse stacks it is
    # made from) fits dense_hbm_budget; then the compact-vocab variant
    # under the same budget; else the per-batch dispatch.  "on"/"off"
    # force it.  ONI_ML_TPU_ESTEP=dense/compact/xla/pallas overrides.
    dense_em: str = "auto"
    # Device-byte ceiling of the densified corpus under dense_em="auto".
    dense_hbm_budget: int = 2 * 1024**3
    # Dense engine: store the corpus W-major ([W, B]) instead of
    # row-major ([B, W]).  Results are the same up to f32 summation order.
    dense_wmajor: bool = True
    # The E-step kernels' storage mode: "f32" (default) or "bf16".  In
    # bf16 the dense family's fixed point rounds beta, exp_et and each
    # ratio to bf16 before its two products (sums f32, the tail full f32
    # on f32 beta) and stores the densified corpus as bf16 where every
    # cell is <= 256 (exact: ops/dense_estep.corpus_dtype); the sparse
    # engine rounds its exp(log beta) table to bf16 once per EM iteration
    # and reads it everywhere, tail included (f32 sums and gamma carry),
    # and its bucketed layout pads the batch axis to 16.  On the TPU the
    # JAX package's bf16 changed no result (XLA's default matmul
    # precision truncates f32 operands anyway); on the card f32 is full
    # f32, so bf16 is a numeric mode of its own whose results differ
    # from f32 within bf16 tolerances (tests/test_torch_bf16.py), with
    # half the bytes for the table, and for the corpus where it is bf16.
    # The per-batch dispatch and the fixed-point kernel stay f32.
    dense_precision: str = "f32"
    # Seed each EM iteration's fixed point from the previous gamma.
    warm_start_gamma: bool = True
    # Floor of the bucketed layout's power-of-two token lengths.
    sparse_min_bucket_len: int = 128
    # Persist (beta, alpha, iteration, likelihoods) to
    # <out_dir>/checkpoint.npz every this many EM iterations; a fit that
    # finds the file resumes from it (0 = off).
    checkpoint_every: int = 0
    # Distributed EM's document shard count (parallel/shard_plan.py):
    # 0 = auto, 8 grown to the next power of two covering the process
    # count.  The shard plan, and with it the reduction tree, derives
    # from the corpus and this number, never the process count, so runs
    # at different rank counts with the same value write byte-identical
    # files.  ONI_ML_TPU_EM_SHARDS overrides.
    em_shards: int = 0
    # Wire precision of the distributed suff-stats allreduce: "f32"
    # (exact, the byte-identity default) or "bf16" (half the kvring
    # bytes per EM iteration, f32 accumulation after the unpack; the
    # reduced stats stay rank-identical but are not bit-equal to an f32
    # wire's).  The gamma merge always ships exact.
    # ONI_ML_TPU_ALLREDUCE_PRECISION overrides.
    allreduce_precision: str = "f32"


@dataclass(frozen=True)
class OnlineLDAConfig:
    """Streaming (stochastic variational) LDA hyperparameters
    (models/online_lda.py, `ml_ops --online`).  tau0/kappa defaults
    follow Hoffman et al. (NIPS 2010); eta is the symmetric topic-word
    Dirichlet prior."""

    num_topics: int = 20
    alpha: float = 2.5           # doc-topic prior (fixed in SVI)
    eta: float = 0.01            # topic-word prior
    tau0: float = 64.0           # learning-rate delay
    kappa: float = 0.7           # learning-rate decay in (0.5, 1]
    var_max_iters: int = 20
    var_tol: float = 1e-6        # relative to mean gamma (see LDAConfig)
    batch_size: int = 1024       # docs per micro-batch
    min_bucket_len: int = 16
    # float32 only: bf16 storage waits for ROADMAP Queue 2 item 5.
    compute_dtype: str = "float32"
    seed: int = 0
    # Checkpoint (lambda, step) every N micro-batch steps (0 = disabled).
    checkpoint_every: int = 0
    # Dense E-step for micro-batches (csrc/dense_estep.cu): "auto" runs
    # it on the card when the kernel takes K (one densify per
    # micro-batch instead of a beta gather in every fixed-point
    # iteration); "on"/"off" force.  Elsewhere the per-batch dispatch
    # ops/estep.e_step runs (the sparse kernel on the card).
    dense_em: str = "auto"


@dataclass(frozen=True)
class FeedbackConfig:
    """Analyst feedback: severity-3 rows replicated DUPFACTOR times."""

    dup_factor: int = 1000
    nonthreatening_severity: int = 3


@dataclass(frozen=True)
class ScoringConfig:
    """Event scoring threshold and the unseen-key fallback per topic
    (0.05 for flow and 0.1 for dns, the reference's hardcoded vectors;
    0.1 for proxy)."""

    threshold: float = 1e-20
    flow_fallback: float = 0.05
    dns_fallback: float = 0.1
    proxy_fallback: float = 0.1
    # Scoring engine of the score stage: "host" is the float64 path
    # whose results-CSV bytes are pinned to the JAX package's; "device"
    # runs the chunked gather-dot-filter pipeline on the card
    # (scoring/pipeline.py): float32 arithmetic (~1e-6 relative in the
    # score columns), survivors-only readback.  "" follows
    # ONI_ML_TPU_SCORE (default host).
    engine: str = ""
    # Events per device dispatch of the device engine
    # (scoring/pipeline.py DEFAULT_CHUNK).  A run that leaves it at this
    # default resolves it through the plan cache (knob
    # "score_device_chunk", which `python -m
    # oni_ml_tpu_torch.tools.score_probe` records).
    device_chunk: int = 1 << 16


@dataclass(frozen=True)
class TelemetryConfig:
    """The flight recorder: the crash-safe run journal
    (run_journal.jsonl in the day directory: stage records and spans, EM
    likelihood points and host-sync spans, scoring DispatchStats,
    roofline records, heartbeats) and the device heartbeat.  The runner
    resumes against the journal."""

    journal: bool = True
    # fsync after this many appends (stage boundaries always fsync).
    journal_fsync_every: int = 16
    # Background device-liveness probe interval (telemetry/heartbeat.py);
    # 0 disables.  A device that stops answering becomes a clean
    # BackendLost at the next stage boundary (journaled as
    # backend_lost) instead of a hang.
    heartbeat_s: float = 0.0


@dataclass(frozen=True)
class DataplaneConfig:
    """Streaming dataplane (dataplane/): in-memory columnar hand-offs
    through pre -> corpus -> EM -> score with bounded-buffer overlap,
    and the inter-stage files demoted to background checkpoint writes.
    Artifacts stay byte-identical to the serial file path
    (--no-dataplane): the dataplane changes when files are written and
    what the next stage reads, never the bytes."""

    # Stream hand-offs + background checkpoint sinks (--no-dataplane:
    # inline writes, each stage re-reading its input from the files).
    enabled: bool = True
    # Write the demoted inter-stage files (features.pkl,
    # word_counts.dat, words/doc/model.dat, final.*, likelihood.dat,
    # doc/word_results.csv).  --no-checkpoints skips them all: the run
    # writes only its products (results CSV, metrics.json,
    # run_journal.jsonl), and a later `--stages` resume is refused,
    # naming the missing file.  Full-chain batch runs only.
    checkpoints: bool = True


@dataclass(frozen=True)
class ServingConfig:
    """The streaming scoring service (serving/, `ml_ops serve`): a
    completed day's model is loaded into a ModelRegistry and a
    BatchScorer serves arriving events in micro-batches; none of these
    knobs affect the day job's stages.  `serve --fleet` serves many
    tenants' models through one FleetScorer (serving/fleet.py), with
    tiered residency (serving/residency.py) and the featurize plane
    (sources/device.py)."""

    # Flush an accumulating micro-batch when it reaches this many
    # events...
    max_batch: int = 4096
    # ...or when its oldest event has waited this long, whichever first.
    max_wait_ms: float = 50.0
    # Host-or-device scoring of a flush.  0 (the default) prices the
    # choice from the measured dispatch calibration
    # (scoring.dispatch_calibration): a flush scores on the card only at
    # or past the measured break-even, and never where the card's
    # per-event cost does not beat the host's.  A positive int is a hard
    # threshold (flushes of at least that many events score on the
    # card); None pins the host.  ONI_ML_TPU_SCORE_BREAK_EVEN pins the
    # break-even.
    device_score_min: "int | None" = 0
    # Backpressure: submit() blocks once this many events are queued.
    queue_max: int = 1 << 16
    # Fold every N scored micro-batches into one online-LDA step and
    # republish theta/p (serving/refresh.py); 0 disables refresh.
    refresh_every: int = 0
    # Population size D of the refresh trainer's suff-stats scaling; 0 =
    # the loaded model's IP count.
    refresh_total_docs: int = 0
    # Events scoring under this are emitted as suspicious.
    threshold: float = 1e-20
    # Per-flush metrics JSON lines also append here ("" = stdout only).
    metrics_path: str = ""
    # OpenMetrics scrape endpoint (telemetry/exporter.MetricsServer,
    # GET /metrics); 0 = none.  Loopback unless metrics_host says
    # otherwise.
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"
    # The same OpenMetrics text written here at stream end ("" = off).
    openmetrics_path: str = ""
    # -- multi-tenant fleet (serving/fleet.py, `serve --fleet`) --
    # Fleet manifest path: a JSON file of tenants (serving/tenants.py
    # load_manifest); "" = single-model serving.
    fleet_manifest: str = ""
    # The FleetScorer's cross-tenant flush triggers: the fleet's
    # max_batch / max_wait_ms, counted over every tenant's queue and
    # timed from the globally oldest event.
    fleet_max_batch: int = 4096
    fleet_max_wait_ms: float = 50.0
    # Per-tenant admission bound: a tenant with this many events pending
    # blocks its own producers (admission "block", the stall priced as
    # serve.<tenant>.admission_stall_s) or sheds them (admission
    # "reject": AdmissionRejected, journaled as admission_reject).  A
    # manifest entry's queue_max / admission override it per tenant.
    tenant_queue_max: int = 8192
    admission: str = "block"
    # -- tiered residency (serving/residency.py) --
    # At most this many tenants per topic count K sit in the stacked
    # snapshot on the card (hot); the rest page between host RAM (warm)
    # and checkpoints (cold) by an admission-driven LRU or LFU policy.
    # 0 = unbounded: every published tenant is stacked.  With a
    # capacity the stack pads to power-of-two tenant-capacity tiers, so
    # paging within a tier keeps the stacked shape.
    fleet_hot_tenants: int = 0
    # At most this many non-hot tenants keep their model in host RAM;
    # past it the policy's coldest spill to checkpoints (an atomic npz
    # under residency_spill_dir, or a reload from the day dir).  0 =
    # unbounded (no cold tier).
    fleet_warm_tenants: int = 0
    # Eviction victims: "lru" (least recently admitted) or "lfu"
    # (fewest admissions, recency breaks ties); a tenant with events
    # queued is never evicted while a quiet one is hot.
    residency_policy: str = "lru"
    # Spill directory of the cold tier ("" = a per-process temp dir).
    residency_spill_dir: str = ""
    # Device storage dtype of the stacked theta/p: "f32" or "bf16"
    # (half the bytes on the card, float32 accumulation in the
    # gather-dot; scores within 2^-7 relative of the f32 stack's).  The
    # host's float64 matrices are untouched.
    stack_precision: str = "f32"
    # -- featurize plane (sources/device.py, ops/featurize_kernel.py) --
    # Which engine builds a flush's word rows: "host" (the Python
    # featurizers, the oracle), "device" (the compiled vocabulary
    # tables: vectorized parse and a packed-code lookup, feeding the
    # same score dispatch, so scores stay bit-equal to the host's) or
    # "fused" (the lookup, both row gathers and the dot in one dispatch
    # on the card per single-tenant K-group, float32: within rel 1e-6).
    # "auto" = "device"; ONI_ML_TPU_FEATURIZE overrides.
    featurize_engine: str = "auto"
    # Power-of-two pad floor of the fused dispatch's batch dimension.
    featurize_block: int = 2048
    # Smallest tenant segment (events) the device featurize engine
    # takes; smaller ones featurize on the host.  0 = the plan entry
    # measure_break_even recorded for this device, else 1 (always);
    # ONI_ML_TPU_FEATURIZE_BREAK_EVEN overrides.
    featurize_break_even: int = 0
    # -- replicated serving (serving/router.py, replica.py, wire.py) --
    # Same-host shared-memory upgrade: when both ends opt in and the
    # hello proves the peer shares this host, data frames move to a
    # wire.ShmRing pair and the TCP data socket stays open as the
    # liveness signal and the oversize-frame escape.  Off = every frame
    # on TCP.
    wire_shm: bool = True
    # Bytes of each ring slab (two slabs a direction): the largest data
    # frame a ring carries; a bigger frame goes over TCP.
    wire_shm_slab_bytes: int = 1 << 20
    # -- the autoscaler (serving/autoscale.py, `route --autoscale`) --
    # Controller tick: each samples the router's admission-window
    # occupancy and stall rates.
    autoscale_interval_s: float = 0.5
    # Hysteresis band on the EWMA'd per-replica window utilization:
    # above `high` one replica joins, below `low` one drains, in between
    # the fleet holds (the gap keeps an oscillating load from flapping
    # it).
    autoscale_high: float = 0.75
    autoscale_low: float = 0.25
    # The utilization EWMA's half-life: a sample this old weighs half
    # the current one.
    autoscale_halflife_s: float = 2.0
    # Seconds between scaling actions either way: a join or drain must
    # prove out before the next is considered.
    autoscale_cooldown_s: float = 5.0
    # Replica-count clamp of the controller's decisions; it only ever
    # drains replicas it spawned itself.
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 8
    # Each ReplicaServer publishes a KV heartbeat this often; the router
    # declares a replica lost, promoting its tenants' shadows, after
    # replica_heartbeat_miss intervals without one (connection EOF and
    # the fail key short-circuit the wait).
    replica_heartbeat_s: float = 0.25
    replica_heartbeat_miss: int = 8
    # Router control-op timeout (add_tenant/publish/drain/stats round
    # trips; the per-event scoring path is asynchronous).
    route_op_timeout_s: float = 30.0
    # One priced {"kind": "route"} journal record per edge every this
    # many forwarded events; 0 journals only the stream-end rollup.
    route_journal_every: int = 1024
    # Per-replica admission window: at most this many events in flight
    # (submitted, response not yet demuxed) per replica edge; a submit
    # beyond it blocks, and the stall is priced into the edge's stats.
    # 0 = unbounded.
    route_max_inflight: int = 1024


@dataclass(frozen=True)
class ContinuousConfig:
    """The continuous standing service (runner/continuous.py, `ml_ops
    continuous`): raw events stream through featurization into a
    ring-buffered CSR corpus window (dataplane/window.py), each refresh
    warm-starts EM from the previous window's topics, and a held-out
    likelihood drift detector (models/drift.py) gates every publish.
    Time knobs are in event-time seconds (a day replayed at any speed
    keeps the same window semantics)."""

    # Window span: events older than this (by event time) retire from
    # the training window at the next advance.  Default: 4 hours.
    window_s: float = 4 * 3600.0
    # Refresh cadence: advance + refit + drift check + gated publish
    # every this much event time.  Default: 30 minutes.
    refresh_every_s: float = 1800.0
    # Hash-split fraction of window documents scored held-out per
    # refresh (models/evaluate.py document completion): the drift
    # detector's input and the warm-vs-fresh quality cross-check.
    holdout_frac: float = 0.1
    # Drift: a held-out per-token likelihood more than this many nats
    # below the rolling-history baseline vetoes the publish.
    drift_tol_nats: float = 0.5
    # Rolling history depth (refreshes) the baseline medians over, and
    # the checks required before drift can fire at all.
    drift_history: int = 8
    drift_min_history: int = 2
    # A refresh whose window holds fewer live documents than this skips
    # training (bootstrap guard).
    min_refresh_docs: int = 32
    # The window's vocabulary pads to power-of-two capacity tiers
    # floored here: vocabulary growth inside a tier keeps the [K, V]
    # beta shape, so one WindowTrainer (and its resolved E-step engine)
    # serves the whole tier.
    vocab_floor: int = 4096
    # Docs per E-step batch for window refreshes; window batches pad to
    # the full batch size, so every refresh runs the same (B, L) family.
    batch_size: int = 256
    # Length-bucket floor for window batches: the L family is {64, 128,
    # 256, ...}.
    min_bucket_len: int = 64
    # EM dispatch chunk for window refreshes: 1 = the stepwise driver.
    fused_em_chunk: int = 1
    # Warm-start policy: "auto" seeds EM from the previous published
    # topics except on the first fit or right after a drift veto;
    # "always"/"never" force.
    warm_start: str = "auto"
    # Detection-quality publish gate (models/drift.QualityGate): every
    # candidate is scored against a pinned labeled-injection suite
    # (sources/inject.py), and a recall@k drop of more than quality_tol
    # below the rolling baseline vetoes the publish.  Off by default.
    quality_gate: bool = False
    quality_tol: float = 0.25
    quality_history: int = 8
    quality_min_history: int = 2
    # Injection-suite shape: benign events, attack events per scenario,
    # RNG seed, and ranking depth (0 = k defaults to the attack count).
    quality_events: int = 2000
    quality_attack_events: int = 8
    quality_seed: int = 7
    quality_k: int = 0


@dataclass(frozen=True)
class PlansConfig:
    """Measured execution plans (oni_ml_tpu_torch/plans/): the plan
    cache that holds per-(device, shape) measured values of the tuned
    knobs, and the kernel build cache.  An explicitly set config knob
    wins over a plan entry, which wins over the shipped default; every
    consumer records which source it ran under."""

    # Plan lookups and records on (--no-plans turns them off;
    # ONI_ML_TPU_PLANS=0 is the process-wide switch).
    enabled: bool = True
    # The live plan-cache file ("" = ONI_ML_TPU_PLAN_CACHE, else
    # ~/.cache/oni_ml_tpu_torch/plans.jsonl).  Seed plans under
    # plans/seeds/ load beneath it (the port ships none).
    cache_path: str = ""
    # Build the CUDA kernels and C++ host libraries into the persistent
    # build directory (build/oni_ml_tpu_torch/), so a re-run compiles
    # nothing; False builds what the run loads into a run-scoped
    # temporary directory (--no-compilation-cache: a cold build).
    compilation_cache: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """A single-card day's run configuration."""

    data_dir: str = "."
    flow_path: str = ""            # netflow CSV file/dir/glob/comma list
    dns_path: str = ""             # DNS CSV (or parquet) paths, same forms
    proxy_path: str = ""           # proxy/HTTP log CSV paths, same forms
    top_domains_path: str = ""     # Alexa top-1m.csv (DNS whitelist)
    # Precomputed flow quantile cuts (features/qtiles.py format): skips
    # the in-run ECDF pass and pins word identity across days.
    qtiles_path: str = ""
    # Pre-stage shard workers of the native featurizers
    # (features/shards.resolve_pre_workers): 0 = auto (one per host
    # core), 1 = the sequential pass, N = N workers.  Never changes a
    # byte.
    pre_workers: int = 0
    lda: LDAConfig = field(default_factory=LDAConfig)
    online_lda: OnlineLDAConfig = field(default_factory=OnlineLDAConfig)
    feedback: FeedbackConfig = field(default_factory=FeedbackConfig)
    scoring: ScoringConfig = field(default_factory=ScoringConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    dataplane: DataplaneConfig = field(default_factory=DataplaneConfig)
    plans: PlansConfig = field(default_factory=PlansConfig)
    # The continuous service's scorer and its window refreshes.
    serving: ServingConfig = field(default_factory=ServingConfig)
    continuous: ContinuousConfig = field(default_factory=ContinuousConfig)

    def day_dir(self, fdate: str) -> str:
        return os.path.join(self.data_dir, fdate)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
