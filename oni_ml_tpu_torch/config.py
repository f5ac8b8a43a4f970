"""Typed configuration for the port: the fields of the JAX package's
config that the flow day reads, with the same defaults
(oni_ml_tpu/config.py LDAConfig, FeedbackConfig, ScoringConfig and the
flow part of PipelineConfig)."""

from __future__ import annotations

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
    # (one host sync per EM iteration; sparse engine only).
    fused_em_chunk: int = 128
    # At most this many EM iterations between host syncs of the chunk
    # driver, whatever fused_em_chunk is (0 = fused_em_chunk).
    host_sync_every: int = 16
    # E-step engine: "sparse" (csrc/sparse_estep.cu over the bucketed
    # layout), "dense" (csrc/dense_estep.cu over the densified corpus)
    # or "auto" (the card's default, sparse).  ONI_ML_TPU_ESTEP
    # overrides (models/lda.py resolve_estep_engine).
    estep_engine: str = "auto"
    # Dense engine: store the corpus W-major ([W, B]) instead of
    # row-major ([B, W]).  Results are the same up to f32 summation order.
    dense_wmajor: bool = True
    # Seed each EM iteration's fixed point from the previous gamma.
    warm_start_gamma: bool = True
    # Floor of the bucketed layout's power-of-two token lengths.
    sparse_min_bucket_len: int = 128


@dataclass(frozen=True)
class FeedbackConfig:
    """Analyst feedback: severity-3 rows replicated DUPFACTOR times."""

    dup_factor: int = 1000
    nonthreatening_severity: int = 3


@dataclass(frozen=True)
class ScoringConfig:
    """Event scoring threshold and the unseen-key fallback per topic."""

    threshold: float = 1e-20
    flow_fallback: float = 0.05


@dataclass(frozen=True)
class PipelineConfig:
    """The flow day's run configuration."""

    data_dir: str = "."
    flow_path: str = ""
    lda: LDAConfig = field(default_factory=LDAConfig)
    feedback: FeedbackConfig = field(default_factory=FeedbackConfig)
    scoring: ScoringConfig = field(default_factory=ScoringConfig)

    def day_dir(self, fdate: str) -> str:
        return os.path.join(self.data_dir, fdate)
