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
    # Documents per E-step batch (the bucketed layout's batch cap).
    batch_size: int = 1024
    compute_dtype: str = "float32"
    seed: int = 0
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
