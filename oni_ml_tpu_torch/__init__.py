"""oni_ml_tpu_torch — the PyTorch/CUDA port of oni_ml_tpu for one NVIDIA
H100.

The package stands alone: it imports `torch` and numpy, never `jax`
and nothing of `oni_ml_tpu` (the JAX package it is tested against).
Modules keep the JAX package's names so each counterpart is easy to
find:

    device.py               device policy (cuda by default, TF32 off)
    config.py               LDAConfig / ScoringConfig / FeedbackConfig
    features/               netflow featurization (pure numpy)
    io/                     file contracts, CSR corpus, bucketed layout
    ops/                    stop rule, special functions, E/M-step,
                            the fused sparse E-step kernel wrapper
    models/                 LDA EM trainer, JAX <-> torch state
    scoring/                float64 host scorer
    runner/ml_ops.py        the flow day: pre -> corpus -> lda -> score
    csrc/                   hand-written CUDA sources (sm_90a)
"""

__version__ = "0.1.0"
