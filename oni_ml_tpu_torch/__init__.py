"""oni_ml_tpu_torch — the PyTorch/CUDA port of oni_ml_tpu for one NVIDIA
H100.

The package stands alone: it imports `torch` and numpy, never `jax`
and nothing of `oni_ml_tpu` (the JAX package it is tested against).
Modules keep the JAX package's names so each counterpart is easy to
find:

    device.py               device policy (cuda by default, TF32 off)
    config.py               LDAConfig / ScoringConfig / FeedbackConfig /
                            TelemetryConfig / PipelineConfig
    features/               netflow and DNS featurization (pure numpy)
    sources/                the source registry: flow, dns, proxy
    io/                     file contracts, CSR corpus, bucketed layout
    ops/                    stop rule, special functions, E/M-step,
                            the E-step kernels' wrappers
    models/                 LDA EM trainer and checkpoints, JAX <-> torch
                            state
    scoring/                float64 host scorer and the device engine's
                            chunked pipeline
    telemetry/              the flight recorder: run journal, spans,
                            roofline records, heartbeat, OpenMetrics
    plans/                  the plan cache (the measured crossover, the
                            scorer's calibration) and knob resolution
    runner/ml_ops.py        a flow, dns or proxy day: pre -> corpus ->
                            lda -> score, resumable stage by stage
    runner/lda_cli.py       drop-in for the reference's `lda est` binary
    synth.py                synthetic flow and DNS days
    csrc/                   hand-written CUDA sources (sm_90a)
"""

__version__ = "0.1.0"
