"""LDA training (batch EM, window refreshes and online SVI), evaluation,
the drift and quality publish gates, and model-state conversion."""

from .drift import DriftDecision, DriftDetector, QualityDecision, QualityGate
from .lda import (
    LDAResult,
    LDATrainer,
    WindowTrainer,
    init_log_beta,
    train_corpus,
    update_alpha,
    warm_start_log_beta,
)
from .online_lda import OnlineLDATrainer, StreamStepInfo, train_corpus_online

__all__ = ["DriftDecision", "DriftDetector", "LDAResult", "LDATrainer",
           "OnlineLDATrainer", "QualityDecision", "QualityGate",
           "StreamStepInfo", "WindowTrainer", "init_log_beta",
           "train_corpus", "train_corpus_online", "update_alpha",
           "warm_start_log_beta"]
