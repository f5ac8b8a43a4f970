"""LDA training (batch EM and online SVI), evaluation and model-state
conversion."""

from .lda import LDAResult, LDATrainer, init_log_beta, train_corpus, update_alpha
from .online_lda import OnlineLDATrainer, StreamStepInfo, train_corpus_online

__all__ = ["LDAResult", "LDATrainer", "OnlineLDATrainer", "StreamStepInfo",
           "init_log_beta", "train_corpus", "train_corpus_online",
           "update_alpha"]
