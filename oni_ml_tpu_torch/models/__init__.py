"""LDA training and model-state conversion."""

from .lda import LDAResult, LDATrainer, init_log_beta, train_corpus, update_alpha

__all__ = ["LDAResult", "LDATrainer", "init_log_beta", "train_corpus",
           "update_alpha"]
