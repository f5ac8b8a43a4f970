"""RefreshLoop: fold scored micro-batches into online-LDA steps and
republish theta/p through the registry on a cadence (port of
oni_ml_tpu/serving/refresh.py).

A day's model goes stale as soon as it is published, and the reference's
answer is tomorrow's retrain.  Here every scored micro-batch also gives
its (ip, word) pairs as evidence; every `every` batches the accumulated
evidence becomes one stochastic-variational natural-gradient step
(models/online_lda.py) on the refresh trainer's device, the scorer's
(on the card: the dense kernel, or the per-batch E-step's sparse or
fixed-point kernel), and the updated topics republish through the
registry's atomic hot-swap, so in-flight scoring never sees a
half-updated model.

The model's vocabulary and IP population are frozen at load: events
with unseen words or IPs score by the fallback rows and are skipped as
evidence.
"""

from __future__ import annotations

import time

import numpy as np

from ..config import OnlineLDAConfig
from ..io import Batch
from ..models.online_lda import OnlineLDATrainer
from ..scoring import ScoringModel
from .registry import ModelRegistry, ModelSnapshot


def topic_probs_from_log_beta(log_beta: np.ndarray) -> np.ndarray:
    """[K, V] log p(w|z) -> the [V, K] per-topic-normalized matrix the
    scorer reads: io/formats.py write_word_results' exp-normalize, so a
    refresh publishes what the day's post stage would write."""
    log_beta = np.asarray(log_beta, np.float64)
    shifted = np.exp(log_beta - log_beta.max(axis=1, keepdims=True))
    return (shifted / shifted.sum(axis=1, keepdims=True)).T


class RefreshLoop:
    """Accumulates (ip, word) evidence per scored batch; every `every`
    batches takes one SVI step and publishes the result.  The trainer
    runs on `device` (None: the card)."""

    def __init__(self, registry: ModelRegistry,
                 config: "OnlineLDAConfig | None" = None, every: int = 8,
                 total_docs: int = 0, pseudo_tokens: float = 1e4,
                 device=None) -> None:
        snap = registry.active()
        model = snap.model
        k = model.num_topics
        self.registry = registry
        self.every = every
        self.config = config or OnlineLDAConfig(num_topics=k)
        if self.config.num_topics != k:
            raise ValueError(
                f"refresh config has K={self.config.num_topics} but the "
                f"registry model has K={k}")
        num_ips = len(model.ip_index)
        # p without its fallback row is the [V, K] matrix SVI refines.
        self.trainer = OnlineLDATrainer.from_topic_probs(
            self.config, np.asarray(model.p[:-1], np.float64),
            total_docs=total_docs or max(num_ips, 1),
            pseudo_tokens=pseudo_tokens, device=device)
        self._counts: "dict[str, dict[int, float]]" = {}
        self._batches_seen = 0
        self.refreshes = 0
        # Host wall of the latest refresh() (the step, the inference
        # pass, the read-back and the publish).
        self.last_refresh_s: "float | None" = None

    def observe(self, snapshot: ModelSnapshot, ips, words
                ) -> "ModelSnapshot | None":
        """Fold one scored batch's (ip, word) pairs in; returns the new
        snapshot when this batch crossed the cadence, else None.  Pairs
        with an unseen word or IP are skipped."""
        model = snapshot.model
        v = len(model.word_index)
        ip_index = model.ip_index
        for ip, wr in zip(ips, model.word_rows(words)):
            if wr == v or ip not in ip_index:
                continue
            doc = self._counts.setdefault(ip, {})
            doc[int(wr)] = doc.get(int(wr), 0.0) + 1.0
        self._batches_seen += 1
        if self.every and self._batches_seen % self.every == 0 \
                and self._counts:
            return self.refresh()
        return None

    def _build_batch(self) -> "tuple[Batch, list[str]]":
        """Accumulated per-IP counts -> one padded micro-batch (io's
        Batch contract: ids padded with 0, counts and mask 0), B and L
        each padded to a multiple of 8."""
        docs = sorted(self._counts.items())
        ips = [ip for ip, _ in docs]
        b = len(docs)
        l = max(len(d) for _, d in docs)
        l_pad = max(8, -(-l // 8) * 8)
        b_pad = max(8, -(-b // 8) * 8)
        word_idx = np.zeros((b_pad, l_pad), np.int32)
        counts = np.zeros((b_pad, l_pad), np.float32)
        mask = np.zeros((b_pad,), np.float32)
        for i, (_, doc) in enumerate(docs):
            for j, (wid, c) in enumerate(sorted(doc.items())):
                word_idx[i, j] = wid
                counts[i, j] = c
            mask[i] = 1.0
        return Batch(word_idx=word_idx, counts=counts,
                     doc_index=np.arange(b_pad, dtype=np.int32),
                     doc_mask=mask), ips

    def refresh(self) -> ModelSnapshot:
        """One natural-gradient step over the accumulated evidence, then
        publish: new p for every word, new theta rows for the IPs that
        appeared (the others keep the day's posterior: a document's
        gamma is local state, absent documents have no update)."""
        t0 = time.perf_counter()
        batch, ips = self._build_batch()
        active = self.registry.active().model
        self.trainer.step(batch)
        gamma = self.trainer.infer_gamma([batch],
                                         num_docs=batch.word_idx.shape[0])
        p_vk = topic_probs_from_log_beta(self.trainer.log_beta())
        new_p = np.concatenate([p_vk, active.p[-1:]])  # keep the fallback row
        new_theta = np.array(active.theta, np.float64, copy=True)
        for i, ip in enumerate(ips):
            row = gamma[i]
            total = row.sum()
            if total > 0:
                new_theta[active.ip_index[ip]] = row / total
        model = ScoringModel(ip_index=active.ip_index, theta=new_theta,
                             word_index=active.word_index, p=new_p)
        self._counts.clear()
        self.refreshes += 1
        snap = self.registry.publish(
            model, source=f"refresh-step{self.trainer.step_count}")
        self.last_refresh_s = time.perf_counter() - t0
        return snap
