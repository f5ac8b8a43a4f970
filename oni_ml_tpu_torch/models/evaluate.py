"""Model-quality evaluation: held-out per-token log-likelihood (port of
oni_ml_tpu/models/evaluate.py).

The document-completion protocol of the online-LDA literature (Hoffman,
Blei, Bach, NIPS 2010): for each held-out document, condition on half
its tokens (even slots), infer the doc-topic posterior gamma from that
half only, then score the unseen half's tokens under the predictive
distribution

    p(w | w_obs) = sum_k  E[theta_k | gamma(w_obs)] * E[beta_kw]

and report  sum(count * log p) / sum(count)  over the held-out halves —
a per-token score comparable across corpus sizes, batch vs online
trainers, and hyperparameters (higher is better; exp(-score) is the
perplexity).  `hash_split` makes the runner's --eval-holdout split.

Works on any point-estimate topics in the final.beta contract (log
p(w|topic) rows, LOG_ZERO floor).  The JAX package runs this through its
XLA E-step (`estep.e_step(backend="xla")`), outside any Pallas kernel; the
port calls its own "xla" path, plain torch ops on the given device (the
card unless the caller asks for the CPU), whose [V, K] scatter on the
card is the sparse_scatter kernel every "xla" E-step uses.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..io import Batch
from ..ops import estep, sparse_estep


def _batch_held_out(log_beta, alpha, word_idx, counts, doc_mask,
                    var_max_iters, var_tol):
    """One padded batch -> (sum log p over held-out tokens, token count),
    device scalars.

    Token slots split deterministically by position parity: even slots
    are observed, odd slots held out.  Bucketed batches store one unique
    word per slot, so the split is over a doc's distinct words; padding
    slots carry count 0 and drop out of both halves."""
    pos = torch.arange(word_idx.shape[1], device=word_idx.device)
    obs = counts * (pos % 2 == 0)
    ho = counts * (pos % 2 == 1)
    live = (sparse_estep.live_tokens(word_idx, obs)
            if word_idx.device.type == "cuda" else None)
    res = estep.e_step(
        log_beta, alpha, word_idx, obs, doc_mask,
        var_max_iters=var_max_iters, var_tol=var_tol, backend="xla",
        live=live,
    )
    theta = res.gamma / res.gamma.sum(-1, keepdim=True)
    beta_bt = estep.gather_beta(log_beta, word_idx)  # [B, L, K] probabilities
    p = torch.einsum("bk,blk->bl", theta, beta_bt)
    # The floor must be representable in float32: on a true held-out
    # split a word can be absent from training entirely (every topic at
    # the LOG_ZERO floor -> p underflows to exactly 0), and a subnormal
    # floor flushes to 0, giving log(0)*0 = NaN for observed-half slots.
    # 1e-30 charges unseen words ~-69 nats.
    ll = (ho * torch.log(torch.clamp_min(p, 1e-30))).sum(-1) * doc_mask
    return ll.sum(), (ho.sum(-1) * doc_mask).sum()


def hash_split(doc_names: Sequence[str], frac: float,
               salt: str = "holdout") -> "tuple[np.ndarray, np.ndarray]":
    """Deterministic (train_idx, held_idx) split by document-name hash.

    Hashing the NAME (the IP in this pipeline) rather than the index
    keeps a document's membership stable across days and corpus
    orderings — the property that makes held-out scores comparable
    day-over-day.  crc32 is stable across processes and platforms
    (unlike Python's salted hash())."""
    import zlib

    if not 0.0 < frac < 1.0:
        raise ValueError(f"holdout fraction must be in (0, 1); got {frac}")
    cut = int(frac * 2**32)
    held = np.fromiter(
        (
            zlib.crc32(f"{salt}:{name}".encode("utf-8", "surrogateescape"))
            < cut
            for name in doc_names
        ),
        dtype=bool,
        count=len(doc_names),
    )
    idx = np.arange(len(doc_names))
    return idx[~held], idx[held]


def held_out_per_token_ll(
    log_beta: np.ndarray,
    alpha: float,
    batches: Sequence[Batch],
    var_max_iters: int = 20,
    var_tol: float = 1e-6,
    device: "str | torch.device | None" = None,
) -> float:
    """Held-out per-token log-likelihood of `batches` under the topics,
    on `device` (the card unless the caller asks for the CPU).

    `batches` must be documents the model was NOT trained on (or the
    score is optimistic); make them with io.make_batches over a held-out
    corpus split."""
    dev = resolve_device(device)
    log_beta = torch.as_tensor(np.asarray(log_beta, np.float32), device=dev)
    alpha_dev = torch.tensor(alpha, dtype=torch.float32, device=dev)
    total_ll = 0.0
    total_tok = 0.0
    for b in batches:
        ll, tok = _batch_held_out(
            log_beta, alpha_dev,
            torch.as_tensor(b.word_idx, device=dev),
            torch.as_tensor(b.counts, dtype=torch.float32, device=dev),
            torch.as_tensor(b.doc_mask, dtype=torch.float32, device=dev),
            var_max_iters, var_tol,
        )
        total_ll += float(ll)
        total_tok += float(tok)
    return total_ll / max(total_tok, 1.0)
