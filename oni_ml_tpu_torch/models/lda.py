"""Variational-EM LDA trainer (port of oni_ml_tpu/models/lda.py: the
alpha Newton, the random init, LDAResult and the stepwise driver over
the sparse engine) — the in-tree replacement for the reference's MPI
`oni-lda-c` engine (SURVEY.md §2.8, ml_ops.sh:80).

Outputs follow the reference contract: `final.beta` (K x V log
p(w|z)), `final.gamma` (D x K), `final.other`, and `likelihood.dat`
(one "<likelihood>\\t<convergence>" line per EM iteration).  Per EM
iteration: the fused sparse E-step over every batch of the bucketed
layout, the M-step, the Newton alpha update, then the float64 host
convergence check |dll/ll| < em_tol.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import LDAConfig
from ..device import resolve_device
from ..io import Batch, Corpus, formats
from ..ops import estep, sparse_estep
from . import convert


# ---------------------------------------------------------------------------
# Newton update for the symmetric Dirichlet alpha (lda-c opt_alpha)
# ---------------------------------------------------------------------------


def _alpha_objective_grads(log_a, ss, d: int, k: int):
    a = torch.exp(log_a)
    df = d * k * (torch.digamma(k * a) - torch.digamma(a)) + ss
    d2f = d * k * k * torch.polygamma(1, k * a) - d * k * torch.polygamma(1, a)
    return a, df, d2f


def update_alpha(alpha_ss, alpha_init, d: int, k: int,
                 max_iters: int = 100) -> torch.Tensor:
    """Maximize L(a) = D(lgam(Ka) - K lgam(a)) + a * ss with Newton
    steps in log space from the current alpha (lda-c's opt_alpha).

    max_iters <= 16 runs the unrolled form: every trip computes the
    step and a convergence mask (|df| <= 1e-5 freezes the state), with
    no host sync.  Larger caps run the loop form, which exits at the
    same |df| test and reads it on the host each trip.  The two compute
    the same value."""
    alpha_init = torch.as_tensor(alpha_init, dtype=torch.float32)
    ss = torch.as_tensor(alpha_ss, dtype=torch.float32,
                         device=alpha_init.device)
    log_a = torch.log(alpha_init)
    if max_iters <= 16:
        df_abs = torch.full_like(log_a, float("inf"))
        for _ in range(max_iters):
            a_it, df, d2f = _alpha_objective_grads(log_a, ss, d, k)
            step = log_a - df / (d2f * a_it + df)
            active = df_abs > 1e-5
            log_a = torch.where(active, step, log_a)
            df_abs = torch.where(active, df.abs(), df_abs)
    else:
        it, df_abs = 0, float("inf")
        while it < max_iters and df_abs > 1e-5:
            a_it, df, d2f = _alpha_objective_grads(log_a, ss, d, k)
            log_a = log_a - df / (d2f * a_it + df)
            df_abs = float(df.abs())
            it += 1
    a = torch.exp(log_a)
    # Guard divergence: keep the previous value (EM stays monotone-safe).
    bad = torch.isnan(a) | (a <= 0) | torch.isinf(a)
    return torch.where(bad, alpha_init, a)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclass
class LDAResult:
    log_beta: np.ndarray       # [K, V] float64
    gamma: np.ndarray          # [D, K] float64
    alpha: float
    likelihoods: list = field(default_factory=list)  # [(ll, conv)] per EM iter
    em_iters: int = 0

    def save(self, directory: str, num_terms: "int | None" = None,
             include_likelihood: bool = True) -> None:
        """final.beta / final.gamma / final.other (and likelihood.dat
        unless the trainer already streamed it)."""
        k, v = self.log_beta.shape
        formats.write_beta(os.path.join(directory, "final.beta"), self.log_beta)
        formats.write_gamma(os.path.join(directory, "final.gamma"), self.gamma)
        formats.write_other(
            os.path.join(directory, "final.other"), k, num_terms or v, self.alpha
        )
        if include_likelihood:
            with open(os.path.join(directory, "likelihood.dat"), "w") as f:
                for ll, conv in self.likelihoods:
                    formats.append_likelihood(f, ll, conv)


def init_log_beta(generator: torch.Generator, k: int, v: int,
                  device: "str | torch.device" = "cpu") -> torch.Tensor:
    """`random` initialization (ml_ops.sh:80): uniform noise + 1/V,
    log-normalized per topic (lda-c random_initialize_ss).  Drawn on the
    CPU from `generator`, so a seed gives one beta on every device."""
    noise = torch.rand((k, v), generator=generator, dtype=torch.float32) + 1.0 / v
    return torch.log(noise / noise.sum(-1, keepdim=True)).to(device)


class LDATrainer:
    """Single-process EM over bucketed batches, one kernel launch per
    batch per EM iteration; the likelihood reaches the host once per EM
    iteration for the float64 convergence check."""

    def __init__(self, config: LDAConfig, num_terms: int,
                 device: "str | torch.device | None" = None):
        self.config = config
        self.num_terms = num_terms
        self.device = resolve_device(device)

    def fit(
        self,
        batches: Sequence[Batch],
        num_docs: int,
        likelihood_file: "str | None" = None,
        progress: "Callable[[int, float, float], None] | None" = None,
        initial_log_beta: "np.ndarray | None" = None,
        initial_alpha: "float | None" = None,
    ) -> LDAResult:
        cfg = self.config
        k, v, dev = cfg.num_topics, self.num_terms, self.device
        if cfg.compute_dtype != "float32":
            raise ValueError("the port trains in float32 only")
        if initial_log_beta is not None:
            log_beta = convert.from_reference(initial_log_beta, 0.0,
                                              device=dev).log_beta
            if tuple(log_beta.shape) != (k, v):
                raise ValueError(f"initial beta has shape "
                                 f"{tuple(log_beta.shape)}, expected {(k, v)}")
        else:
            gen = torch.Generator().manual_seed(cfg.seed)
            log_beta = init_log_beta(gen, k, v, device=dev)
        alpha = torch.tensor(
            cfg.alpha_init if initial_alpha is None else initial_alpha,
            dtype=torch.float32, device=dev,
        )
        dev_batches = []
        for b in batches:
            widx = torch.as_tensor(b.word_idx, dtype=torch.int32).to(dev)
            cnts = torch.as_tensor(b.counts, dtype=torch.float32).to(dev)
            mask = torch.as_tensor(b.doc_mask, dtype=torch.float32).to(dev)
            dev_batches.append((widx, cnts, mask,
                                sparse_estep.live_tokens(widx, cnts)))
        likelihoods: list = []
        ll_file = open(likelihood_file, "w") if likelihood_file else None
        ll_prev = None
        gammas: list = []
        it = 0
        warm_one = torch.tensor(1, dtype=torch.int32)
        try:
            for it in range(1, cfg.em_max_iters + 1):
                expb = sparse_estep.exp_beta_table(log_beta)
                total_ss = torch.zeros((v, k), dtype=torch.float32, device=dev)
                total_ll = torch.zeros((), dtype=torch.float32, device=dev)
                total_ass = torch.zeros((), dtype=torch.float32, device=dev)
                prev_gammas = gammas if cfg.warm_start_gamma else []
                gammas = []
                for bi, (widx, cnts, mask, live) in enumerate(dev_batches):
                    warm = {}
                    if prev_gammas:
                        warm = {"gamma_prev": prev_gammas[bi],
                                "warm": warm_one}
                    res = sparse_estep.e_step(
                        log_beta, alpha, widx, cnts, mask,
                        cfg.var_max_iters, cfg.var_tol, expb_vk=expb,
                        live=live, **warm,
                    )
                    total_ss = total_ss + res.suff_stats
                    total_ll = total_ll + res.likelihood
                    total_ass = total_ass + res.alpha_ss
                    gammas.append(res.gamma)
                log_beta = estep.m_step(total_ss)
                if cfg.estimate_alpha:
                    alpha = update_alpha(total_ass, alpha, num_docs, k,
                                         max_iters=cfg.alpha_max_iters)
                ll = float(total_ll)
                conv = abs((ll_prev - ll) / ll_prev) if ll_prev is not None else 1.0
                likelihoods.append((ll, conv))
                if ll_file:
                    formats.append_likelihood(ll_file, ll, conv)
                    ll_file.flush()
                if progress:
                    progress(it, ll, conv)
                if ll_prev is not None and conv < cfg.em_tol:
                    break
                ll_prev = ll
        finally:
            if ll_file:
                ll_file.close()
        gamma_out = np.zeros((num_docs, k), dtype=np.float64)
        for g, b in zip(gammas, batches):
            g = g.to("cpu", torch.float64).numpy()
            sel = b.doc_mask == 1
            gamma_out[b.doc_index[sel]] = g[sel]
        log_beta_np, alpha_f, _ = convert.to_reference(
            convert.ModelState(log_beta, alpha))
        return LDAResult(log_beta=log_beta_np, gamma=gamma_out, alpha=alpha_f,
                         likelihoods=likelihoods, em_iters=it)


def train_corpus(
    corpus: Corpus,
    config: LDAConfig,
    out_dir: "str | None" = None,
    progress: "Callable[[int, float, float], None] | None" = None,
    save_final: bool = True,
    initial_log_beta: "np.ndarray | None" = None,
    device: "str | torch.device | None" = None,
) -> LDAResult:
    """Corpus -> bucketed layout -> EM -> (optionally) the reference's
    output files in `out_dir` (likelihood.dat streams during the fit).

    The sparse engine is the port's only engine: documents ride
    `Corpus.bucketed_layout` (floored at `sparse_min_bucket_len`, at
    most `batch_size` docs per batch), and each batch's gammas scatter
    back to document order through `Batch.doc_index`."""
    dev = resolve_device(device)
    layout = corpus.bucketed_layout(
        min_len=config.sparse_min_bucket_len, batch_cap=config.batch_size,
        pad_multiple=sparse_estep.pad_multiple_for("f32"),
    )
    trainer = LDATrainer(config, num_terms=corpus.num_terms, device=dev)
    result = trainer.fit(
        list(layout.batches), corpus.num_docs,
        likelihood_file=(os.path.join(out_dir, "likelihood.dat")
                         if out_dir else None),
        progress=progress,
        initial_log_beta=initial_log_beta,
    )
    if out_dir and save_final:
        result.save(out_dir, num_terms=corpus.num_terms, include_likelihood=False)
    return result
