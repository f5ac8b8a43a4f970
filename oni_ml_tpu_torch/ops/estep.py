"""Batched variational E-step and the M-step as plain PyTorch ops (port
of oni_ml_tpu/ops/estep.py, its XLA path).

Per document, the reference's fixed point (oni-lda-c, SURVEY.md §2.8)

    phinorm[b,l] = sum_k expEt[b,k] * beta[k, w[b,l]]
    gamma[b,k]   = alpha + expEt[b,k] * sum_l (c/phinorm)[b,l] * beta[k, w[b,l]]

runs vectorized over a padded [B, L] batch; padding tokens carry count 0
and padded docs are masked, so both are arithmetically inert.
Sufficient statistics scatter into [V, K] with `index_add_` (the JAX
package's segment-sum).

The stop rule here is decided over the whole batch; the fused sparse
kernel (ops/sparse_estep.py) decides it per block of documents, so the
two agree to var_tol, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .stop import fp_continue

# Matches lda-c's floor for log beta of zero-mass words.
LOG_ZERO = -100.0


class EStepResult(NamedTuple):
    gamma: torch.Tensor        # [B, K] variational doc-topic posteriors
    suff_stats: torch.Tensor   # [V, K] expected word-topic counts
    alpha_ss: torch.Tensor     # scalar: sum_d sum_k E[log theta_dk]
    likelihood: torch.Tensor   # scalar: sum over real docs of the ELBO
    vi_iters: torch.Tensor     # scalar: fixed-point iterations used


def e_log_dirichlet(param: torch.Tensor) -> torch.Tensor:
    """E_q[log x] = digamma(p_i) - digamma(sum p) over the last axis."""
    return torch.digamma(param) - torch.digamma(param.sum(-1, keepdim=True))


def check_warm_pair(gamma_prev, warm) -> None:
    """gamma_prev and warm travel together (0 = fresh init, nonzero =
    seed from gamma_prev)."""
    if gamma_prev is not None and warm is None:
        raise ValueError(
            "gamma_prev requires an explicit `warm` gate (0 = fresh "
            "init, nonzero = seed from gamma_prev)"
        )


def gather_beta(log_beta: torch.Tensor, word_idx: torch.Tensor) -> torch.Tensor:
    """[K, V] log beta + [B, L] word ids -> [B, L, K] probability slab."""
    return torch.exp(log_beta).t()[word_idx.long()]


def fixed_point(
    beta_bt: torch.Tensor,    # [B, L, K] gathered beta
    alpha: torch.Tensor,      # scalar
    counts: torch.Tensor,     # [B, L]
    doc_mask: torch.Tensor,   # [B]
    var_max_iters: int,
    var_tol: float,
    gamma_prev=None,          # [B, K] warm start (None = fresh init)
    warm=None,                # scalar gating gamma_prev
):
    """Per-document gamma fixed point.  Returns (gamma [B, K], iters)."""
    b, _, k = beta_bt.shape
    n_d = counts.sum(-1, keepdim=True)
    gamma = alpha + n_d / k * torch.ones((b, k), dtype=beta_bt.dtype,
                                         device=beta_bt.device)
    inv_scale = 1.0 / (alpha + n_d[:, 0] / k)
    if gamma_prev is not None:
        check_warm_pair(gamma_prev, warm)
        if int(warm) != 0:
            gamma = gamma_prev.to(beta_bt.dtype)
    it = 0
    delta = prev = float("inf")
    while bool(fp_continue(it, delta, prev, var_max_iters, var_tol)):
        exp_et = torch.exp(e_log_dirichlet(gamma))
        phinorm = torch.einsum("blk,bk->bl", beta_bt, exp_et) + 1e-30
        gamma_new = alpha + exp_et * torch.einsum(
            "bl,blk->bk", counts / phinorm, beta_bt
        )
        prev = delta
        delta = float(torch.max(
            (gamma_new - gamma).abs().mean(-1) * inv_scale * doc_mask
        ))
        gamma = gamma_new
        it += 1
    return gamma, torch.tensor(it, dtype=torch.int32)


def phi_weighted(beta_bt, gamma, counts, doc_mask):
    """(phi_c [B, L, K], phinorm [B, L]): phi * counts, masked."""
    exp_et = torch.exp(e_log_dirichlet(gamma))
    phinorm = torch.einsum("blk,bk->bl", beta_bt, exp_et) + 1e-30
    phi_c = beta_bt * (counts / phinorm)[..., None] * exp_et[:, None, :]
    return phi_c * doc_mask[:, None, None], phinorm


def suff_stats(phi_c: torch.Tensor, word_idx: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Scatter phi-weighted counts into [num_segments, K]."""
    b, l, k = phi_c.shape
    out = torch.zeros((num_segments, k), dtype=phi_c.dtype,
                      device=phi_c.device)
    out.index_add_(0, word_idx.reshape(b * l).long(), phi_c.reshape(b * l, k))
    return out


def batch_likelihood(gamma, phinorm, counts, alpha, doc_mask):
    """ELBO over real docs (collapsed form: sum_l c*log(phinorm) absorbs
    the token term and the z-entropy) + alpha suff stats."""
    tok_ll = (counts * torch.log(phinorm)).sum(-1) * doc_mask
    k = gamma.shape[-1]
    e_lt = e_log_dirichlet(gamma)
    doc_ll = (
        torch.lgamma(k * alpha)
        - k * torch.lgamma(alpha)
        + ((alpha - gamma) * e_lt).sum(-1)
        + torch.lgamma(gamma).sum(-1)
        - torch.lgamma(gamma.sum(-1))
    )
    likelihood = (doc_ll * doc_mask).sum() + tok_ll.sum()
    alpha_ss = (e_lt.sum(-1) * doc_mask).sum()
    return likelihood, alpha_ss


def e_step(
    log_beta: torch.Tensor,   # [K, V]
    alpha: torch.Tensor,      # scalar
    word_idx: torch.Tensor,   # [B, L] int
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    gamma_prev=None,
    warm=None,
) -> EStepResult:
    """The whole E-step for one batch, batch-wide stop rule."""
    v = log_beta.shape[1]
    alpha = torch.as_tensor(alpha, dtype=log_beta.dtype,
                            device=log_beta.device)
    beta_bt = gather_beta(log_beta, word_idx)
    gamma, iters = fixed_point(beta_bt, alpha, counts, doc_mask,
                               var_max_iters, var_tol,
                               gamma_prev=gamma_prev, warm=warm)
    phi_c, phinorm = phi_weighted(beta_bt, gamma, counts, doc_mask)
    suff = suff_stats(phi_c, word_idx, v)
    likelihood, alpha_ss = batch_likelihood(gamma, phinorm, counts, alpha,
                                            doc_mask)
    return EStepResult(gamma, suff, alpha_ss, likelihood, iters)


def m_step(suff_stats: torch.Tensor) -> torch.Tensor:
    """MLE beta from word-topic suff stats [V, K] -> [K, V] log-normalized
    per topic, with lda-c's -100 floor for zero mass."""
    ss = suff_stats.t()
    total = ss.sum(-1, keepdim=True)
    return torch.where(
        ss > 0, torch.log(ss) - torch.log(total),
        torch.full_like(ss, LOG_ZERO),
    )
