"""Batched variational E-step, the per-batch E-step dispatch and the
M-step (port of oni_ml_tpu/ops/estep.py).

Per document, the reference's fixed point (oni-lda-c, SURVEY.md §2.8)

    phinorm[b,l] = sum_k expEt[b,k] * beta[k, w[b,l]]
    gamma[b,k]   = alpha + expEt[b,k] * sum_l (c/phinorm)[b,l] * beta[k, w[b,l]]

runs vectorized over a padded [B, L] batch; padding tokens carry count 0
and padded docs are masked, so both are arithmetically inert.

`e_step(backend=...)` is the JAX package's per-batch dispatch: "auto"
takes the fused sparse kernel where it is feasible, else the fixed-point
kernel (ops/pallas_estep.py), else the plain "xla" path; "xla",
"pallas", "sparse" and "dense" force one, and ONI_ML_TPU_ESTEP overrides
"auto" ("dense"/"compact" there are driver hints that "auto" ignores).
The gates read the batch's device: on the card the sparse kernel takes
any L, so "auto" resolves to "sparse" there for K up to its 64 topics,
and raises above that (no kernel takes K; "xla" runs on the card only
when named); on the CPU no kernel is "available", so "auto" is "xla",
as in the JAX package off the TPU.  "xla" is the port of the XLA code: plain
torch ops on whatever device the batch is on, with the stop rule decided
over the whole batch (the kernels decide it per block of documents, so
the two agree to var_tol, not bit for bit).

The [V, K] suff-stats of the "xla" and "pallas" paths (`suff_stats`):
each phi·count contribution below the normal range is zero before it
is added, as XLA flushes it; on the CPU the sum is `index_add_` (the
JAX package's segment-sum), on the card the position-ordered
`sparse_scatter` kernel over the batch's live tokens, so the sums are
the same bits on every run (`index_add_` adds with atomics there).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .stop import fp_continue

# Matches lda-c's floor for log beta of zero-mass words.
LOG_ZERO = -100.0
# Smallest normal float32.
FLT_MIN = float(torch.finfo(torch.float32).tiny)


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
    return flush_subnormal(torch.exp(log_beta)).t()[word_idx.long()]


def fixed_point(
    beta_bt: torch.Tensor,    # [B, L, K] gathered beta
    alpha: torch.Tensor,      # scalar
    counts: torch.Tensor,     # [B, L]
    doc_mask: torch.Tensor,   # [B]
    var_max_iters: int,
    var_tol: float,
    gamma_prev=None,          # [B, K] warm start (None = fresh init)
    warm=None,                # scalar gating gamma_prev
    host_stop: "bool | None" = None,
):
    """Per-document gamma fixed point.  Returns (gamma [B, K], iters).

    The stop state lives on the device.  With `host_stop` (the default
    off the card) the loop reads it and leaves at the stop; without it
    (the default on the card) every one of the var_max_iters iterations
    is enqueued and a stopped one leaves the state as it was, so no host
    read happens inside the chunk driver's dispatch.  Both give the same
    bits."""
    b, _, k = beta_bt.shape
    n_d = counts.sum(-1, keepdim=True)
    gamma = alpha + n_d / k * torch.ones((b, k), dtype=beta_bt.dtype,
                                         device=beta_bt.device)
    inv_scale = 1.0 / (alpha + n_d[:, 0] / k)
    if gamma_prev is not None:
        check_warm_pair(gamma_prev, warm)
        if int(warm) != 0:
            gamma = gamma_prev.to(beta_bt.dtype)
    dev = beta_bt.device
    if host_stop is None:
        host_stop = dev.type != "cuda"
    it = torch.zeros((), dtype=torch.int32, device=dev)
    delta = prev = torch.full((), float("inf"), device=dev)
    for _ in range(max(0, var_max_iters)):
        go = fp_continue(it, delta, prev, var_max_iters, var_tol)
        if host_stop and not bool(go):
            break
        exp_et = torch.exp(e_log_dirichlet(gamma))
        phinorm = torch.einsum("blk,bk->bl", beta_bt, exp_et) + 1e-30
        gamma_new = alpha + exp_et * torch.einsum(
            "bl,blk->bk", counts / phinorm, beta_bt
        )
        new_delta = torch.max(
            (gamma_new - gamma).abs().mean(-1) * inv_scale * doc_mask
        )
        gamma = torch.where(go, gamma_new, gamma)
        prev = torch.where(go, delta, prev)
        delta = torch.where(go, new_delta, delta)
        it = it + go.to(torch.int32)
    return gamma, it


def phi_weighted(beta_bt, gamma, counts, doc_mask):
    """(phi_c [B, L, K], phinorm [B, L]): phi * counts, masked."""
    exp_et = torch.exp(e_log_dirichlet(gamma))
    phinorm = torch.einsum("blk,bk->bl", beta_bt, exp_et) + 1e-30
    phi_c = beta_bt * (counts / phinorm)[..., None] * exp_et[:, None, :]
    return phi_c * doc_mask[:, None, None], phinorm


def suff_stats(phi_c: torch.Tensor, word_idx: torch.Tensor,
               num_segments: int, live=None, stop=None) -> torch.Tensor:
    """Scatter phi-weighted counts [B, L, K] into [num_segments, K],
    each contribution below the normal range flushed to zero first (the
    XLA semantics).  CPU: `index_add_` in position order.  CUDA: the
    sparse_scatter kernel over `live` (sparse_estep.live_tokens of the
    batch), which adds each word's rows in the same order without
    atomics; `stop` is the chunk driver's flag."""
    phi_c = flush_subnormal(phi_c)
    if phi_c.device.type == "cuda":
        from . import sparse_estep

        if live is None:
            raise ValueError("the card's scatter needs the batch's "
                             "live-token plan (sparse_estep.live_tokens)")
        return sparse_estep.scatter_live(phi_c.contiguous(), live,
                                         num_segments, stop=stop)
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


def batch_tail(beta_bt, gamma, alpha, word_idx, counts, doc_mask,
               num_terms, iters, live=None, stop=None) -> EStepResult:
    """The single-pass terms after the fixed point, shared by the "xla"
    and "pallas" paths: phi_c, the [V, K] scatter, the ELBO."""
    phi_c, phinorm = phi_weighted(beta_bt, gamma, counts, doc_mask)
    suff = suff_stats(phi_c, word_idx, num_terms, live=live, stop=stop)
    likelihood, alpha_ss = batch_likelihood(gamma, phinorm, counts, alpha,
                                            doc_mask)
    return EStepResult(gamma, suff, alpha_ss, likelihood, iters)


BACKENDS = ("auto", "xla", "pallas", "sparse", "dense")


def resolve_backend(backend: str, b: int, l: int, k: int, device) -> str:
    """The concrete path `e_step(backend=...)` takes for a [B, L] batch
    of K topics on `device` (see the module docstring)."""
    if backend == "auto":
        env = os.environ.get("ONI_ML_TPU_ESTEP") or "auto"
        backend = "auto" if env in ("dense", "compact") else env
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown E-step backend {backend!r} (set via ONI_ML_TPU_ESTEP "
            "or the backend= argument); expected auto, xla, pallas, "
            "sparse, or dense"
        )
    if backend != "auto":
        return backend
    from . import pallas_estep, sparse_estep

    if sparse_estep.available(b, l, k, device):
        return "sparse"
    if pallas_estep.available(b, l, k, device):
        return "pallas"
    if torch.device(device).type == "cuda":
        # On the card "auto" never gives way to plain ops: xla runs
        # there only when the argument or the env names it.
        raise ValueError(
            f"no E-step kernel takes K={k} topics on the card (the "
            f"kernels are compiled for at most {sparse_estep.MAX_TOPICS}); "
            "set backend='xla' or ONI_ML_TPU_ESTEP=xla to train through "
            "plain torch ops")
    return "xla"


def e_step(
    log_beta: torch.Tensor,   # [K, V]
    alpha: torch.Tensor,      # scalar
    word_idx: torch.Tensor,   # [B, L] int
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    backend: str = "auto",
    gamma_prev=None,
    warm=None,
    expb_vk: "torch.Tensor | None" = None,
    live=None,
    stop: "torch.Tensor | None" = None,
    alpha_const: "torch.Tensor | None" = None,
    block: "int | None" = None,
) -> EStepResult:
    """The whole E-step of one batch through the path `backend` names
    (resolve_backend).  `block` is the kernels' doc block (default:
    their pick for the card); the "xla" path has none.  The drivers pass what they share across the
    batches of an EM iteration: `expb_vk` (sparse_estep.exp_beta_table),
    the batch's `live` plan (sparse_estep.live_tokens), `stop` under the
    chunk driver and `alpha_const` (alpha_constant); a path takes the
    ones it uses.  "dense" densifies the batch per call (the drivers
    that own the batches densify once instead: models/fused.py)."""
    check_warm_pair(gamma_prev, warm)
    b, l = word_idx.shape
    k, v = log_beta.shape
    path = resolve_backend(backend, b, l, k, word_idx.device)
    if path == "dense":
        from . import dense_estep

        dense = dense_estep.densify(word_idx, counts, v)
        return dense_estep.e_step_dense(
            log_beta, alpha, dense, doc_mask, var_max_iters, var_tol,
            block=block, gamma_prev=gamma_prev, warm=warm, stop=stop,
            alpha_const=alpha_const, cells=l)
    if path == "sparse":
        from . import sparse_estep

        return sparse_estep.e_step(
            log_beta, alpha, word_idx, counts, doc_mask, var_max_iters,
            var_tol, gamma_prev=gamma_prev, warm=warm, block=block,
            expb_vk=expb_vk, live=live, stop=stop, alpha_const=alpha_const)
    if path == "pallas":
        from . import pallas_estep

        return pallas_estep.e_step(
            log_beta, alpha, word_idx, counts, doc_mask, var_max_iters,
            var_tol, gamma_prev=gamma_prev, warm=warm, block=block,
            expb_vk=expb_vk, live=live, stop=stop)
    alpha = torch.as_tensor(alpha, dtype=log_beta.dtype,
                            device=log_beta.device)
    beta_bt = (gather_beta(log_beta, word_idx) if expb_vk is None
               else expb_vk[word_idx.long()])
    gamma, iters = fixed_point(beta_bt, alpha, counts, doc_mask,
                               var_max_iters, var_tol,
                               gamma_prev=gamma_prev, warm=warm)
    return batch_tail(beta_bt, gamma, alpha, word_idx, counts, doc_mask, v,
                      iters, live=live, stop=stop)


# Takes gamma_prev/warm (the drivers warm-start it; a custom e_step_fn
# without this mark stays fresh).
e_step._oni_warm_capable = True


def alpha_constant(alpha: torch.Tensor, k: int) -> torch.Tensor:
    """The per-document alpha-prior term of the ELBO,
    lgamma(K alpha) - K lgamma(alpha).  The EM drivers compute it once
    per EM iteration and hand it to every batch's E-step."""
    return torch.lgamma(k * alpha) - k * torch.lgamma(alpha)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals to zero, as XLA treats them on the CPU and the
    TPU (flush-to-zero, denormals-are-zero).  For non-negative x: the
    word-topic masses and exp(log beta) tables the E-steps consume."""
    return torch.where(x < FLT_MIN, torch.zeros_like(x), x)


def m_step(suff_stats: torch.Tensor) -> torch.Tensor:
    """MLE beta from word-topic suff stats [V, K] -> [K, V] log-normalized
    per topic, with lda-c's -100 floor for zero mass.  A subnormal mass
    counts as zero mass (flush_subnormal), as in the JAX package."""
    ss = flush_subnormal(suff_stats.t())
    total = ss.sum(-1, keepdim=True)
    return torch.where(
        ss > 0, torch.log(ss) - torch.log(total),
        torch.full_like(ss, LOG_ZERO),
    )
