"""Variational-EM LDA trainer (port of oni_ml_tpu/models/lda.py: the
alpha Newton, the random init, LDAResult, engine choice and the two EM
drivers) — the in-tree replacement for the reference's MPI `oni-lda-c`
engine (SURVEY.md §2.8, ml_ops.sh:80).

Outputs follow the reference contract: `final.beta` (K x V log
p(w|z)), `final.gamma` (D x K), `final.other`, and `likelihood.dat`
(one "<likelihood>\\t<convergence>" line per EM iteration).  Per EM
iteration: the E-step over every batch, the M-step, the Newton alpha
update, then the float64 host convergence check |dll/ll| < em_tol.

Two E-step engines (`resolve_estep_engine`): "sparse", the fused
kernel csrc/sparse_estep.cu over the bucketed layout, and "dense",
csrc/dense_estep.cu over the corpus densified from `make_batches`.  Two
drivers: the chunk driver (models/fused.py; fused_em_chunk > 1, the
default), which reads the host once per dispatch of up to
min(fused_em_chunk, host_sync_every) iterations, and the stepwise
driver (fused_em_chunk <= 1, sparse only), which reads it once per EM
iteration.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import LDAConfig
from ..device import resolve_device
from ..io import Batch, Corpus, formats, make_batches
from ..ops import estep, sparse_estep
from . import convert, fused

# The card's engine when neither ONI_ML_TPU_ESTEP nor the config names
# one (the JAX package measures a dense-vs-sparse crossover there; that
# is not ported yet).
DEFAULT_ENGINE = "sparse"


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
    # Resolved knobs with their sources ({"value", "source"}), as the
    # JAX LDAResult.plan: fused_em_chunk, host_sync_every, estep_engine.
    plan: dict = field(default_factory=dict)
    # What the driver did: its name, dispatches, host syncs, EM
    # iterations enqueued after a device stop, the batches trained.
    stats: dict = field(default_factory=dict)

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


def resolve_estep_engine(config: LDAConfig) -> "tuple[str, str]":
    """The E-step engine of a training run and where the choice came
    from: ONI_ML_TPU_ESTEP ("env") beats LDAConfig.estep_engine
    ("config"), which beats the card's default, DEFAULT_ENGINE
    ("default") — the JAX package's precedence, without its measured
    crossover."""
    choice = config.estep_engine
    if choice not in ("auto", "dense", "sparse"):
        raise ValueError(f"LDAConfig.estep_engine={choice!r}: expected "
                         "'auto', 'dense' or 'sparse'")
    env = os.environ.get("ONI_ML_TPU_ESTEP", "")
    if env:
        if env not in ("dense", "sparse"):
            raise ValueError(f"ONI_ML_TPU_ESTEP={env!r}: the port runs "
                             "the 'dense' or 'sparse' engine")
        return env, "env"
    if choice != "auto":
        return choice, "config"
    return DEFAULT_ENGINE, "default"


def _resolve_em_plan(config: LDAConfig) -> "tuple[int, int, dict]":
    """(fused_em_chunk, host_sync_every, their plan record): a value
    that differs from the default is "config", else "default"."""
    if config.host_sync_every < 0:
        # min(chunk, negative) would request negative steps every
        # dispatch: a silent zero-iteration fit.
        raise ValueError(
            f"host_sync_every must be >= 0, got {config.host_sync_every}")
    default = LDAConfig()
    record = {}
    for name in ("fused_em_chunk", "host_sync_every"):
        value = getattr(config, name)
        record[name] = {"value": value, "source": (
            "config" if value != getattr(default, name) else "default")}
    return config.fused_em_chunk, config.host_sync_every, record


class LDATrainer:
    """Single-process EM over padded batches on one device."""

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
        engine: str = "sparse",
    ) -> LDAResult:
        """Run EM to convergence over `batches` (the bucketed layout's
        for the sparse engine, make_batches' for the dense one)."""
        cfg = self.config
        k, v, dev = cfg.num_topics, self.num_terms, self.device
        if cfg.compute_dtype != "float32":
            raise ValueError("the port trains in float32 only")
        if engine not in ("sparse", "dense"):
            raise ValueError(f"unknown E-step engine {engine!r}")
        chunk, sync, plan = _resolve_em_plan(cfg)
        if engine == "dense" and chunk <= 1:
            raise ValueError("the dense engine runs under the chunk driver; "
                             "set fused_em_chunk > 1")
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
        likelihoods: list = []
        gamma_out = np.zeros((num_docs, k), dtype=np.float64)
        ll_file = open(likelihood_file, "w") if likelihood_file else None
        try:
            if chunk > 1:
                log_beta, alpha, it, stats = self._fused_loop(
                    batches, engine, chunk, sync, log_beta, alpha, num_docs,
                    likelihoods, ll_file, progress, gamma_out)
            else:
                log_beta, alpha, it, stats = self._stepwise_loop(
                    batches, log_beta, alpha, num_docs, likelihoods, ll_file,
                    progress, gamma_out)
        finally:
            if ll_file:
                ll_file.close()
        stats.update(batches=len(batches), batch_shapes=sorted(
            {tuple(int(n) for n in b.word_idx.shape) for b in batches}))
        log_beta_np, alpha_f, _ = convert.to_reference(
            convert.ModelState(log_beta, alpha))
        return LDAResult(log_beta=log_beta_np, gamma=gamma_out, alpha=alpha_f,
                         likelihoods=likelihoods, em_iters=it, plan=plan,
                         stats=stats)

    @staticmethod
    def _log_iteration(it, ll, ll_prev, likelihoods, ll_file,
                       progress) -> float:
        """Record one EM iteration on the host; returns its float64
        convergence."""
        conv = abs((ll_prev - ll) / ll_prev) if ll_prev is not None else 1.0
        likelihoods.append((ll, conv))
        if ll_file:
            formats.append_likelihood(ll_file, ll, conv)
            ll_file.flush()
        if progress:
            progress(it, ll, conv)
        return conv

    @staticmethod
    def _scatter_gammas(gamma_out, batches, pairs) -> None:
        """Per-batch gammas [B, K] back to document order."""
        for bi, g in pairs:
            b = batches[bi]
            sel = b.doc_mask == 1
            gamma_out[b.doc_index[sel]] = g[sel]

    def _stepwise_loop(self, batches, log_beta, alpha, num_docs, likelihoods,
                       ll_file, progress, gamma_out):
        """One kernel launch per batch per EM iteration; the likelihood
        reaches the host once per EM iteration for the float64
        convergence check.  Sparse engine only."""
        cfg = self.config
        k, v, dev = cfg.num_topics, self.num_terms, self.device
        dev_batches = []
        for b in batches:
            widx = torch.as_tensor(b.word_idx, dtype=torch.int32).to(dev)
            cnts = torch.as_tensor(b.counts, dtype=torch.float32).to(dev)
            mask = torch.as_tensor(b.doc_mask, dtype=torch.float32).to(dev)
            dev_batches.append((widx, cnts, mask,
                                sparse_estep.live_tokens(widx, cnts)))
        ll_prev = None
        gammas: list = []
        it = 0
        warm_one = torch.tensor(1, dtype=torch.int32)
        for it in range(1, cfg.em_max_iters + 1):
            expb = sparse_estep.exp_beta_table(log_beta)
            alpha_const = estep.alpha_constant(alpha, k)
            total_ss = torch.zeros((v, k), dtype=torch.float32, device=dev)
            total_ll = torch.zeros((), dtype=torch.float32, device=dev)
            total_ass = torch.zeros((), dtype=torch.float32, device=dev)
            prev_gammas = gammas if cfg.warm_start_gamma else []
            gammas = []
            for bi, (widx, cnts, mask, live) in enumerate(dev_batches):
                warm = {}
                if prev_gammas:
                    warm = {"gamma_prev": prev_gammas[bi], "warm": warm_one}
                res = sparse_estep.e_step(
                    log_beta, alpha, widx, cnts, mask,
                    cfg.var_max_iters, cfg.var_tol, expb_vk=expb,
                    live=live, alpha_const=alpha_const, **warm,
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
            conv = self._log_iteration(it, ll, ll_prev, likelihoods, ll_file,
                                       progress)
            if ll_prev is not None and conv < cfg.em_tol:
                break
            ll_prev = ll
        self._scatter_gammas(gamma_out, batches, (
            (bi, g.to("cpu", torch.float64).numpy())
            for bi, g in enumerate(gammas)))
        return log_beta, alpha, it, {"driver": "stepwise", "host_syncs": it}

    def _fused_loop(self, batches, engine, chunk, sync, log_beta, alpha,
                    num_docs, likelihoods, ll_file, progress, gamma_out):
        """Device-resident EM (models/fused.py): up to
        min(chunk, host_sync_every) iterations per dispatch.  The device
        tests convergence in float32 to stop inside a dispatch; at each
        host sync the host re-derives conv in float64 (_log_iteration)
        and that value is authoritative — a device stop that float64
        disagrees with (the ~1-ulp |dll/ll| boundary) resumes, so the
        stop always matches the conv written to likelihood.dat and the
        stepwise driver's float64 semantics."""
        cfg = self.config
        k = cfg.num_topics
        groups = fused.stack_batches(batches, self.device)
        if engine == "dense":
            groups = fused.densify_groups(groups, self.num_terms,
                                          wmajor=cfg.dense_wmajor)
        run_chunk = fused.make_chunk_runner(
            num_docs=num_docs, num_topics=k, num_terms=self.num_terms,
            chunk=chunk, var_max_iters=cfg.var_max_iters,
            var_tol=cfg.var_tol, em_tol=cfg.em_tol,
            estimate_alpha=cfg.estimate_alpha, dense_wmajor=cfg.dense_wmajor,
            warm_start=cfg.warm_start_gamma,
            alpha_max_iters=cfg.alpha_max_iters,
        )
        ll_prev = None
        ll_prev_dev = torch.tensor(math.nan, device=self.device)
        gammas_prev = fused.initial_gammas(groups.arrays, k,
                                           dense_wmajor=cfg.dense_wmajor)
        have_prev = False
        # host_sync_every bounds the iterations per dispatch whatever the
        # chunk, so likelihood.dat streams at least that often.
        per_dispatch = min(chunk, sync) if sync else chunk
        it = dispatches = skipped = 0
        res = None
        while it < cfg.em_max_iters:
            n = min(per_dispatch, cfg.em_max_iters - it)
            res = run_chunk(log_beta, alpha, ll_prev_dev, groups.arrays, n,
                            gammas_prev, have_prev)
            dispatches += 1
            log_beta, alpha, ll_prev_dev = res.log_beta, res.alpha, res.ll_prev
            gammas_prev = res.gammas
            # The host sync: the one point per dispatch where the host
            # waits for the device.
            steps = int(res.steps_done)
            have_prev = steps > 0
            skipped += n - steps
            host_conv = None
            for ll in res.lls[:steps].to("cpu", torch.float64).numpy():
                it += 1
                ll = float(ll)
                host_conv = self._log_iteration(it, ll, ll_prev, likelihoods,
                                                ll_file, progress)
                ll_prev = ll
            if steps == 0:
                break
            # float64 conv decides; res.converged only ended the dispatch.
            if host_conv is not None and host_conv < cfg.em_tol:
                break
        if res is not None and int(res.steps_done) > 0:
            for g_arr, slots in zip(res.gammas, groups.batch_slots):
                g_host = g_arr.to("cpu", torch.float64).numpy()
                self._scatter_gammas(gamma_out, batches, (
                    (bi, g_host[j]) for j, bi in enumerate(slots)))
        return log_beta, alpha, it, {
            "driver": "fused", "dispatches": dispatches,
            "host_syncs": dispatches, "skipped_iterations": skipped,
        }


def train_corpus(
    corpus: Corpus,
    config: LDAConfig,
    out_dir: "str | None" = None,
    progress: "Callable[[int, float, float], None] | None" = None,
    save_final: bool = True,
    initial_log_beta: "np.ndarray | None" = None,
    device: "str | torch.device | None" = None,
) -> LDAResult:
    """Corpus -> batches -> EM -> (optionally) the reference's output
    files in `out_dir` (likelihood.dat streams during the fit).

    The sparse engine trains on `Corpus.bucketed_layout` (floored at
    `sparse_min_bucket_len`, at most `batch_size` docs per batch), the
    dense engine on `make_batches` (buckets from `min_bucket_len`, the
    batch axis padded to a multiple of 8), as the JAX package does
    without a mesh.  Each batch's gammas scatter back to document order
    through `Batch.doc_index`.  `LDAResult.plan` records the engine and
    the driver's knobs with their sources."""
    dev = resolve_device(device)
    engine, engine_src = resolve_estep_engine(config)
    if engine == "sparse":
        batches = list(corpus.bucketed_layout(
            min_len=config.sparse_min_bucket_len, batch_cap=config.batch_size,
            pad_multiple=sparse_estep.pad_multiple_for("f32"),
        ).batches)
    else:
        batches = make_batches(corpus, batch_size=config.batch_size,
                               min_bucket_len=config.min_bucket_len,
                               pad_multiple=8)
    trainer = LDATrainer(config, num_terms=corpus.num_terms, device=dev)
    result = trainer.fit(
        batches, corpus.num_docs,
        likelihood_file=(os.path.join(out_dir, "likelihood.dat")
                         if out_dir else None),
        progress=progress,
        initial_log_beta=initial_log_beta,
        engine=engine,
    )
    result.plan["estep_engine"] = {"value": engine, "source": engine_src}
    if out_dir and save_final:
        result.save(out_dir, num_terms=corpus.num_terms, include_likelihood=False)
    return result
