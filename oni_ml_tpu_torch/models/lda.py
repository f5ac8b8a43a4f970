"""Variational-EM LDA trainer (port of oni_ml_tpu/models/lda.py: the
alpha Newton, the random init, LDAResult, the engine choice, its gates,
the two EM drivers and the EM checkpoints) — the in-tree replacement
for the reference's MPI `oni-lda-c` engine (SURVEY.md §2.8,
ml_ops.sh:80).

Outputs follow the reference contract: `final.beta` (K x V log
p(w|z)), `final.gamma` (D x K), `final.other`, and `likelihood.dat`
(one "<likelihood>\\t<convergence>" line per EM iteration).  Per EM
iteration: the E-step over every batch, the M-step, the Newton alpha
update, then the float64 host convergence check |dll/ll| < em_tol.

Two E-step engine families (`resolve_estep_engine`: ONI_ML_TPU_ESTEP >
LDAConfig.estep_engine > on the card the measured crossover
(sparse_estep.engine_crossover), on the CPU the dense family):
- "sparse", the fused kernel csrc/sparse_estep.cu over the bucketed
  layout;
- "dense", the family whose gates pick its member: full-V dense
  (csrc/dense_estep.cu over the densified corpus, `_use_dense`), compact
  dense (the same kernel over each batch's own vocabulary,
  `_plan_compact`), else the per-batch dispatch (ops/estep.e_step:
  sparse, pallas — csrc/fixed_point_estep.cu — or xla).  The gates read
  the device the trainer was given; on the CPU they resolve as the JAX
  package's do off the TPU (per batch through xla).
Two drivers: the chunk driver (models/fused.py; fused_em_chunk > 1, the
default), which reads the host once per dispatch of up to
min(fused_em_chunk, host_sync_every) iterations, and the stepwise
driver (fused_em_chunk <= 1), which reads it once per EM iteration and
runs the dense family per batch.

With a checkpoint path and `LDAConfig.checkpoint_every` > 0, a fit
saves (beta, alpha, iteration, likelihoods) every that many EM
iterations (the chunk driver caps each dispatch at the next checkpoint
iteration), resumes from the file when it exists, and deletes it when
the fit completes.  A resumed fit starts its gammas fresh, as the JAX
package's does: with warm_start_gamma off it repeats the uninterrupted
fit.
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
from ..ops import dense_estep, estep, sparse_estep
from ..telemetry.spans import current_recorder, maybe_span, now_ns
from . import convert, fused


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
# EM checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, log_beta: np.ndarray, alpha: float,
                    em_iter: int, likelihoods: list) -> None:
    """Atomic in-training checkpoint: (beta, alpha, EM iteration,
    likelihood history), written to a temporary file and renamed.  The
    reference has no in-training resume: a crashed MPI run restarts
    from scratch (SURVEY §5.3-5.4)."""
    def write(tmp):
        with open(tmp, "wb") as f:  # a file object: savez adds no .npz
            np.savez(
                f,
                log_beta=np.asarray(log_beta),
                alpha=np.float64(alpha),
                em_iter=np.int64(em_iter),
                likelihoods=np.asarray(likelihoods, np.float64).reshape(-1, 2),
            )
    formats.atomic_write(path, write)


def load_checkpoint(path: str) -> dict:
    """Load a batch EM checkpoint, rejecting streaming-LDA checkpoints
    that can share the out_dir/checkpoint.npz name: new-format ones
    carry `lam`, and legacy ones hold a strictly positive lambda in
    `log_beta`, where real log-probabilities are <= 0."""
    with np.load(path) as z:
        if "lam" in z.files:
            raise ValueError(
                f"{path} is a streaming-LDA checkpoint; resume it with "
                "the online trainer or remove it"
            )
        log_beta = z["log_beta"]
        if log_beta.size and (log_beta > 0).all():
            raise ValueError(
                f"{path} holds strictly positive values — a legacy "
                "streaming-LDA checkpoint (lambda), not batch log_beta; "
                "resume it with the online trainer or remove it"
            )
        return {
            "log_beta": log_beta,
            "alpha": float(z["alpha"]),
            "em_iter": int(z["em_iter"]),
            "likelihoods": [tuple(row) for row in z["likelihoods"]],
        }


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
    # JAX LDAResult.plan: fused_em_chunk, host_sync_every, estep_engine
    # (and sparse_estep_l for the sparse engine), plus estep_crossover,
    # the crossover's record, where the crossover decided the engine.
    plan: dict = field(default_factory=dict)
    # What the driver did: its name, the engine family's member that ran
    # ("sparse", "dense", "compact" or "per_batch:<backend>"),
    # dispatches, host syncs, EM iterations enqueued after a device
    # stop, the batches trained.
    stats: dict = field(default_factory=dict)

    def save(self, directory: str, num_terms: "int | None" = None,
             include_likelihood: bool = True) -> None:
        """final.beta / final.gamma / final.other (and likelihood.dat
        unless the trainer already streamed it), each written to a
        temporary file and renamed, so a file under its contract name is
        complete."""
        k, v = self.log_beta.shape

        def publish(name, write):
            formats.atomic_write(os.path.join(directory, name), write)

        def write_likelihood(path):
            with open(path, "w") as f:
                for ll, conv in self.likelihoods:
                    formats.append_likelihood(f, ll, conv)

        publish("final.beta", lambda p: formats.write_beta(p, self.log_beta))
        publish("final.gamma", lambda p: formats.write_gamma(p, self.gamma))
        publish("final.other", lambda p: formats.write_other(
            p, k, num_terms or v, self.alpha))
        if include_likelihood:
            publish("likelihood.dat", write_likelihood)


def init_log_beta(generator: torch.Generator, k: int, v: int,
                  device: "str | torch.device" = "cpu") -> torch.Tensor:
    """`random` initialization (ml_ops.sh:80): uniform noise + 1/V,
    log-normalized per topic (lda-c random_initialize_ss).  Drawn on the
    CPU from `generator`, so a seed gives one beta on every device."""
    noise = torch.rand((k, v), generator=generator, dtype=torch.float32) + 1.0 / v
    return torch.log(noise / noise.sum(-1, keepdim=True)).to(device)


def _resolve_engine(corpus: Corpus, config: LDAConfig,
                    device) -> "tuple[str, str, dict | None]":
    """resolve_estep_engine's (engine, source) and the crossover's
    record where the crossover decided."""
    env = os.environ.get("ONI_ML_TPU_ESTEP", "")
    choice = config.estep_engine
    if choice not in ("auto", "dense", "sparse"):
        raise ValueError(f"LDAConfig.estep_engine={choice!r}: expected "
                         "'auto', 'dense' or 'sparse'")
    forced_sparse = env == "sparse" or (not env and choice == "sparse")
    if forced_sparse and config.dense_em == "on":
        raise ValueError("estep_engine='sparse' conflicts with "
                         "dense_em='on': pin one engine family, not both")
    if env:
        return ("sparse", "env", None) if env == "sparse" else (
            "dense", "env", None)
    if choice != "auto":
        return choice, "config", None
    dev = torch.device(device)
    if dev.type != "cuda" or config.dense_em == "on":
        # CPU runs keep the dense family (its gates resolve per batch
        # through xla there); dense_em="on" pins the family.
        return "dense", "default", None
    shapes = corpus.bucket_shapes(
        min_len=config.sparse_min_bucket_len, batch_cap=config.batch_size,
        pad_multiple=sparse_estep.pad_multiple_for())
    if not shapes or config.num_topics > sparse_estep.MAX_TOPICS:
        return "dense", "default", None
    b_dom, l_dom, _ = max(shapes, key=lambda s: s[2])
    cross = sparse_estep.engine_crossover(
        config.num_topics, corpus.num_terms, b_dom, l_dom, device=dev)
    return cross["engine"], cross["source"], cross


def resolve_estep_engine(corpus: Corpus, config: LDAConfig,
                         device="cuda") -> "tuple[str, str]":
    """The E-step engine family of a training run on `device` and where
    the choice came from: ("sparse" | "dense", source).  ONI_ML_TPU_ESTEP
    ("env": "sparse" picks the sparse engine, any other value the dense
    family, whose gates read it) beats an explicit LDAConfig.estep_engine
    ("config"), which beats, on the card, the measured dense-vs-sparse
    crossover at the corpus' dominant bucket shape (source "measured",
    or "plan" when the plan cache holds it, "env" when
    ONI_ML_TPU_ESTEP_ENGINE pins it), and on the CPU the dense family
    ("default"), as in the JAX package off the TPU.  The sparse kernel
    takes any bucket shape at K <= 64; above that the dense family is
    the default, and on the card its fit raises unless ONI_ML_TPU_ESTEP
    names "xla" (no kernel takes K; estep.resolve_backend)."""
    engine, source, _ = _resolve_engine(corpus, config, device)
    return engine, source


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


@dataclass
class _Run:
    """What both EM drivers carry for one fit: the iteration it starts
    after (0, or a checkpoint's), the last likelihood before it, the
    likelihood history, and where iterations are recorded."""

    start_it: int
    ll_prev: "float | None"
    likelihoods: list
    ll_file: object
    progress: "Callable[[int, float, float], None] | None"
    checkpoint_path: "str | None"


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
        checkpoint_path: "str | None" = None,
    ) -> LDAResult:
        """Run EM to convergence over `batches` (the bucketed layout's
        for the sparse engine, make_batches' for the dense family), with
        the engine family `engine`; the dense family's gates
        (_use_dense, _plan_compact) pick its member under the chunk
        driver, and the stepwise driver runs it per batch.

        With `checkpoint_path`, the state is saved every
        `config.checkpoint_every` EM iterations and, if the file exists,
        the fit resumes from it: at iteration min(its iteration,
        em_max_iters - 1), its likelihoods carried into likelihood.dat.
        The file is removed when the fit completes."""
        cfg = self.config
        k, v, dev = cfg.num_topics, self.num_terms, self.device
        if cfg.compute_dtype != "float32":
            raise ValueError("the port trains in float32 only")
        if engine not in ("sparse", "dense"):
            raise ValueError(f"unknown E-step engine {engine!r}")
        chunk, sync, plan = _resolve_em_plan(cfg)
        e_fn = sparse_estep.e_step if engine == "sparse" else estep.e_step
        member, compact = "sparse", None
        if engine == "dense":
            if chunk > 1 and self._use_dense(batches):
                member = "dense"
            else:
                compact = self._plan_compact(batches) if chunk > 1 else None
                member = "compact" if compact is not None else (
                    "per_batch:" + estep.resolve_backend(
                        "auto", *batches[0].word_idx.shape, k, dev))
        restored: list = []
        start_it = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            ckpt = load_checkpoint(checkpoint_path)
            if ckpt["log_beta"].shape != (k, v):
                raise ValueError(
                    f"checkpoint beta shape {ckpt['log_beta'].shape} does "
                    f"not match config ({k}, {v})")
            initial_log_beta = ckpt["log_beta"]
            initial_alpha = ckpt["alpha"]
            restored = ckpt["likelihoods"]
            # A run checkpointed at (or past) the last iteration re-runs
            # one: gamma comes from the final E-step.
            start_it = min(ckpt["em_iter"], cfg.em_max_iters - 1)
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
        likelihoods: list = list(restored[:start_it])
        gamma_out = np.zeros((num_docs, k), dtype=np.float64)
        ll_file = open(likelihood_file, "w") if likelihood_file else None
        if ll_file:
            for ll_r, conv_r in likelihoods:
                formats.append_likelihood(ll_file, ll_r, conv_r)
        run = _Run(start_it, likelihoods[-1][0] if likelihoods else None,
                   likelihoods, ll_file, progress, checkpoint_path)
        try:
            if chunk > 1:
                log_beta, alpha, it, stats = self._fused_loop(
                    batches, member, e_fn, compact, chunk, sync, log_beta,
                    alpha, num_docs, run, gamma_out)
            else:
                log_beta, alpha, it, stats = self._stepwise_loop(
                    batches, e_fn, log_beta, alpha, num_docs, run,
                    gamma_out)
        finally:
            if ll_file:
                ll_file.close()
        if checkpoint_path and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # the fit completed
        stats.update(member=member, batches=len(batches), batch_shapes=sorted(
            {tuple(int(n) for n in b.word_idx.shape) for b in batches}))
        log_beta_np, alpha_f, _ = convert.to_reference(
            convert.ModelState(log_beta, alpha))
        return LDAResult(log_beta=log_beta_np, gamma=gamma_out, alpha=alpha_f,
                         likelihoods=likelihoods, em_iters=it, plan=plan,
                         stats=stats)

    # -- the dense family's gates ------------------------------------------

    def _use_dense(self, batches) -> bool:
        """Whether the chunk driver runs the full-V dense E-step
        (ops/dense_estep.py over the corpus densified once).  Auto mode
        requires the run on the card, the dense kernel able to take K,
        and the densified corpus, the sparse stacks it is made from and
        the largest launch's scratch (fused.dense_scratch_bytes) under
        dense_hbm_budget.  ONI_ML_TPU_ESTEP=dense forces it on;
        compact, xla, pallas and sparse force it off."""
        cfg = self.config
        env = os.environ.get("ONI_ML_TPU_ESTEP", "")
        mode = {"dense": "on", "compact": "off", "xla": "off",
                "pallas": "off", "sparse": "off"}.get(env, cfg.dense_em)
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"LDAConfig.dense_em={mode!r}: expected "
                             "'auto', 'on', or 'off'")
        if mode == "off":
            return False
        # The card's kernel takes any V and block, so only K bounds it
        # (the JAX package's VMEM model does not apply); its scratch
        # counts against the budget below.
        # Where it cannot run the full-V corpus it cannot run a compact
        # one either, so a forced dense has no compact rescue here.
        feasible = 0 < cfg.num_topics <= dense_estep.MAX_TOPICS
        if mode == "on":
            if not feasible:
                raise ValueError(
                    f"dense E-step forced but K={cfg.num_topics} exceeds the "
                    f"dense kernel's {dense_estep.MAX_TOPICS} topics")
            return True
        if not (feasible and self.device.type == "cuda"):
            return False
        sparse_bytes = sum(b.word_idx.size * 8 for b in batches)
        width = dense_estep.padded_width(self.num_terms)
        scratch = fused.dense_scratch_bytes(
            {(b.word_idx.shape, width) for b in batches}, cfg.num_topics)
        return (fused.dense_groups_bytes(batches, self.num_terms)
                + sparse_bytes + scratch <= cfg.dense_hbm_budget)

    def _plan_compact(self, batches) -> "fused.CompactPlan | None":
        """The compact-vocab dense plan (fused.plan_compact) when the
        full-V dense E-step does not run: each batch remapped onto its
        own vocabulary, the dense kernel at that width.  Auto needs the
        run on the card and the compacted corpus, the largest group's
        sparse stacks and the largest launch's scratch under
        dense_hbm_budget; ONI_ML_TPU_ESTEP=compact
        forces it, any other env value stands it down."""
        cfg = self.config
        env = os.environ.get("ONI_ML_TPU_ESTEP", "")
        if env and env != "compact":
            return None
        mode = "on" if env == "compact" else cfg.dense_em
        if mode == "off" or (mode != "on" and self.device.type != "cuda"):
            return None
        plan = fused.plan_compact(batches, cfg.num_topics,
                                  wmajor=cfg.dense_wmajor)
        if plan is None:
            if mode == "on":
                raise ValueError(
                    "compact dense E-step forced but K="
                    f"{cfg.num_topics} exceeds the dense kernel's "
                    f"{dense_estep.MAX_TOPICS} topics")
            return None
        if mode == "on":
            return plan
        groups: dict = {}
        for b in batches:
            groups[b.word_idx.shape] = (groups.get(b.word_idx.shape, 0)
                                        + b.word_idx.size * 8)
        scratch = fused.dense_scratch_bytes(zip(sorted(groups), plan.widths),
                                            cfg.num_topics)
        if (plan.corpus_bytes + max(groups.values()) + scratch
                > cfg.dense_hbm_budget):
            return None
        return plan

    # -- EM drivers ---------------------------------------------------------

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

    def _maybe_checkpoint(self, run: "_Run", log_beta, alpha, it) -> None:
        every = self.config.checkpoint_every
        if run.checkpoint_path and every and it % every == 0:
            beta_host, alpha_f, _ = convert.to_reference(
                convert.ModelState(log_beta, alpha))
            save_checkpoint(run.checkpoint_path, beta_host, alpha_f, it,
                            run.likelihoods)

    @staticmethod
    def _scatter_gammas(gamma_out, batches, pairs) -> None:
        """Per-batch gammas [B, K] back to document order."""
        for bi, g in pairs:
            b = batches[bi]
            sel = b.doc_mask == 1
            gamma_out[b.doc_index[sel]] = g[sel]

    def _stepwise_loop(self, batches, e_fn, log_beta, alpha, num_docs, run,
                       gamma_out):
        """One E-step call per batch per EM iteration through `e_fn`
        (the sparse engine, or the dense family's per-batch dispatch);
        the likelihood reaches the host once per EM iteration for the
        float64 convergence check."""
        cfg = self.config
        k, v, dev = cfg.num_topics, self.num_terms, self.device
        dev_batches = []
        for b in batches:
            widx = torch.as_tensor(b.word_idx, dtype=torch.int32).to(dev)
            cnts = torch.as_tensor(b.counts, dtype=torch.float32).to(dev)
            mask = torch.as_tensor(b.doc_mask, dtype=torch.float32).to(dev)
            dev_batches.append((widx, cnts, mask,
                                sparse_estep.live_tokens(widx, cnts)))
        use_warm = cfg.warm_start_gamma and getattr(
            e_fn, "_oni_warm_capable", False)
        ll_prev = run.ll_prev
        gammas: list = []
        it = run.start_it
        warm_one = torch.tensor(1, dtype=torch.int32)
        # Roofline accounting (telemetry/roofline.py) only under an
        # active recorder: the iterations' fixed-point counts are read
        # at the host sync there, and nowhere else.
        instrumented = current_recorder() is not None
        vi_counts: list = []
        t_loop0 = now_ns()
        for it in range(run.start_it + 1, cfg.em_max_iters + 1):
            expb = sparse_estep.exp_beta_table(log_beta)
            alpha_const = estep.alpha_constant(alpha, k)
            total_ss = torch.zeros((v, k), dtype=torch.float32, device=dev)
            total_ll = torch.zeros((), dtype=torch.float32, device=dev)
            total_ass = torch.zeros((), dtype=torch.float32, device=dev)
            prev_gammas = gammas if use_warm else []
            gammas = []
            batch_vis = []
            for bi, (widx, cnts, mask, live) in enumerate(dev_batches):
                warm = {}
                if prev_gammas:
                    warm = {"gamma_prev": prev_gammas[bi], "warm": warm_one}
                res = e_fn(log_beta, alpha, widx, cnts, mask,
                           cfg.var_max_iters, cfg.var_tol, expb_vk=expb,
                           live=live, alpha_const=alpha_const, **warm)
                if instrumented:
                    batch_vis.append(torch.as_tensor(res.vi_iters))
                total_ss = total_ss + res.suff_stats
                total_ll = total_ll + res.likelihood
                total_ass = total_ass + res.alpha_ss
                gammas.append(res.gamma)
            log_beta = estep.m_step(total_ss)
            if cfg.estimate_alpha:
                alpha = update_alpha(total_ass, alpha, num_docs, k,
                                     max_iters=cfg.alpha_max_iters)
            # The stepwise driver's one host sync per EM iteration.
            with maybe_span("em.host_sync", it=it):
                ll = float(total_ll)
                if instrumented:
                    vi_counts.append(int(torch.stack(batch_vis).max()))
            conv = self._log_iteration(it, ll, ll_prev, run.likelihoods,
                                       run.ll_file, run.progress)
            self._maybe_checkpoint(run, log_beta, alpha, it)
            if ll_prev is not None and conv < cfg.em_tol:
                break
            ll_prev = ll
        if instrumented and vi_counts:
            self._emit_em_roofline(
                "em.e_step", (now_ns() - t_loop0) / 1e9, batches, num_docs,
                vi_counts, len(vi_counts) * len(batches))
        self._scatter_gammas(gamma_out, batches, (
            (bi, g.to("cpu", torch.float64).numpy())
            for bi, g in enumerate(gammas)))
        return log_beta, alpha, it, {"driver": "stepwise",
                                     "host_syncs": it - run.start_it}

    def _emit_em_roofline(self, phase, wall_s, batches, num_docs, vi_counts,
                          dispatches, **extra) -> None:
        """The EM loop's roofline record: the analytic cost of the
        iterations run (sparse_estep.em_iteration_cost at each
        iteration's fixed-point count, over the corpus' live entries),
        registered per dispatch and joined with the loop's wall.

        The count is an upper count of the work (`count: "upper"` in the
        record): the drivers read one fixed-point count per EM iteration,
        the largest over its batches and their doc blocks, and every live
        token is charged it, where the kernels run each doc block only
        for its own count.  The share it gives is at most that high."""
        from ..telemetry import roofline

        k = self.config.num_topics
        live = sum(int(np.count_nonzero(b.counts)) for b in batches)
        costs = [sparse_estep.em_iteration_cost(num_docs, live,
                                                self.num_terms, k, vi)
                 for vi in vi_counts]
        roofline.register_cost(
            phase, flops=sum(c["flops"] for c in costs) / dispatches,
            nbytes=sum(c["bytes"] for c in costs) / dispatches,
            shape=f"d{num_docs}.n{live}.v{self.num_terms}.k{k}",
            device=self.device)
        roofline.emit(phase, wall_s, dispatches=dispatches, count="upper",
                      em_iters=len(vi_counts),
                      dense_equiv_flops=sum(c["dense_equiv_flops"]
                                            for c in costs), **extra)

    def _fused_loop(self, batches, member, e_fn, compact, chunk, sync,
                    log_beta, alpha, num_docs, run, gamma_out):
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
        wmajor = cfg.dense_wmajor
        if member == "compact":
            wmajor = compact.wmajor
            groups = fused.compact_stack_batches(batches, self.device, compact)
        else:
            groups = fused.stack_batches(batches, self.device)
            if member == "dense":
                groups = fused.densify_groups(groups, self.num_terms,
                                              wmajor=wmajor)
        run_chunk = fused.make_chunk_runner(
            num_docs=num_docs, num_topics=k, num_terms=self.num_terms,
            chunk=chunk, var_max_iters=cfg.var_max_iters,
            var_tol=cfg.var_tol, em_tol=cfg.em_tol,
            estimate_alpha=cfg.estimate_alpha, e_step_fn=e_fn,
            dense_wmajor=wmajor, warm_start=cfg.warm_start_gamma,
            alpha_max_iters=cfg.alpha_max_iters,
        )
        ll_prev = run.ll_prev
        ll_prev_dev = torch.tensor(math.nan if ll_prev is None else ll_prev,
                                   dtype=torch.float32, device=self.device)
        gammas_prev = fused.initial_gammas(groups.arrays, k,
                                           dense_wmajor=wmajor)
        have_prev = False
        # host_sync_every bounds the iterations per dispatch whatever the
        # chunk, so likelihood.dat streams at least that often.
        per_dispatch = min(chunk, sync) if sync else chunk
        every = cfg.checkpoint_every if run.checkpoint_path else 0
        it = run.start_it
        dispatches = skipped = 0
        res = None
        instrumented = current_recorder() is not None
        vi_counts: list = []
        t_loop0 = now_ns()
        while it < cfg.em_max_iters:
            n = min(per_dispatch, cfg.em_max_iters - it)
            if every:
                # A dispatch ends at the next checkpoint iteration (the
                # runner takes its length at run time).
                n = min(n, (it // every + 1) * every - it)
            res = run_chunk(log_beta, alpha, ll_prev_dev, groups.arrays, n,
                            gammas_prev, have_prev)
            dispatches += 1
            log_beta, alpha, ll_prev_dev = res.log_beta, res.alpha, res.ll_prev
            gammas_prev = res.gammas
            # The host sync: the one point per dispatch where the host
            # waits for the device.
            with maybe_span("em.host_sync", it=it) as sp:
                steps = int(res.steps_done)
                lls = res.lls[:steps].to("cpu", torch.float64).numpy()
                if instrumented:
                    sp.annotate(steps=steps)
                    vi_counts.extend(res.vi_iters[:steps].tolist())
            have_prev = steps > 0
            skipped += n - steps
            host_conv = None
            for ll in lls:
                it += 1
                ll = float(ll)
                host_conv = self._log_iteration(it, ll, ll_prev,
                                                run.likelihoods, run.ll_file,
                                                run.progress)
                ll_prev = ll
            self._maybe_checkpoint(run, log_beta, alpha, it)
            if steps == 0:
                break
            # float64 conv decides; res.converged only ended the dispatch.
            if host_conv is not None and host_conv < cfg.em_tol:
                break
        if instrumented and vi_counts:
            self._emit_em_roofline(
                "em.run_chunk", (now_ns() - t_loop0) / 1e9, batches,
                num_docs, vi_counts, dispatches, chunk=chunk)
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
    `sparse_min_bucket_len`, at most `batch_size` docs per
    batch), the dense family on `make_batches` (buckets from
    `min_bucket_len`, the batch axis padded to a multiple of 8), as the
    JAX package does without a mesh.  Each batch's gammas scatter back
    to document order through `Batch.doc_index`.  `LDAResult.plan`
    records the engine and the driver's knobs with their sources (and
    the crossover's record where it decided); `stats["member"]` the
    family member that ran.  With `config.checkpoint_every` and an
    `out_dir`, the fit checkpoints to and resumes from
    `out_dir/checkpoint.npz`."""
    dev = resolve_device(device)
    engine, engine_src, crossover = _resolve_engine(corpus, config, dev)
    if engine == "sparse":
        if dev.type == "cuda" and config.num_topics > sparse_estep.MAX_TOPICS:
            raise ValueError(
                f"sparse E-step engine selected but K={config.num_topics} "
                f"exceeds the kernel's {sparse_estep.MAX_TOPICS} topics; "
                "use the dense family for this corpus")
        batches = list(corpus.bucketed_layout(
            min_len=config.sparse_min_bucket_len, batch_cap=config.batch_size,
            pad_multiple=sparse_estep.pad_multiple_for(),
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
        checkpoint_path=(os.path.join(out_dir, "checkpoint.npz")
                         if out_dir and config.checkpoint_every else None),
    )
    result.plan["estep_engine"] = {"value": engine, "source": engine_src}
    if crossover is not None:
        result.plan["estep_crossover"] = crossover
    if out_dir and save_final:
        result.save(out_dir, num_terms=corpus.num_terms, include_likelihood=False)
    return result
