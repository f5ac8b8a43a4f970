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

A `yield_hook` (a context-manager factory: serving/coscheduler.py's
CoScheduler.yield_hook) makes a fit preemptible at its dispatch grain:
the chunk driver enters one slot per chunk dispatch, the stepwise driver
one per EM iteration (its launches and M-step).  `WindowTrainer` is the
continuous service's refresh trainer: one per vocabulary capacity tier,
warm-started from the last published topics (`warm_start_log_beta`).

Distributed EM (`train_corpus(distributed=True)`, `ml_ops --multihost`,
`WindowTrainer(collective=)`): each rank process trains its own
contiguous document shards (parallel/shard_plan.py) through the
partial-stats runner (fused.make_partial_runner: the member's kernels,
no M-step), the per-shard statistics cross processes through the
collective (parallel/allreduce.py) between the E-step and the M-step,
and every rank runs the same M-step, alpha Newton and float64
convergence check from the reduced statistics (`_distributed_loop`).
The reduction is a fixed pairwise tree over the shard plan, so the model
is the same bytes on every rank and at every rank count.

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
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import LDAConfig
from ..device import resolve_device
from ..io import Batch, Corpus, formats, make_batches
from ..ops import dense_estep, estep, sparse_estep
from ..parallel import mesh as _mesh
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


def _resolve_engine(corpus: Corpus, config: LDAConfig, device,
                    shard_plan=None) -> "tuple[str, str, dict | None]":
    """resolve_estep_engine's (engine, source) and the crossover's
    record where the crossover decided.  With a `shard_plan` (distributed
    EM) the crossover keys on the shards' own bucket shapes, the shapes
    the kernels see."""
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
    pieces = ([corpus.shard(st, en) for st, en in shard_plan.bounds]
              if shard_plan is not None else [corpus])
    shapes = [shape for piece in pieces for shape in piece.bucket_shapes(
        min_len=config.sparse_min_bucket_len, batch_cap=config.batch_size,
        pad_multiple=sparse_estep.pad_multiple_for())]
    if not shapes or config.num_topics > sparse_estep.MAX_TOPICS:
        return "dense", "default", None
    b_dom, l_dom, _ = max(shapes, key=lambda s: s[2])
    cross = sparse_estep.engine_crossover(
        config.num_topics, corpus.num_terms, b_dom, l_dom, device=dev)
    return cross["engine"], cross["source"], cross


def _check_sparse_topics(engine: str, config: LDAConfig, device) -> None:
    """The sparse kernel takes at most MAX_TOPICS topics on the card."""
    if (engine == "sparse" and torch.device(device).type == "cuda"
            and config.num_topics > sparse_estep.MAX_TOPICS):
        raise ValueError(
            f"sparse E-step engine selected but K={config.num_topics} "
            f"exceeds the kernel's {sparse_estep.MAX_TOPICS} topics; "
            "use the dense family for this corpus")


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
    """Single-process EM over padded batches on one device.

    `yield_hook` (a context-manager factory, e.g.
    serving.CoScheduler.yield_hook) makes the fit preemptible: the chunk
    driver enters one slot per chunk dispatch, the stepwise driver one
    per EM iteration, so a scorer sharing the device wins the next slot
    at every boundary.  A slot covers the enqueue of its launches, not
    their execution on the card.

    `collective` with `shard_plan` and `shard_batches` (shard index ->
    that shard's batches, doc_index global) switch fit() onto the
    distributed driver (`_distributed_loop`), one slot per local E-step
    round; only rank 0 writes likelihood.dat and the checkpoint."""

    def __init__(self, config: LDAConfig, num_terms: int,
                 device: "str | torch.device | None" = None,
                 yield_hook: "Callable | None" = None,
                 collective=None, shard_plan=None, shard_batches=None):
        self.config = config
        self.num_terms = num_terms
        self.device = resolve_device(device)
        self.yield_hook = yield_hook
        self.collective = collective
        self.shard_plan = shard_plan
        self._shard_batches = shard_batches

    @property
    def _writer(self) -> bool:
        """Whether this process writes the fit's files (rank 0)."""
        return self.collective is None or self.collective.rank == 0

    def _slot(self):
        return self.yield_hook() if self.yield_hook is not None \
            else nullcontext()

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
        member: "str | None" = None,
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
        The file is removed when the fit completes.

        A distributed fit (shard batches set) takes its family `member`
        from the caller, decided once for every rank; the chunk and
        host-sync knobs do not apply there (the reduce is the host
        sync)."""
        cfg = self.config
        k, v, dev = cfg.num_topics, self.num_terms, self.device
        if cfg.compute_dtype != "float32":
            raise ValueError("the port trains in float32 only")
        if engine not in ("sparse", "dense"):
            raise ValueError(f"unknown E-step engine {engine!r}")
        distributed = self._shard_batches is not None
        if distributed:
            chunk, sync, plan = 0, 0, {}
            if member is None:
                raise ValueError("a distributed fit takes its member from "
                                 "the caller (decided on rank 0)")
            compact = None
        else:
            chunk, sync, plan = _resolve_em_plan(cfg)
            member, compact = self.resolve_member(engine, batches,
                                                  chunk > 1)
        e_fn = sparse_estep.e_step if engine == "sparse" else estep.e_step
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
        ll_file = (open(likelihood_file, "w")
                   if likelihood_file and self._writer else None)
        if ll_file:
            for ll_r, conv_r in likelihoods:
                formats.append_likelihood(ll_file, ll_r, conv_r)
        run = _Run(start_it, likelihoods[-1][0] if likelihoods else None,
                   likelihoods, ll_file, progress, checkpoint_path)
        try:
            if distributed:
                log_beta, alpha, it, stats = self._distributed_loop(
                    member, e_fn, log_beta, alpha, num_docs, run, gamma_out)
            elif chunk > 1:
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
        if (checkpoint_path and self._writer
                and os.path.exists(checkpoint_path)):
            os.remove(checkpoint_path)  # the fit completed
        stats.update(member=member, batches=len(batches), batch_shapes=sorted(
            {tuple(int(n) for n in b.word_idx.shape) for b in batches}))
        log_beta_np, alpha_f, _ = convert.to_reference(
            convert.ModelState(log_beta, alpha))
        return LDAResult(log_beta=log_beta_np, gamma=gamma_out, alpha=alpha_f,
                         likelihoods=likelihoods, em_iters=it, plan=plan,
                         stats=stats)

    # -- the dense family's gates ------------------------------------------

    def resolve_member(self, engine: str, batches, chunked: bool = True
                       ) -> "tuple[str, fused.CompactPlan | None]":
        """The engine family's member over `batches` and the compact plan
        where compact runs: "sparse"; for the dense family, "dense"
        (_use_dense) or "compact" (_plan_compact) under the chunk or
        distributed driver (`chunked`), else the per-batch dispatch as
        "per_batch:<backend>"."""
        if engine != "dense":
            return "sparse", None
        if chunked and self._use_dense(batches):
            return "dense", None
        compact = self._plan_compact(batches) if chunked else None
        if compact is not None:
            return "compact", compact
        return "per_batch:" + estep.resolve_backend(
            "auto", *batches[0].word_idx.shape, self.config.num_topics,
            self.device), None

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
        if (run.checkpoint_path and every and it % every == 0
                and self._writer):
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
            # One EM iteration is this driver's preemption grain: its
            # launches, M-step and alpha Newton are enqueued inside one
            # yield-hook slot; the host sync below is outside it.
            with self._slot():
                expb = sparse_estep.exp_beta_table(log_beta)
                alpha_const = estep.alpha_constant(alpha, k)
                total_ss = torch.zeros((v, k), dtype=torch.float32,
                                       device=dev)
                total_ll = torch.zeros((), dtype=torch.float32, device=dev)
                total_ass = torch.zeros((), dtype=torch.float32, device=dev)
                prev_gammas = gammas if use_warm else []
                gammas = []
                batch_vis = []
                for bi, (widx, cnts, mask, live) in enumerate(dev_batches):
                    warm = {}
                    if prev_gammas:
                        warm = {"gamma_prev": prev_gammas[bi],
                                "warm": warm_one}
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
            alpha_max_iters=cfg.alpha_max_iters, yield_hook=self.yield_hook,
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

    def _shard_groups(self, member: str, batches):
        """One shard's batches stacked on the device for `member`: token
        groups (sparse, per_batch), densified full-V groups (dense) or
        the shard's own compact plan (compact).  Returns (groups,
        W-major).  A shard with no documents has no groups."""
        wmajor = self.config.dense_wmajor
        if not batches:
            return fused.StackedGroups((), ()), wmajor
        if member == "compact":
            plan = fused.plan_compact(batches, self.config.num_topics,
                                      wmajor=wmajor)
            if plan is None:
                raise ValueError("compact dense E-step chosen but K="
                                 f"{self.config.num_topics} exceeds the "
                                 "dense kernel's topics")
            return (fused.compact_stack_batches(batches, self.device, plan),
                    plan.wmajor)
        groups = fused.stack_batches(batches, self.device)
        if member == "dense":
            groups = fused.densify_groups(groups, self.num_terms,
                                          wmajor=wmajor)
        return groups, wmajor

    def _distributed_loop(self, member, e_fn, log_beta, alpha, num_docs,
                          run, gamma_out):
        """Distributed EM: the local E-step over each owned document shard
        (fused.make_partial_runner: the member's kernels, no M-step), the
        per-shard partials through parallel/allreduce.reduce_partials
        (a fixed pairwise tree over the corpus-derived shard plan, so the
        reduced bytes are the same on every rank and at every rank
        count), then the same M-step, alpha Newton and float64
        convergence check on every rank.  One host sync per shard and EM
        iteration (its partials' transfer) and one reduce.  The final
        gammas merge across ranks by owned row blocks (exact placement),
        and rank parity of the model is checked, not assumed: each rank's
        beta digest is gathered and compared."""
        import hashlib

        from ..parallel.allreduce import reduce_partials

        cfg = self.config
        k, v, dev = cfg.num_topics, self.num_terms, self.device
        coll, plan = self.collective, self.shard_plan
        owned = sorted(self._shard_batches)
        shards = [self._shard_groups(member, self._shard_batches[s])
                  for s in owned]
        runners = {}
        for _, wm in shards:
            if wm not in runners:
                runners[wm] = fused.make_partial_runner(
                    num_topics=k, num_terms=v,
                    var_max_iters=cfg.var_max_iters, var_tol=cfg.var_tol,
                    e_step_fn=e_fn, dense_wmajor=wm)
        gammas_prev = [fused.initial_gammas(g.arrays, k, dense_wmajor=wm)
                       for g, wm in shards]
        have_prev = False
        # env > config; the gamma merge below always ships exact.
        ar_precision = (os.environ.get("ONI_ML_TPU_ALLREDUCE_PRECISION", "")
                        or cfg.allreduce_precision)
        zero_ss = np.zeros((v, k), np.float32)
        ar0 = dict(coll.stats)
        ll_prev = run.ll_prev
        it = run.start_it
        n_reduce = 0
        t_loop0 = now_ns()
        for it in range(run.start_it + 1, cfg.em_max_iters + 1):
            warm = int(cfg.warm_start_gamma and have_prev)
            # The local E-step round is this driver's preemption grain;
            # the transfers and the reduce that follow are outside it.
            outs = []
            with self._slot():
                for (groups, wm), g_prev in zip(shards, gammas_prev):
                    outs.append(runners[wm](log_beta, alpha, groups.arrays,
                                            g_prev, warm)
                                if groups.arrays else None)
            shard_stats, new_gammas = {}, []
            for si, out in zip(owned, outs):
                if out is None:
                    shard_stats[si] = {"suff_stats": zero_ss,
                                       "likelihood": np.float32(0.0),
                                       "alpha_ss": np.float32(0.0)}
                    new_gammas.append(())
                    continue
                ss, ll_s, ass, gammas, _ = out
                new_gammas.append(gammas)
                # The partials' transfer: this driver's host sync, one
                # per shard and EM iteration.
                with maybe_span("em.host_sync", it=it, shard=si):
                    shard_stats[si] = {
                        "suff_stats": ss.cpu().numpy(),
                        "likelihood": ll_s.cpu().numpy(),
                        "alpha_ss": ass.cpu().numpy(),
                    }
            gammas_prev, have_prev = new_gammas, True
            reduced = reduce_partials(coll, plan, shard_stats, f"em{it}",
                                      precision=ar_precision)
            n_reduce += 1
            log_beta = estep.m_step(torch.from_numpy(
                np.ascontiguousarray(reduced["suff_stats"],
                                     np.float32)).to(dev))
            if cfg.estimate_alpha:
                alpha = update_alpha(
                    torch.tensor(float(reduced["alpha_ss"]),
                                 dtype=torch.float32, device=dev),
                    alpha, num_docs, k, max_iters=cfg.alpha_max_iters)
            ll = float(np.float32(reduced["likelihood"]))
            conv = self._log_iteration(it, ll, ll_prev, run.likelihoods,
                                       run.ll_file, run.progress)
            self._maybe_checkpoint(run, log_beta, alpha, it)
            if ll_prev is not None and conv < cfg.em_tol:
                break
            ll_prev = ll
        if current_recorder() is not None and n_reduce:
            # The comms side of the roofline: measured allreduce bytes
            # and wall over the fit (interconnect traffic: no HBM share).
            from ..telemetry import roofline

            d = coll.stats
            roofline.emit(
                "em.allreduce", (now_ns() - t_loop0) / 1e9,
                dispatches=n_reduce,
                measured_bytes=float(d["bytes_out"] - ar0["bytes_out"]
                                     + d["bytes_in"] - ar0["bytes_in"]),
                transport=coll.transport, nprocs=coll.num_processes,
                allreduce_wall_s=round(d["wall_s"] - ar0["wall_s"], 6))
        # Owned shards' final posteriors to global doc ids, then merged
        # across ranks: each rank ships only its owned row blocks, placed
        # by shard bounds (no arithmetic, so exact and rank-identical).
        for si, (groups, _), gms in zip(owned, shards, gammas_prev):
            bs = self._shard_batches[si]
            for g_arr, slots in zip(gms, groups.batch_slots):
                g_host = g_arr.to("cpu", torch.float64).numpy()
                self._scatter_gammas(gamma_out, bs, (
                    (bi, g_host[j]) for j, bi in enumerate(slots)))
        if coll.num_processes > 1:
            payload = {str(s): gamma_out[plan.bounds[s][0]:plan.bounds[s][1]]
                       for s in owned}
            for g in coll.allgather_arrays(payload, "em_gamma",
                                           precision="f32"):
                for s, rows in g.items():
                    st, en = plan.bounds[int(s)]
                    gamma_out[st:en] = rows
        beta_host = log_beta.cpu().numpy()
        digest = hashlib.sha256(beta_host.tobytes()).hexdigest()
        digests = coll.allgather_obj([digest, float(alpha), it],
                                     "em_parity")
        if any(d != digests[0] for d in digests):
            raise RuntimeError(
                f"distributed EM rank parity violated: {digests}")
        return log_beta, alpha, it, {
            "driver": "distributed", "host_syncs": n_reduce * len(owned),
            "reduces": n_reduce, "shards": len(owned),
        }


def train_corpus(
    corpus: Corpus,
    config: LDAConfig,
    out_dir: "str | None" = None,
    progress: "Callable[[int, float, float], None] | None" = None,
    save_final: bool = True,
    initial_log_beta: "np.ndarray | None" = None,
    device: "str | torch.device | None" = None,
    distributed: "bool | None" = None,
    collective=None,
) -> LDAResult:
    """Corpus -> batches -> EM -> (optionally) the reference's output
    files in `out_dir` (likelihood.dat streams during the fit).

    `distributed` (None: whether this process joined a process group,
    parallel.initialize_distributed) trains by distributed EM
    (_train_corpus_distributed): every rank holds the same corpus and
    trains its own document shards, the statistics crossing processes
    through `collective` (default parallel.get_collective()).  Also
    runnable in one process, where it writes the same bytes as at any
    rank count.

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
    if distributed is None:
        distributed = _mesh.joined()
    if distributed:
        return _train_corpus_distributed(
            corpus, config, out_dir=out_dir, progress=progress,
            save_final=save_final, initial_log_beta=initial_log_beta,
            device=device, collective=collective)
    dev = resolve_device(device)
    engine, engine_src, crossover = _resolve_engine(corpus, config, dev)
    _check_sparse_topics(engine, config, dev)
    if engine == "sparse":
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


def _shard_batches(corpus: Corpus, config: LDAConfig, plan, shards,
                   engine: str, census_pow2: bool = False) -> dict:
    """{shard: its batches, doc_index global} for the `shards` of `plan`:
    each shard bucketed on its own (the sparse engine's bucketed layout,
    the dense family's make_batches), so a shard's batches do not depend
    on which rank trains it.  `census_pow2` is a window refresh's rule:
    make_batches padded to the full batch size for every engine (as the
    serial window refresh batches), each (B, L) group's count padded to
    a power of two (pad_batch_census_pow2)."""
    out = {}
    for s in shards:
        st, en = plan.bounds[s]
        piece = corpus.shard(st, en)
        if census_pow2:
            made = make_batches(piece, batch_size=config.batch_size,
                                min_bucket_len=config.min_bucket_len)
        elif engine == "sparse":
            made = list(piece.bucketed_layout(
                min_len=config.sparse_min_bucket_len,
                batch_cap=config.batch_size,
                pad_multiple=sparse_estep.pad_multiple_for()).batches)
        else:
            made = make_batches(piece, batch_size=config.batch_size,
                                min_bucket_len=config.min_bucket_len,
                                pad_multiple=8)
        made = [Batch(b.word_idx, b.counts, b.doc_index + st, b.doc_mask)
                for b in made]
        out[s] = pad_batch_census_pow2(made) if census_pow2 else made
    return out


def _decide_distributed(coll, corpus: Corpus, config: LDAConfig, dev,
                        plan, census_pow2: bool = False) -> list:
    """[engine, source, crossover record, member], decided on rank 0 and
    broadcast: ranks timing the crossover on one card can disagree, and a
    split choice would desync the reduce.  The member's gates read every
    shard's batches (the plan's, not the owned ones), so the choice does
    not depend on the rank count.  A failure on rank 0 is posted before
    it raises, so the other ranks stop at the broadcast."""
    decision = None
    if coll.rank == 0:
        try:
            engine, source, crossover = _resolve_engine(
                corpus, config, dev, shard_plan=plan)
            _check_sparse_topics(engine, config, dev)
            member = "sparse"
            if engine == "dense":
                every = _shard_batches(corpus, config, plan,
                                       range(plan.num_shards), engine,
                                       census_pow2)
                flat = [b for s in sorted(every) for b in every[s]]
                probe = LDATrainer(config, corpus.num_terms, device=dev)
                member = (probe.resolve_member(engine, flat)[0] if flat
                          else "per_batch:xla")
            decision = [engine, source, crossover, member]
        except BaseException as e:
            coll.fail(f"estep engine resolution: {e!r}")
            raise
    return coll.broadcast_obj(decision, "estep_engine")


def _train_corpus_distributed(
    corpus: Corpus,
    config: LDAConfig,
    out_dir: "str | None" = None,
    progress: "Callable[[int, float, float], None] | None" = None,
    save_final: bool = True,
    initial_log_beta: "np.ndarray | None" = None,
    device: "str | torch.device | None" = None,
    collective=None,
) -> LDAResult:
    """Distributed EM (port of the JAX package's): every rank holds the
    same corpus and the same shard plan (parallel/shard_plan.py) and
    trains its own contiguous document shards on its own device, each
    shard bucketed on its own; the [V, K] statistics, the alpha
    statistic and the likelihood cross processes through the collective,
    and the M-step, alpha Newton, convergence check and likelihood file
    run the same on every rank from the reduced statistics.  The result
    is the same bytes on every rank and at every rank count for one
    `em_shards`; rank 0 alone writes the files.  The engine and its
    member are decided on rank 0 and broadcast (_decide_distributed).  A
    rank's failure is posted for the others (PeerFailure there) before it
    raises."""
    from ..parallel.allreduce import PeerFailure, get_collective
    from ..parallel.shard_plan import plan_shards, resolve_em_shards

    coll = collective if collective is not None else get_collective()
    dev = resolve_device(device)
    plan = plan_shards(corpus.num_docs, coll.num_processes,
                       resolve_em_shards(config.em_shards,
                                         coll.num_processes))
    engine, engine_src, crossover, member = _decide_distributed(
        coll, corpus, config, dev, plan)
    shard_batches = _shard_batches(corpus, config, plan,
                                   plan.owned(coll.rank), engine)
    trainer = LDATrainer(config, num_terms=corpus.num_terms, device=dev,
                         collective=coll, shard_plan=plan,
                         shard_batches=shard_batches)
    rec = current_recorder()
    if rec is not None:
        # The shard plan this run trained under ({"kind": "shard_plan"}).
        rec.journal_record(plan.record(coll.rank))
    ar0 = dict(coll.stats)
    flat = [b for s in sorted(shard_batches) for b in shard_batches[s]]
    try:
        result = trainer.fit(
            flat, corpus.num_docs,
            likelihood_file=(os.path.join(out_dir, "likelihood.dat")
                             if out_dir else None),
            progress=progress, initial_log_beta=initial_log_beta,
            engine=engine, member=member,
            checkpoint_path=(os.path.join(out_dir, "checkpoint.npz")
                             if out_dir and config.checkpoint_every
                             else None),
        )
    except PeerFailure:
        raise          # relayed by the rank that failed
    except BaseException as e:
        # Peers blocked in the next reduce see the key within a slice.
        coll.fail(f"distributed fit rank {coll.rank}: {e!r}")
        raise
    result.plan["estep_engine"] = {"value": engine, "source": engine_src}
    if crossover is not None:
        result.plan["estep_crossover"] = crossover
    result.plan["em_shards"] = {
        "value": plan.num_shards,
        "source": ("env" if os.environ.get("ONI_ML_TPU_EM_SHARDS")
                   else "config" if config.em_shards else "default"),
    }
    d = coll.stats
    result.plan["allreduce"] = {
        "transport": coll.transport,
        "precision": coll.applied_precision(
            os.environ.get("ONI_ML_TPU_ALLREDUCE_PRECISION", "")
            or config.allreduce_precision),
        "nprocs": coll.num_processes,
        "ops": d["ops"] - ar0["ops"],
        "bytes_out": d["bytes_out"] - ar0["bytes_out"],
        "bytes_in": d["bytes_in"] - ar0["bytes_in"],
        "wall_s": round(d["wall_s"] - ar0["wall_s"], 6),
    }
    if out_dir and save_final and coll.rank == 0:
        result.save(out_dir, num_terms=corpus.num_terms,
                    include_likelihood=False)
    return result


# ---------------------------------------------------------------------------
# Window refreshes (the continuous service)
# ---------------------------------------------------------------------------


def warm_start_log_beta(topic_probs: np.ndarray,
                        num_terms: int) -> np.ndarray:
    """[V0, K] p(word|topic) from a previous fit -> a [K, num_terms]
    float64 log-beta EM init padded for vocabulary growth.

    A window holds words the previous one never saw; each gets one
    symmetric-prior quantum of mass (1/num_terms) and every topic
    renormalizes, so the previous topics carry over almost unchanged
    while unseen words start at small but trainable mass rather than the
    LOG_ZERO floor (a floored word could never grow back under the
    multiplicative fixed point).  A shrinking vocabulary is refused:
    window word ids are first-seen-stable, so a smaller V means the
    caller mixed id spaces."""
    p = np.asarray(topic_probs, np.float64)
    if p.ndim != 2:
        raise ValueError(f"topic_probs must be [V, K], got {p.shape}")
    v0, k = p.shape
    if num_terms < v0:
        raise ValueError(
            f"vocabulary cannot shrink: previous topics cover {v0} "
            f"words, new corpus has {num_terms} — window word ids are "
            "first-seen-stable, so a smaller V means mixed id spaces"
        )
    if not np.isfinite(p).all() or (p < 0).any():
        raise ValueError("topic_probs must be finite and nonnegative")
    prior = 1.0 / max(num_terms, 1)
    full = np.concatenate(
        [p, np.full((num_terms - v0, k), prior, np.float64)], axis=0
    )
    full = full / np.maximum(full.sum(axis=0, keepdims=True), 1e-300)
    beta = full.T  # [K, num_terms]
    return np.where(
        beta > 0, np.log(np.maximum(beta, 1e-300)), estep.LOG_ZERO
    )


class WindowTrainer:
    """Warm-startable EM for the continuous service's window refreshes
    (port of the JAX package's single-process WindowTrainer), on
    `device` (the card unless the caller asks for the CPU).

    One instance lives for a vocabulary capacity tier and is reused
    refresh after refresh.  Its E-step engine is resolved once, at the
    first fit (resolve_estep_engine's rule: ONI_ML_TPU_ESTEP >
    LDAConfig.estep_engine > on the card the crossover, which the plan
    store serves after its one measurement), and kept for the tier.
    Window batches pad to the full batch size (make_batches' default),
    so every refresh runs the same (B, L) family whatever the document
    count does.

    `fit()` seeds EM from the previous refresh's topics when given them
    (warm_start_log_beta pads for vocabulary growth, through
    convert.from_reference into float32); the float64 convergence check
    then stops after the few iterations the stream moved.  `yield_hook`
    threads through to the EM driver (LDATrainer).

    With a `collective` (parallel/allreduce.py) the refresh trains
    distributed: the warm-start seed is rank 0's, broadcast (only it
    holds the gated publish history), the documents shard by the plan
    (parallel/shard_plan.py), the local E-steps reduce through the
    collective, and each shard's (B, L) group counts pad to powers of two
    (`pad_batch_census_pow2`), so a wobbling document count keeps the
    stacked shapes.  The tier's engine and member are decided on rank 0
    at the tier's first fit and broadcast."""

    def __init__(self, config: LDAConfig, num_terms: int, *,
                 device: "str | torch.device | None" = None,
                 collective=None, yield_hook: "Callable | None" = None,
                 ) -> None:
        self.config = config
        self.num_terms = num_terms
        self.device = resolve_device(device)
        self.collective = collective
        self._trainer = LDATrainer(config, num_terms=num_terms,
                                   device=self.device, yield_hook=yield_hook,
                                   collective=collective)
        self.fits = 0
        # (engine, source, crossover record) of the tier's first fit, and
        # under a collective its member.
        self.engine: "tuple | None" = None
        self.member: "str | None" = None

    def fit(
        self,
        corpus: Corpus,
        *,
        topic_probs: "np.ndarray | None" = None,
        alpha: "float | None" = None,
        progress: "Callable | None" = None,
    ) -> LDAResult:
        """One window refresh: corpus -> LDAResult.  With `topic_probs`
        (the previous published [V_prev, K] matrix) EM warm-starts from
        them and `alpha` seeds the Newton; without, the random init.
        `result.plan` records `warm_start` and the tier's
        `estep_engine` (with `resolved`: whether this fit resolved it)
        and `estep_crossover` where the crossover decided."""
        cfg = self.config
        if corpus.num_terms != self.num_terms:
            raise ValueError(
                f"window corpus has V={corpus.num_terms} but this "
                f"trainer's capacity tier is {self.num_terms} — "
                "rebuild the trainer at the new tier (one trainer per "
                "tier, by design)"
            )
        coll = self.collective
        if coll is not None:
            # Rank 0's seed is the seed; the tag keys on the fit count,
            # which advances in lockstep.
            seed = {}
            if coll.rank == 0 and topic_probs is not None:
                seed = {"topic_probs": np.asarray(topic_probs, np.float64),
                        "alpha": np.float64(alpha)}
            seed = coll.broadcast_arrays(seed, f"window_seed{self.fits}")
            topic_probs = seed.get("topic_probs")
            alpha = float(seed["alpha"]) if "alpha" in seed else None
        warm = topic_probs is not None
        init_lb = (warm_start_log_beta(topic_probs, self.num_terms)
                   if warm else None)
        resolved = self.engine is None
        if coll is not None:
            batches, plan = self._shard_window(corpus, resolved)
        else:
            if resolved:
                self.engine = _resolve_engine(corpus, cfg, self.device)
            batches = make_batches(corpus, batch_size=cfg.batch_size,
                                   min_bucket_len=cfg.min_bucket_len)
        engine, source, crossover = self.engine
        _check_sparse_topics(engine, cfg, self.device)
        result = self._trainer.fit(
            batches, corpus.num_docs, progress=progress,
            initial_log_beta=init_lb,
            initial_alpha=alpha if warm else None, engine=engine,
            member=self.member,
        )
        self.fits += 1
        # `resolved`: this fit resolved the tier's engine (later fits
        # of the tier reuse it).
        result.plan["estep_engine"] = {"value": engine, "source": source,
                                       "resolved": resolved}
        if crossover is not None:
            result.plan["estep_crossover"] = crossover
        result.plan["warm_start"] = {"value": bool(warm), "source": "window"}
        if coll is not None:
            result.plan["em_shards"] = {"value": plan.num_shards,
                                        "source": "window"}
            result.plan["allreduce"] = {"transport": coll.transport,
                                        "nprocs": coll.num_processes}
        return result

    def _shard_window(self, corpus: Corpus, resolve: bool):
        """This refresh's shard plan and owned batches for the distributed
        driver (the plan follows the window's live document count; the
        trainer is reused).  At the tier's first fit (`resolve`) the
        engine and member are decided on rank 0 and broadcast.  Returns
        (the owned batches in shard order, the plan)."""
        from ..parallel.shard_plan import plan_shards, resolve_em_shards

        cfg, coll = self.config, self.collective
        plan = plan_shards(corpus.num_docs, coll.num_processes,
                           resolve_em_shards(cfg.em_shards,
                                             coll.num_processes))
        if resolve:
            engine, source, crossover, member = _decide_distributed(
                coll, corpus, cfg, self.device, plan, census_pow2=True)
            self.engine, self.member = (engine, source, crossover), member
        shard_batches = _shard_batches(corpus, cfg, plan,
                                       plan.owned(coll.rank),
                                       self.engine[0], census_pow2=True)
        self._trainer.shard_plan = plan
        self._trainer._shard_batches = shard_batches
        return ([b for s in sorted(shard_batches) for b in shard_batches[s]],
                plan)


def pad_batch_census_pow2(batches: "list[Batch]") -> "list[Batch]":
    """Pad each (B, L) group's count to a power of two with fully masked
    empty batches (port of the JAX package's).  A window refresh's
    vocabulary pads to pow2 tiers and its batches to the full batch
    size; the group count is the one shape left on the raw document
    census, and census tiers close it.  A pad batch is inert: doc_mask 0
    zeroes its statistics and likelihood, and the gamma scatter selects
    none of its rows."""
    groups: "dict[tuple, list[Batch]]" = {}
    order: list = []
    for b in batches:
        key = b.word_idx.shape
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(b)
    out: "list[Batch]" = []
    for key in order:
        grp = groups[key]
        target = 1
        while target < len(grp):
            target *= 2
        bb, ll = key
        for _ in range(target - len(grp)):
            grp.append(Batch(np.zeros((bb, ll), np.int32),
                             np.zeros((bb, ll), np.float32),
                             np.zeros((bb,), np.int32),
                             np.zeros((bb,), np.float32)))
        out.extend(grp)
    return out
