"""Online (streaming) variational LDA on one device (port of
oni_ml_tpu/models/online_lda.py, single-process; `ml_ops --online`).

Stochastic variational inference (Hoffman, Blei, Bach, "Online Learning
for Latent Dirichlet Allocation", NIPS 2010): each micro-batch takes one
natural-gradient step on the variational Dirichlet posterior lambda
[K, V] over the topics:

    rho_t   = (tau0 + t)^(-kappa)
    lambda <- (1 - rho_t) lambda + rho_t (eta + D/|S_t| * suff_stats_t)

The per-document local step is the batch E-step fed E_q[log beta]
(digamma form), so it runs the port's kernels: per micro-batch the dense
E-step (csrc/dense_estep.cu over the densified micro-batch) where
`_use_dense` admits it, else the per-batch dispatch `ops/estep.e_step`
(on the card the sparse kernel, or the fixed point under
ONI_ML_TPU_ESTEP=pallas).  On the CPU both run their plain versions.

lambda stays on the device across the stream; each step moves only its
micro-batch's tokens there, and a step's likelihood stays a device
scalar (StreamStepInfo.likelihood) until someone reads it.

Two rho schedules, as in the JAX package: `step()` evaluates rho in
float64 on the host; `step_many` runs each same-shape run of
micro-batches with rho evaluated in float32 on the device from a
float32 step counter (the JAX scan's schedule), so no host value enters
between its steps.  The schedules agree to ~1e-7 relative.

Per-shape state: the JAX trainer keeps one compiled program per
(B, L) in a bounded LRU (`_UPDATE_CACHE_MAX`).  This trainer compiles
nothing and caches nothing per shape: each step calls the kernels'
wrappers directly, whose launch geometry is a pure function of the
shape.

`from_topic_probs` seeds the stream from a published model's
p(word|topic) instead of the Gamma draw: the serving refresh loop's
entry point (serving/refresh.py).

Distributed streaming (`distributed=`/`collective=`, `ml_ops --online
--multihost`): each rank runs the local step on its contiguous row slice
of every micro-batch, the suff-stats and likelihood cross processes
through the collective (parallel/allreduce.py, a fixed pairwise tree in
rank order), and every rank blends lambda from the reduced statistics,
so lambda is the same on every rank.  The step's `batch_docs` is the
global real-document count, so the update equals the one-process step up
to the reduction order.  Distributed streams take the per-step path.

Left out here, waiting for its ROADMAP item: the data-parallel mesh.  A
`compute_dtype` other than float32 raises (bf16 storage is its own
ROADMAP item).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..config import OnlineLDAConfig
from ..device import resolve_device
from ..io import Batch, formats
from ..ops import dense_estep, estep, sparse_estep
from ..ops.estep import e_log_dirichlet as expected_log_beta
from ..parallel import mesh as _mesh
from . import convert
from .lda import LDAResult


def save_stream_checkpoint(path: str, lam: np.ndarray, alpha: float,
                           step: int, history: "list[tuple[float, float]]",
                           ) -> None:
    """Atomic streaming checkpoint with SVI-native field names: `lam`
    (the variational Dirichlet posterior over topics — NOT a log beta),
    `step` (micro-batch count), `history` rows of (likelihood, rho).
    Early revisions of the JAX package smuggled these through the batch
    checkpoint's log_beta/em_iter/likelihoods fields;
    load_stream_checkpoint still reads that layout."""
    def write(tmp):
        with open(tmp, "wb") as f:  # a file object: savez adds no .npz
            np.savez(
                f,
                lam=np.asarray(lam),
                alpha=np.float64(alpha),
                step=np.int64(step),
                history=np.asarray(history, np.float64).reshape(-1, 2),
            )
    formats.atomic_write(path, write)


def load_stream_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        if "lam" in z.files:
            return {
                "lam": z["lam"],
                "alpha": float(z["alpha"]),
                "step": int(z["step"]),
                "history": [tuple(row) for row in z["history"]],
            }
        # Legacy layout (batch-checkpoint field names smuggling lambda).
        # A real batch EM checkpoint shares these field names AND the
        # (K, V) shape but holds log-probabilities (all <= 0), while a
        # variational lambda is strictly positive Dirichlet parameters —
        # reject it instead of streaming NaN topics out of digamma.
        lam = z["log_beta"]
        if not (lam > 0).all():
            raise ValueError(
                f"{path} is a batch EM checkpoint (log_beta has "
                "non-positive entries), not a streaming-LDA checkpoint; "
                "resume it with the batch trainer or remove it"
            )
        return {
            "lam": lam,
            "alpha": float(z["alpha"]),
            "step": int(z["em_iter"]),
            "history": [tuple(row) for row in z["likelihoods"]],
        }


def seeded_lam(config: OnlineLDAConfig, num_terms: int) -> torch.Tensor:
    """Hoffman's init: lambda ~ Gamma(100, 1/100) per entry, drawn on the
    CPU from a torch.Generator seeded with config.seed (so a seed gives
    one lambda on every device).  The JAX package draws it with threefry,
    which a torch seed cannot reproduce: parity tests pass the JAX draw
    as `initial_lam` (models/convert.py)."""
    gen = torch.Generator().manual_seed(config.seed)
    shape = torch.full((config.num_topics, num_terms), 100.0,
                       dtype=torch.float32)
    return torch._standard_gamma(shape, generator=gen) / 100.0


@dataclass
class StreamStepInfo:
    step: int
    rho: float
    batch_docs: int
    # ELBO local term over the micro-batch.  Kept as a DEVICE scalar so
    # the streaming hot path never waits on the card between
    # micro-batches; float(info.likelihood) reads it on demand.
    likelihood: torch.Tensor
    tokens: int

    @property
    def per_token_ll(self) -> float:
        return float(self.likelihood) / max(self.tokens, 1)


class OnlineLDATrainer:
    """Streaming natural-gradient LDA over padded micro-batches on one
    device.

    ``total_docs`` is the population size D the stream is drawn from (for
    the reference pipelines: the expected number of active IPs in the
    window being modeled).  It scales each micro-batch's sufficient
    statistics to a full-corpus estimate; a too-small D under-weights new
    evidence but never destabilizes the update.

    ``initial_lam`` [K, V]
    (convert.lam_from_reference) replaces the seeded Gamma draw (a
    checkpoint found at ``checkpoint_path`` wins over both).

    ``distributed`` (None: whether this process joined a process group,
    parallel.initialize_distributed) row-splits every
    micro-batch across the ranks of ``collective`` (default
    parallel.get_collective()); only rank 0 writes the stream
    checkpoint."""

    def __init__(
        self,
        config: OnlineLDAConfig,
        num_terms: int,
        total_docs: int,
        checkpoint_path: "str | None" = None,
        initial_lam=None,
        device: "str | torch.device | None" = None,
        collective=None,
        distributed: "bool | None" = None,
    ):
        if config.compute_dtype != "float32":
            raise ValueError(
                f"OnlineLDAConfig.compute_dtype={config.compute_dtype!r}: "
                "the port trains in float32 only (bf16 storage is ROADMAP "
                "Queue 2 item 5)")
        if config.dense_em not in ("auto", "on", "off"):
            raise ValueError(
                f"OnlineLDAConfig.dense_em={config.dense_em!r}: expected "
                "'auto', 'on', or 'off'"
            )
        self.config = config
        self.num_terms = num_terms
        self.total_docs = total_docs
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self.step_count = 0
        self.history: "list[StreamStepInfo]" = []
        if distributed is None:
            distributed = _mesh.joined()
        self._coll = None
        if distributed:
            from ..parallel.allreduce import get_collective

            self._coll = (collective if collective is not None
                          else get_collective())
        dev = self.device
        lam = (seeded_lam(config, num_terms) if initial_lam is None
               else convert.lam_from_reference(initial_lam))
        if tuple(lam.shape) != (config.num_topics, num_terms):
            raise ValueError(
                f"initial lambda shape {tuple(lam.shape)} does not match "
                f"({config.num_topics}, {num_terms})")
        self._lam = lam.to(dev)
        self._alpha = torch.tensor(config.alpha, dtype=torch.float32,
                                   device=dev)
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            ckpt = load_stream_checkpoint(checkpoint_path)
            if ckpt["lam"].shape != tuple(self._lam.shape):
                raise ValueError(
                    f"checkpoint lambda shape {ckpt['lam'].shape} does "
                    f"not match ({config.num_topics}, {num_terms})"
                )
            self._lam = torch.as_tensor(
                np.asarray(ckpt["lam"], np.float32), device=dev)
            self.step_count = ckpt["step"]
            self.history = [
                StreamStepInfo(step=i + 1, rho=rho, batch_docs=0,
                               likelihood=torch.tensor(
                                   ll, dtype=torch.float32, device=dev),
                               tokens=0)
                for i, (ll, rho) in enumerate(ckpt["history"])
            ]

    def _use_dense(self, b: int) -> bool:
        """The dense E-step for a micro-batch of `b` docs: "auto" takes
        it on the card when the dense kernel takes K (the card's kernel
        takes any B and V); "on" forces it (on the CPU, its plain
        version), "off" never."""
        cfg = self.config
        if cfg.dense_em == "off":
            return False
        feasible = 0 < cfg.num_topics <= dense_estep.MAX_TOPICS
        if cfg.dense_em == "on":
            if not feasible:
                raise ValueError(
                    f"dense_em forced but B={b}, V={self.num_terms}, "
                    f"K={cfg.num_topics} exceeds the dense kernel's "
                    f"{dense_estep.MAX_TOPICS} topics"
                )
            return True
        return feasible and self.device.type == "cuda"

    def member(self, b: int, l: int) -> str:
        """The E-step a [b, l] micro-batch takes: "dense", the per-batch
        dispatch's path as "per_batch:<backend>"
        (ops/estep.resolve_backend)."""
        if self._use_dense(b):
            return "dense"
        return "per_batch:" + estep.resolve_backend(
            "auto", b, l, self.config.num_topics, self.device)

    def _local_step(self, elog_beta, word_idx, counts, doc_mask):
        """One micro-batch's E-step under topics `elog_beta`: the dense
        kernel over the densified micro-batch (W-major, as the JAX
        trainer's plan picks), or the per-batch E-step."""
        cfg = self.config
        if self._use_dense(word_idx.shape[0]):
            dense = dense_estep.densify(word_idx, counts, self.num_terms)
            return dense_estep.e_step_dense(
                elog_beta, self._alpha, dense.t().contiguous(), doc_mask,
                cfg.var_max_iters, cfg.var_tol, wmajor=True,
                cells=word_idx.shape[1])
        return self._per_batch(elog_beta, word_idx, counts, doc_mask)

    def _per_batch(self, elog_beta, word_idx, counts, doc_mask):
        """The per-batch E-step; on the card with the batch's live-token
        plan, which its [V, K] scatter needs."""
        cfg = self.config
        kw = {}
        if word_idx.device.type == "cuda":
            kw["live"] = sparse_estep.live_tokens(word_idx, counts)
        return estep.e_step(elog_beta, self._alpha, word_idx, counts,
                          doc_mask, var_max_iters=cfg.var_max_iters,
                          var_tol=cfg.var_tol, **kw)

    def _blend(self, lam, rho, res, doc_mask):
        """The natural-gradient step: lambda toward eta + D/|S| * SS."""
        return self._blend_ss(lam, rho, res.suff_stats,
                              torch.clamp_min(doc_mask.sum(), 1.0))

    def _blend_ss(self, lam, rho, suff_stats, batch_docs):
        lam_hat = self.config.eta + (
            self.total_docs / batch_docs) * suff_stats.t()
        return (1.0 - rho) * lam + rho * lam_hat

    @classmethod
    def from_topic_probs(cls, config: OnlineLDAConfig, topic_probs,
                         total_docs: int, pseudo_tokens: float = 1e4,
                         num_terms: "int | None" = None,
                         **kwargs) -> "OnlineLDATrainer":
        """Seed the stream from an existing model: `topic_probs` is the
        [V, K] p(word|topic) matrix of word_results.csv (each topic's
        column sums to 1).  lambda[k, v] = eta + pseudo_tokens * p[v, k],
        computed in float64 and cast to float32 (the JAX package's
        lambda, bit for bit), so E_q[beta] ~ p for pseudo_tokens >>
        eta * V and the first steps refine the day's topics instead of
        washing them out.

        `num_terms` > V seeds a grown vocabulary: the new words' rows
        start at the prior eta alone.  Shrinking it is refused (first-
        seen word ids are stable, so a smaller vocabulary is a mixed id
        space).  A checkpoint found at `checkpoint_path` (in kwargs)
        wins over the seed, as in the constructor; `device` and the
        other kwargs go to the constructor."""
        p = np.asarray(topic_probs, np.float64)
        if p.ndim != 2 or p.shape[1] != config.num_topics:
            raise ValueError(
                f"topic_probs must be [V, {config.num_topics}], got "
                f"{p.shape}")
        if not np.isfinite(p).all() or (p < 0).any():
            raise ValueError("topic_probs must be finite and nonnegative")
        if num_terms is None:
            num_terms = p.shape[0]
        if num_terms < p.shape[0]:
            raise ValueError(
                f"num_terms={num_terms} would SHRINK the vocabulary "
                f"(topic_probs covers {p.shape[0]} words): word ids are "
                "first-seen-stable, so pass the grown vocab size or slice "
                "topic_probs explicitly")
        if num_terms > p.shape[0]:
            p = np.concatenate([p, np.zeros((num_terms - p.shape[0],
                                             config.num_topics))], axis=0)
        lam = (config.eta + pseudo_tokens * p.T).astype(np.float32)
        return cls(config, num_terms=num_terms, total_docs=total_docs,
                   initial_lam=lam, **kwargs)

    @property
    def lam(self) -> torch.Tensor:
        return self._lam

    def _put_batch(self, batch: Batch):
        """One micro-batch's tensors on the trainer's device."""
        dev = self.device
        return (torch.as_tensor(batch.word_idx, device=dev),
                torch.as_tensor(batch.counts, dtype=torch.float32,
                                device=dev),
                torch.as_tensor(batch.doc_mask, dtype=torch.float32,
                                device=dev))

    @property
    def _distributed(self) -> bool:
        return self._coll is not None and self._coll.num_processes > 1

    def _step_distributed(self, batch: Batch) -> StreamStepInfo:
        """One update with the micro-batch row-split across the ranks and
        the statistics crossing processes through the collective (always
        an f32 wire: lambda must be the same bytes on every rank)."""
        from ..parallel.allreduce import tree_combine

        cfg = self.config
        coll = self._coll
        p, r = coll.num_processes, coll.rank
        b = batch.word_idx.shape[0]
        if b % p:
            raise ValueError(
                f"micro-batch of {b} docs not divisible by {p} processes "
                "(make_batches pad_multiple must cover the process count)")
        t = self.step_count
        rho = float((cfg.tau0 + t) ** (-cfg.kappa))
        lo, hi = r * b // p, (r + 1) * b // p
        widx, cnts, mask = self._put_batch(Batch(
            batch.word_idx[lo:hi], batch.counts[lo:hi],
            batch.doc_index[lo:hi], batch.doc_mask[lo:hi]))
        res = self._local_step(expected_log_beta(self._lam), widx, cnts,
                               mask)
        reduced = tree_combine(coll.allgather_arrays(
            {"suff_stats": res.suff_stats.cpu().numpy(),
             "likelihood": res.likelihood.cpu().numpy()},
            f"svi{t}", precision="f32"))
        dev = self.device
        self._lam = self._blend_ss(
            self._lam, torch.tensor(rho, dtype=torch.float32, device=dev),
            torch.from_numpy(np.ascontiguousarray(
                reduced["suff_stats"], np.float32)).to(dev),
            torch.tensor(max(float(batch.doc_mask.sum()), 1.0),
                         dtype=torch.float32, device=dev))
        self.step_count += 1
        info = StreamStepInfo(
            step=self.step_count,
            rho=rho,
            batch_docs=int(batch.doc_mask.sum()),
            likelihood=torch.tensor(float(reduced["likelihood"]),
                                    dtype=torch.float32, device=dev),
            tokens=int(batch.counts.sum()),
        )
        self.history.append(info)
        self._maybe_stream_checkpoint(prev_count=self.step_count - 1)
        return info

    def step(self, batch: Batch) -> StreamStepInfo:
        """One natural-gradient update from one micro-batch (rho in
        float64 on the host)."""
        if self._distributed:
            return self._step_distributed(batch)
        cfg = self.config
        t = self.step_count
        rho = float((cfg.tau0 + t) ** (-cfg.kappa))
        widx, cnts, mask = self._put_batch(batch)
        res = self._local_step(expected_log_beta(self._lam), widx, cnts, mask)
        self._lam = self._blend(
            self._lam, torch.tensor(rho, dtype=torch.float32,
                                    device=self.device), res, mask)
        self.step_count += 1
        info = StreamStepInfo(
            step=self.step_count,
            rho=rho,
            batch_docs=int(batch.doc_mask.sum()),
            likelihood=res.likelihood,  # device scalar: no wait here
            tokens=int(batch.counts.sum()),
        )
        self.history.append(info)
        self._maybe_stream_checkpoint(prev_count=self.step_count - 1)
        return info

    def _maybe_stream_checkpoint(self, prev_count: int) -> None:
        """Checkpoint when a checkpoint_every boundary was crossed since
        `prev_count` (chunked steps cross it mid-chunk; only the
        end-of-chunk lambda is kept, so the checkpoint lands on the first
        step call after the boundary)."""
        every = self.config.checkpoint_every
        if not (self.checkpoint_path and every):
            return
        if self._coll is not None and self._coll.rank != 0:
            return      # rank 0 writes the shared day dir
        if (self.step_count // every) <= (prev_count // every):
            return
        save_stream_checkpoint(
            self.checkpoint_path,
            self._lam.cpu().numpy(),
            float(self._alpha),
            self.step_count,
            [(float(h.likelihood), h.rho) for h in self.history],
        )

    def _run_chunk(self, run: Sequence[Batch]) -> "list[StreamStepInfo]":
        """A same-shape run of micro-batches with the device schedule:
        rho = (tau0 + t)^-kappa in float32 on the device, t a float32
        counter advanced there, so nothing is read back between steps
        (the JAX package runs the run as one scan)."""
        cfg = self.config
        dev = self.device
        prev = self.step_count
        t = torch.tensor(float(prev), dtype=torch.float32, device=dev)
        lam = self._lam
        lls = []
        for b in run:
            w, c, m = self._put_batch(b)
            rho = (cfg.tau0 + t) ** (-cfg.kappa)
            res = self._local_step(expected_log_beta(lam), w, c, m)
            lam = self._blend(lam, rho, res, m)
            lls.append(res.likelihood)
            t = t + 1.0
        self._lam = lam
        infos = []
        for i, b in enumerate(run):
            rho = float((cfg.tau0 + self.step_count) ** (-cfg.kappa))
            self.step_count += 1
            info = StreamStepInfo(
                step=self.step_count,
                rho=rho,
                batch_docs=int(b.doc_mask.sum()),
                likelihood=lls[i],  # device scalar: no wait here
                tokens=int(b.counts.sum()),
            )
            self.history.append(info)
            infos.append(info)
        self._maybe_stream_checkpoint(prev_count=prev)
        return infos

    def step_many(self, batches: Sequence[Batch],
                  chunk: int = 16) -> "list[StreamStepInfo]":
        """Natural-gradient updates over `batches` IN ORDER, each
        contiguous same-shape run on the device schedule (_run_chunk).
        Runs split into power-of-two lengths capped at `chunk` (a
        7-batch run = 4 + 2 + one step()), as the JAX package splits its
        scans.  Numerically it is step() applied to each micro-batch in
        sequence, up to the rho schedule's float32 evaluation; only the
        checkpoint timing coarsens.  A distributed stream takes step()
        per micro-batch."""
        if chunk < 2 or self._distributed:
            return [self.step(b) for b in batches]
        infos: "list[StreamStepInfo]" = []
        i, n = 0, len(batches)
        while i < n:
            shape = batches[i].word_idx.shape
            j = i
            while j < n and batches[j].word_idx.shape == shape:
                j += 1
            while i < j:
                c = min(j - i, chunk)
                c = 1 << (c.bit_length() - 1)   # largest power of two <= c
                if c >= 2:
                    infos.extend(self._run_chunk(batches[i:i + c]))
                else:
                    infos.append(self.step(batches[i]))
                i += c
        return infos

    def fit_stream(self, batches: Iterable[Batch],
                   progress: "Callable[[StreamStepInfo], None] | None" = None,
                   chunk: int = 16) -> "OnlineLDATrainer":
        """Consume a micro-batch stream, buffering contiguous same-shape
        runs into step_many chunks (progress fires per micro-batch, but
        only after its chunk completes)."""
        buf: "list[Batch]" = []

        def flush():
            infos = self.step_many(buf, chunk=chunk)
            buf.clear()
            if progress:
                for info in infos:
                    progress(info)

        for b in batches:
            if buf and (b.word_idx.shape != buf[0].word_idx.shape
                        or len(buf) >= chunk):
                flush()
            buf.append(b)
        flush()
        return self

    # -- model extraction ---------------------------------------------------

    def log_beta(self) -> np.ndarray:
        """Point-estimate topics: log E_q[beta] = log(lambda / sum lambda),
        with the batch engine's LOG_ZERO floor so downstream file contracts
        (final.beta, word_results.csv) behave identically."""
        lam = self._lam.cpu().numpy()
        beta = lam / lam.sum(-1, keepdims=True)
        return np.where(beta > 0, np.log(np.maximum(beta, 1e-300)),
                        estep.LOG_ZERO)

    def held_out_per_token_ll(self, batches: Sequence[Batch]) -> float:
        """Held-out per-token log-likelihood (document completion,
        models/evaluate.py) of unseen docs under the current topics."""
        from .evaluate import held_out_per_token_ll

        return held_out_per_token_ll(
            self.log_beta(), float(self._alpha), batches,
            var_max_iters=self.config.var_max_iters,
            var_tol=self.config.var_tol, device=self.device,
        )

    def infer_gamma(self, batches: Sequence[Batch],
                    num_docs: int) -> np.ndarray:
        """Final inference pass: doc-topic posteriors for ``num_docs``
        docs under the current (frozen) topics through the per-batch
        E-step — final.gamma for the scoring stage."""
        log_b = expected_log_beta(self._lam)
        gamma_out = np.zeros((num_docs, self.config.num_topics), np.float64)
        for b in batches:
            widx, cnts, mask = self._put_batch(b)
            res = self._per_batch(log_b, widx, cnts, mask)
            g = res.gamma.to("cpu", torch.float64).numpy()
            sel = b.doc_mask == 1
            gamma_out[b.doc_index[sel]] = g[sel]
        return gamma_out

    def result(self, batches: "Sequence[Batch] | None" = None,
               num_docs: int = 0) -> LDAResult:
        gamma = (
            self.infer_gamma(batches, num_docs)
            if batches is not None
            else np.zeros((0, self.config.num_topics))
        )
        # likelihood.dat contract: column 2 is the relative change between
        # consecutive entries, here between micro-batch ELBOs — NOT the
        # learning rate, which lives in history[i].rho.
        raw = [float(h.likelihood) for h in self.history]
        lls = [
            (ll, abs((raw[i - 1] - ll) / raw[i - 1]) if i else 1.0)
            for i, ll in enumerate(raw)
        ]
        return LDAResult(
            log_beta=self.log_beta(),
            gamma=gamma,
            alpha=float(self._alpha),
            likelihoods=lls,
            em_iters=self.step_count,
        )


def train_corpus_online(
    corpus,
    config: OnlineLDAConfig,
    out_dir: "str | None" = None,
    epochs: int = 1,
    progress: "Callable[[StreamStepInfo], None] | None" = None,
    initial_lam=None,
    device: "str | torch.device | None" = None,
    collective=None,
    distributed: "bool | None" = None,
) -> LDAResult:
    """Stream an in-memory corpus through the online trainer, micro-batch
    by micro-batch (each `make_batches` batch, padded to a multiple of
    8), then write final.*, likelihood.dat into `out_dir`.

    Each epoch's order is `np.random.default_rng(config.seed)`'s
    permutation, stable-sorted by micro-batch shape (still deterministic
    in the seed), so same-shape runs stream through fit_stream's chunks;
    a run resumed from `out_dir/checkpoint.npz` fast-forwards past the
    micro-batches it already took.  `result.stats` names the E-step the
    micro-batches took (`member`; the final inference pass runs the
    per-batch E-step) and the micro-batch shapes.

    Distributed (`distributed`, None: parallel.initialize_distributed
    ran):
    every micro-batch row-splits across the ranks, so the batch axis
    pads to a multiple of 8 times the process count; rank 0 alone
    writes the files."""
    from ..io import make_batches

    trainer = OnlineLDATrainer(
        config, num_terms=corpus.num_terms, total_docs=corpus.num_docs,
        checkpoint_path=(os.path.join(out_dir, "checkpoint.npz")
                         if out_dir and config.checkpoint_every else None),
        initial_lam=initial_lam, device=device, collective=collective,
        distributed=distributed,
    )
    nproc = trainer._coll.num_processes if trainer._coll is not None else 1
    writer = trainer._coll is None or trainer._coll.rank == 0
    ckpt_path = trainer.checkpoint_path
    batches = make_batches(
        corpus, batch_size=config.batch_size,
        min_bucket_len=config.min_bucket_len, pad_multiple=8 * nproc,
    )
    coll = trainer._coll
    ar0 = dict(coll.stats) if coll is not None else None
    done = trainer.step_count
    rng = np.random.default_rng(config.seed)
    for _ in range(epochs):
        order = sorted(
            rng.permutation(len(batches)),
            key=lambda i: batches[i].word_idx.shape,
        )
        skip, done = min(done, len(order)), max(done - len(order), 0)
        trainer.fit_stream(
            (batches[i] for i in order[skip:]), progress=progress
        )
    result = trainer.result(batches, corpus.num_docs)
    shapes = sorted({tuple(int(n) for n in b.word_idx.shape)
                     for b in batches})
    result.stats = {"driver": "online", "batches": len(batches),
                    "batch_shapes": shapes,
                    "member": trainer.member(*shapes[0]) if shapes else None}
    if coll is not None:
        if coll.num_processes > 1:
            # Rank parity of lambda: checked, not assumed.
            import hashlib

            digest = hashlib.sha256(trainer.lam.cpu().numpy().tobytes())
            digests = coll.allgather_obj(digest.hexdigest(), "svi_parity")
            if any(d != digests[0] for d in digests):
                raise RuntimeError(
                    f"distributed online LDA rank parity violated: {digests}")
        d = coll.stats
        result.stats["allreduce"] = {
            "transport": coll.transport, "nprocs": coll.num_processes,
            **{k: d[k] - ar0[k] for k in ("ops", "bytes_out", "bytes_in")},
            "wall_s": round(d["wall_s"] - ar0["wall_s"], 6)}
    if ckpt_path and writer and os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    if out_dir and writer:
        result.save(out_dir, num_terms=corpus.num_terms)
    return result
