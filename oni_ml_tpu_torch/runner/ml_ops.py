"""A day of flow, DNS or proxy events on the card (port of
oni_ml_tpu/runner/ml_ops.py, single-card) — replaces
ml_ops.sh YYYYMMDD flow|dns TOL:

    python -m oni_ml_tpu_torch.runner.ml_ops 20160122 dns 1e-20 \\
        --dns-path raw.csv --top-domains top-1m.csv --data-dir /data \\
        [--device cuda|cpu] [--stages pre,corpus] [--force] \\
        [--checkpoint-every N] [--heartbeat SECS] [--profile DIR] \\
        [--pre-workers N] [--qtiles FILE] [--no-dataplane] \\
        [--no-checkpoints] [--online [--eta E --tau0 T --kappa K]] \\
        [--eval-quality | --eval-holdout FRAC] [--publish DEST] \\
        [--multihost [--em-shards N]]

    python -m oni_ml_tpu_torch.runner.ml_ops serve --day-dir DIR ...
    python -m oni_ml_tpu_torch.runner.ml_ops continuous flow --flow-path F
    python -m oni_ml_tpu_torch.runner.ml_ops replica --id r0 ...
    python -m oni_ml_tpu_torch.runner.ml_ops route --fleet M --replicas N

route to the streaming scoring service (runner/serve.py), the
continuous standing service (runner/continuous.py) and the replicated
serving fleet (runner/route.py).

Stages, each writing the JAX runner's artifacts into <data-dir>/<fdate>
(the source's hooks come from the registry, `sources.get(dsource)`):

    pre     raw events (+ <dsource>_scores.csv feedback) -> features.pkl,
            word_counts.dat (flow and DNS: the native C++ featurizers,
            sharded over --pre-workers, raw rows spilled to
            raw_lines.bin; ONI_ML_TPU_NO_NATIVE=1 runs them in Python)
    corpus  word counts -> words.dat / doc.dat / model.dat
    lda     EM on the device -> final.beta/.gamma/.other, likelihood.dat,
            doc_results.csv, word_results.csv (--online: streaming SVI,
            models/online_lda.py; --eval-holdout FRAC: EM on the
            documents outside a name-hashed split, whose held-out
            per-token likelihood the record carries; --eval-quality:
            the model's document-completion score, models/evaluate.py)
    score   scoring -> <dsource>_results.csv: the float64 host engine,
            or with ONI_ML_TPU_SCORE=device (ScoringConfig.engine) the
            chunked gather-dot-filter pipeline on the card

Pre, corpus and score are host work, their hot loops in the port's C++
libraries (native_build.py: built with g++ at first use); LDA is the
one stage on the device, its E-step a hand-written CUDA kernel: the
engine family comes from ONI_ML_TPU_ESTEP, else LDAConfig.estep_engine,
else (on the card) the measured dense-vs-sparse crossover
(models/lda.py resolve_estep_engine).  Each stage prints one JSON
record with its wall time; all records land in metrics.json.  The `lda` record also names
the engine with its source, the family member that ran, the crossover's
record where it decided, the EM driver with its knobs and their
sources, the batches trained, the kernel launches enqueued and those
that ran (the kernels count these on the card; the rest were enqueued
after the device stopped EM) and the host syncs.

Streaming dataplane (dataplane/, on by default; --no-dataplane runs the
serial path): within one process the live featurized day, corpus and
model pass from stage to stage either way; with the dataplane the
inter-stage files become background checkpoint writes that overlap the
later stages (features.pkl and word_counts.dat behind corpus and EM,
the corpus triplet behind EM, final.* and the results CSVs behind
scoring), the word counts stream into corpus assembly through a bounded
channel, and scoring's index prep runs on a host thread while EM runs.
The results CSV, a product, is written in the background too but never
skipped.  run_pipeline joins every background write before it returns,
and one that failed fails the run.  Every artifact is byte-identical
either way.  --no-checkpoints skips the inter-stage files (and removes
the spill once the run ends): the run writes only its products (the
results CSV, metrics.json, run_journal.jsonl), and a later `--stages`
run against that day is refused, naming the missing file.  metrics.json
gets the plane's record (`{"stage": "dataplane"}`: each background
task's wall by stage, each channel's stalls); the journal its
`{"kind": "dataplane"}` records and `dataplane.*` spans.

Resume contract: every stage's outputs land by temporary file and
rename, so a file under its contract name is complete.  A stage whose
outputs all exist is skipped (unless --force); --stages runs a subset.
A stage that runs first removes its old outputs and those of the stages
after it, which were made from them; pre and corpus, and a forced lda,
also remove an EM checkpoint.npz, which only a rerun of lda alone
resumes from.
A stage whose upstream ran in another process reads the files instead
(word_counts.dat; the model.dat triplet; features.pkl and the results
CSVs), and fails fast, naming the missing file and the command that
writes it, when one is absent.  Both ways give the same bytes.
run_journal.jsonl records every stage, so a skip names whether the
journal or only the files vouched for it.  With --checkpoint-every N
the lda stage saves EM state to checkpoint.npz every N iterations (N
micro-batches under --online) and a rerun resumes from it.

Flight recorder (telemetry/): with the journal on, a Recorder bound to
it records a `stage.<name>` span per stage, the EM drivers'
`em.host_sync` spans and `em.chunk_dispatches` counter, the engine
crossover (`estep_crossover`), the scorer's chunk-loop span and
`dispatch` stats, and `roofline` records (analytic FLOPs and bytes over
the measured wall, against the card's peaks), which metrics.json also
gets as one `{"stage": "roofline", "records": [...]}` entry.
`--heartbeat SECS` probes the device on a background thread and turns a
device that stops answering into a clean BackendLost (exit 3) at the
next stage boundary; `--profile DIR` writes a torch.profiler trace of
the whole run (CPU and, on the card, CUDA activity) as Chrome trace
JSON.  Neither changes a result.  `--publish DEST` copies the finished
day directory (metrics.json included) to DEST, or to an scp-style
host:path.

Multi-process distributed EM (`--multihost`): N rank processes, started
with torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK; parallel/mesh.py), share one --data-dir.  Pre, corpus and
score, and every file write, run on rank 0; the lda stage runs on every
rank, each training its own document shards and reducing the
statistics through the collective (models/lda.py distributed EM).
Each stage's run-or-skip is decided on rank 0 and broadcast (which is
also the barrier between stages), and after each stage every rank's
outcome is gathered: a stage that failed on any rank fails every rank,
the others exiting 3 with "failed on another rank".  `--em-shards N`
fixes the shard plan, so runs at different rank counts write the same
bytes.  On one card the ranks share it (each its own CUDA context) and
the collective runs over the rendezvous store (kvring).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import sys
import time
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from .. import sources
from ..config import (DataplaneConfig, FeedbackConfig, LDAConfig,
                      OnlineLDAConfig, PipelineConfig, ScoringConfig,
                      TelemetryConfig)
from ..dataplane import (Dataplane, atomic_write, atomic_write_bytes,
                         build_scoring_prep, consume_corpus,
                         stream_word_counts, word_count_columns)
from ..device import resolve_device
from ..io import Corpus, formats, make_batches
from ..models import LDAResult, train_corpus, train_corpus_online
from ..parallel import mesh
from ..ops import dense_estep, estep, pallas_estep, sparse_estep
from ..scoring import DispatchStats, ScoringModel
from ..scoring.score import _score_engine
from ..telemetry import (BackendLost, HeartbeatMonitor, Journal, Recorder,
                         RunJournal, maybe_span, roofline, use_recorder)
from ..telemetry.heartbeat import device_add_probe


class Stage(str, Enum):
    PRE = "pre"
    CORPUS = "corpus"
    LDA = "lda"
    SCORE = "score"


STAGE_ORDER = [Stage.PRE, Stage.CORPUS, Stage.LDA, Stage.SCORE]

# Stage -> the files that mark it complete (the score stage's results
# file is named after the dsource: RunContext.results_name).
_STAGE_OUTPUTS = {
    Stage.PRE: ["features.pkl", "word_counts.dat"],
    Stage.CORPUS: ["words.dat", "doc.dat", "model.dat"],
    Stage.LDA: [
        "final.beta", "final.gamma", "final.other", "likelihood.dat",
        "doc_results.csv", "word_results.csv",
    ],
    Stage.SCORE: [],
}


# The EM checkpoint an interrupted lda stage leaves (models/lda.py
# train_corpus): fit to the corpus on disk, so stale once pre or corpus
# runs again.
CHECKPOINT = "checkpoint.npz"
# The native featurizers' spilled raw rows: features.pkl names it, so a
# resumed score stage reads it; a run of pre removes the old one first.
# Not a stage output (the Python featurizers write none).
SPILL = "raw_lines.bin"


class MissingArtifactError(RuntimeError):
    """A stage needed an upstream file that is missing or that the port
    cannot load — a `--stages` run against an incomplete day.  Raised
    before any loader runs, naming the file and the command that writes
    it."""


def artifacts(dsource: str) -> list:
    """Every file a complete day of `dsource` holds."""
    return [n for s in STAGE_ORDER for n in _STAGE_OUTPUTS[s]] + [
        f"{dsource}_results.csv"]


# The kernels each family member launches, once per batch per EM
# iteration on the card ("per_batch:xla" is plain ops but for its
# [V, K] scatter).
ENGINE_KERNELS = {
    "sparse": ("sparse_estep", "sparse_scatter"),
    "dense": ("dense_estep",),
    "compact": ("dense_estep",),
    "per_batch:sparse": ("sparse_estep", "sparse_scatter"),
    "per_batch:pallas": ("fixed_point_estep", "sparse_scatter"),
    "per_batch:xla": ("sparse_scatter",),
    "per_batch:dense": ("dense_estep",),
}


def launch_counts() -> dict:
    """Launches so far of every kernel of the port (CUDA only)."""
    return {"sparse_estep": sparse_estep.launch_count,
            "sparse_scatter": sparse_estep.scatter_launch_count,
            "dense_estep": dense_estep.launch_count,
            "fixed_point_estep": pallas_estep.launch_count}


def executed_counts() -> dict:
    """Of those, the launches that ran past the chunk driver's stop
    check, as the kernels counted them on the card (a host sync)."""
    estep, scatter = sparse_estep.executed_counts()
    return {"sparse_estep": estep, "sparse_scatter": scatter,
            "dense_estep": dense_estep.executed_count(),
            "fixed_point_estep": pallas_estep.executed_count()}


def reset_kernel_counts() -> None:
    """Zero every kernel's launch count and executed counter."""
    sparse_estep.reset_launch_count()
    dense_estep.reset_launch_count()
    pallas_estep.reset_launch_count()


def kernel_counts() -> tuple:
    """(launch_counts(), executed_counts()): what lda_record takes as
    the counts before a fit."""
    return launch_counts(), executed_counts()


def lda_record(result, counts0: tuple, dev) -> dict:
    """The `lda` stage's fields from a train_corpus result and the
    kernel_counts() before it."""
    plan, stats = result.plan, result.stats
    engine = plan["estep_engine"]["value"]
    launches0, executed0 = counts0
    launches = {name: n - launches0[name]
                for name, n in launch_counts().items()}
    executed = {name: n - executed0[name]
                for name, n in executed_counts().items()}
    skipped = stats.get("skipped_iterations", 0)
    lls = [ll for ll, _ in result.likelihoods]
    # The chunk driver's knobs; a distributed fit has none (its reduce is
    # the host sync) and names its shard plan and allreduce instead.
    knobs = {}
    if "fused_em_chunk" in plan:
        knobs = {"chunk": plan["fused_em_chunk"]["value"],
                 "chunk_source": plan["fused_em_chunk"]["source"],
                 "sync": plan["host_sync_every"]["value"],
                 "sync_source": plan["host_sync_every"]["source"]}
    for name in ("em_shards", "allreduce"):
        if name in plan:
            knobs[name] = plan[name]
    return {
        "device": str(dev), "engine": engine,
        "engine_source": plan["estep_engine"]["source"],
        "member": stats["member"],
        "crossover": plan.get("estep_crossover"),
        "driver": stats["driver"],
        **knobs,
        "em_iters": result.em_iters,
        "final_likelihood": lls[-1] if lls else None,
        "alpha": result.alpha,
        "batches": stats["batches"], "batch_shapes": stats["batch_shapes"],
        "kernel_launches": launches,
        "executed_launches": executed,
        "skipped_iterations": skipped,
        "skipped_launches": {name: launches[name] - executed[name]
                             for name in launches},
        "host_syncs": stats["host_syncs"],
    }


def online_record(result, counts0: tuple, dev, em_s: float,
                  num_docs: int, epochs: int = 1) -> dict:
    """The `lda` stage's fields from a train_corpus_online result (its
    stats: the member that ran the micro-batch E-steps, the micro-batch
    shapes, the inference pass) and the kernel_counts() before it.  The
    micro-batch steps stand in for EM iterations (`em_iters`)."""
    launches0, executed0 = counts0
    stats = result.stats
    lls = [ll for ll, _ in result.likelihoods]
    return {
        "device": str(dev), "engine": "online", "member": stats["member"],
        "driver": "online", "em_iters": result.em_iters,
        "final_likelihood": lls[-1] if lls else None,
        "alpha": result.alpha, "batches": stats["batches"],
        "batch_shapes": stats["batch_shapes"],
        "kernel_launches": {name: n - launches0[name]
                            for name, n in launch_counts().items()},
        "executed_launches": {name: n - executed0[name]
                              for name, n in executed_counts().items()},
        "em_s": em_s, "micro_batches_per_s": result.em_iters / em_s,
        "docs_per_s": num_docs * epochs / em_s,
        **({"allreduce": stats["allreduce"]} if "allreduce" in stats
           else {}),
    }


@dataclass
class RunContext:
    """One invocation's state.  `features`, `corpus` and `result` are
    the live hand-offs between stages of this process (None where the
    stage that makes them did not run here: the next stage then reads
    its files).  `plane` is the run's dataplane (None: the serial path),
    `word_counts` the featurized day's columnar word counts it streams
    into the corpus stage, `score_prep` its scoring-prep task."""

    config: PipelineConfig
    fdate: str
    dsource: str
    day_dir: str
    device: object = None
    initial_log_beta: "np.ndarray | None" = None
    emit: object = print
    metrics: list = field(default_factory=list)
    features: object = None
    corpus: "Corpus | None" = None
    result: object = None
    journal: "RunJournal | None" = None
    # Stages a replayed journal records complete (empty under --force).
    journal_done: set = field(default_factory=set)
    # The flight recorder bound to the journal, and the device heartbeat
    # whose check() gates each stage entry (None when off).
    recorder: "Recorder | None" = None
    heartbeat: "HeartbeatMonitor | None" = None
    online: bool = False
    eval_quality: bool = False
    eval_holdout: float = 0.0
    plane: "Dataplane | None" = None
    word_counts: object = None
    score_prep: object = None
    # The stages this invocation may run: whether the lda stage starts
    # the scoring prep.
    wanted: list = field(default_factory=lambda: list(STAGE_ORDER))
    # A replayed journal shows a --no-checkpoints run of this day: a
    # missing file's message says why it is missing.
    prior_no_checkpoints: bool = False

    def path(self, name: str) -> str:
        return os.path.join(self.day_dir, name)

    def results_name(self) -> str:
        return f"{self.dsource}_results.csv"

    def outputs(self, stage: Stage) -> list:
        return _STAGE_OUTPUTS[stage] or [self.results_name()]

    def record(self, rec: dict) -> None:
        rec = {"fdate": self.fdate, "dsource": self.dsource, **rec}
        self.metrics.append(rec)
        self.emit(json.dumps(rec), flush=True)


@dataclass
class DayRun:
    """What `run_pipeline` leaves in memory: the stage records and the
    live featurized day, corpus and trained model of the stages that ran
    (so a caller can train and score the same corpus again without
    repeating pre and corpus; chip_smoke.py does, with other engines)."""

    records: list
    features: object
    corpus: "Corpus | None"
    result: object


def _stage_done(ctx: RunContext, stage: Stage) -> "str | None":
    """Why this stage can be skipped, or None if it must run.  The files
    decide (a journal that says "done" about deleted outputs does not
    win); the journal names where the evidence came from."""
    if not all(os.path.exists(ctx.path(n)) for n in ctx.outputs(stage)):
        return None
    if stage.value in ctx.journal_done:
        return "journal: stage completed in a prior run"
    return "outputs exist"


def _require_artifacts(ctx: RunContext, names: list, stage: Stage,
                       regen_stage: Stage) -> None:
    """Fail fast, naming the file and the command that regenerates it,
    when a stage's file input is missing."""
    missing = [n for n in names if not os.path.exists(ctx.path(n))]
    if not missing:
        return
    msg = (
        f"stage {stage.value} needs {missing[0]} in {ctx.day_dir} and it "
        f"does not exist; regenerate it with `ml_ops {ctx.fdate} "
        f"{ctx.dsource} --stages {regen_stage.value} --force`"
        + (f" (also missing: {', '.join(missing[1:])})"
           if len(missing) > 1 else "")
    )
    if ctx.prior_no_checkpoints:
        msg += (
            " — note: a prior run of this day used --no-checkpoints, so "
            "no inter-stage files were written; resume is refused by "
            "design, re-run the full day"
        )
    raise MissingArtifactError(msg)


def _require_inputs(ctx: RunContext, stage: Stage) -> None:
    """A stage's file inputs where its upstream did not run in this
    process (no live hand-off): checked before the stage removes
    anything, so a refused resume leaves the day as it was."""
    if stage is Stage.CORPUS and ctx.features is None:
        _require_artifacts(ctx, ["word_counts.dat"], stage, Stage.PRE)
    elif stage is Stage.LDA and ctx.corpus is None:
        _require_artifacts(ctx, ["model.dat", "words.dat", "doc.dat"],
                           stage, Stage.CORPUS)
    elif stage is Stage.SCORE and ctx.features is None:
        _require_artifacts(ctx, ["features.pkl"], stage, Stage.PRE)


def _score_wanted(ctx: RunContext) -> bool:
    """Whether this invocation may still run the score stage (the lda
    stage then starts the scoring prep)."""
    return Stage.SCORE in ctx.wanted


class _PortUnpickler(pickle.Unpickler):
    """Loads only the port's classes, numpy's and builtins: a
    features.pkl that names another package's classes (the JAX
    package's runner writes oni_ml_tpu.features.* containers) is refused
    without importing that package."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("oni_ml_tpu_torch", "numpy", "builtins"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name}")


def load_features(ctx: RunContext):
    """The featurized day from features.pkl (a resumed score stage), its
    spilled raw rows checked (resolve_spill)."""
    _require_artifacts(ctx, ["features.pkl"], Stage.SCORE, Stage.PRE)
    try:
        with open(ctx.path("features.pkl"), "rb") as f:
            features = _PortUnpickler(f).load()
    except pickle.UnpicklingError as e:
        raise MissingArtifactError(
            f"{ctx.path('features.pkl')} names {e}, which the port does "
            "not load (features.pkl written by another package, such as "
            "the JAX package's runner); the port must re-run pre: "
            f"`ml_ops {ctx.fdate} {ctx.dsource} --stages pre --force`"
        ) from None
    resolve_spill(ctx, features)
    return features


def resolve_spill(ctx: RunContext, features) -> None:
    """A native container names its spilled raw rows by the path and size
    they had at pre time (features/blob.MmapBlob).  The file of that name
    in this day directory wins, since the pre stage owns its day
    directory: a copied day never reads its original's spill.  The
    recorded path stands in only when this directory has none.  Either
    must have the recorded size: a spill of another run would misalign
    every row.  Raises MissingArtifactError, naming the file and
    `--stages pre --force`, when neither is there or the size differs."""
    from ..features.blob import MmapBlob

    regen = f"`ml_ops {ctx.fdate} {ctx.dsource} --stages pre --force`"
    for attr in ("lines_blob", "rows_blob"):
        blob = getattr(features, attr, None)
        if not isinstance(blob, MmapBlob):
            continue
        path = ctx.path(os.path.basename(blob.path))
        if not os.path.exists(path):
            path = blob.path
            if not os.path.exists(path):
                raise MissingArtifactError(
                    f"stage score needs {os.path.basename(blob.path)} in "
                    f"{ctx.day_dir} (features.pkl's spilled raw rows, "
                    f"recorded at {blob.path}) and it does not exist; "
                    f"regenerate it with {regen}")
        have = os.path.getsize(path)
        if blob.size is not None and have != blob.size:
            raise MissingArtifactError(
                f"features.pkl's spilled raw rows held {blob.size} bytes at "
                f"pre time and {path} holds {have}: a spill of another run; "
                f"regenerate it with {regen}")
        blob.path = path


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def stage_pre(ctx: RunContext) -> dict:
    """The source's featurizer over the day -> features.pkl and
    word_counts.dat.  Flow and DNS run the native featurizers: raw rows
    stream to raw_lines.bin (which features.pkl names), the passes shard
    over the pre workers, and word_counts.dat is emitted in C++ from the
    interned tables.  With the dataplane both files are background
    checkpoints (_finish_pre_dataplane).  The record names the engine
    that ran ("native" or "python", and why a day with the library took
    Python), the workers with their source, and the pass walls."""
    from ..features.shards import resolve_pre_workers

    cfg = ctx.config
    workers, workers_src = resolve_pre_workers(cfg.pre_workers,
                                               with_source=True)
    timings: dict = {}
    features, fb_rows = sources.get(ctx.dsource).featurize_day(
        cfg, ctx.path(SPILL), workers, timings)
    engine = timings.pop("pre_engine")
    reason = timings.pop("python_reason", None)
    if ctx.plane is not None:
        n_wc = _finish_pre_dataplane(ctx, features, timings)
    else:
        t0 = time.perf_counter()
        atomic_write(ctx.path("features.pkl"), _pickler(features))
        timings["pickle_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_wc = 0

        def write(tmp):
            nonlocal n_wc
            n_wc = features.write_word_counts(tmp)

        atomic_write(ctx.path("word_counts.dat"), write)
        timings["wc_emit_s"] = time.perf_counter() - t0
    ctx.features = features
    out = {"events": features.num_events, "word_count_rows": n_wc,
           "feedback_rows": len(fb_rows), "pre_engine": engine,
           "pre_workers": workers, "pre_workers_source": workers_src,
           **timings}
    if reason is not None:
        out["python_reason"] = reason
    return out


def _pickler(features):
    """features.pkl's writer: `write(tmp)` for atomic_write."""
    def dump(tmp):
        with open(tmp, "wb") as f:
            pickle.dump(features, f, protocol=pickle.HIGHEST_PROTOCOL)
    return dump


def _finish_pre_dataplane(ctx: RunContext, features, timings) -> int:
    """The pre stage's dataplane tail: the live container is the hand-off
    (to corpus assembly, through its columnar word counts, and to
    scoring), and features.pkl and word_counts.dat become background
    checkpoints overlapping the later stages (skipped under
    --no-checkpoints).  Returns the word-count rows."""
    plane = ctx.plane
    ctx.word_counts = word_count_columns(features)
    if plane.checkpoints:
        plane.checkpoint("features_pkl", lambda: atomic_write(
            ctx.path("features.pkl"), _pickler(features)),
            stage=Stage.PRE.value)
        plane.checkpoint("word_counts", lambda: atomic_write(
            ctx.path("word_counts.dat"), features.write_word_counts),
            stage=Stage.PRE.value)
        timings["pickle"] = timings["wc_write"] = "background"
    else:
        timings["pickle"] = timings["wc_write"] = "skipped"
    return ctx.word_counts.ids.num_rows


def stage_corpus(ctx: RunContext) -> dict:
    """Word counts -> the corpus -> words.dat / doc.dat / model.dat.  In
    the process that ran pre, the live container hands off its corpus:
    with the dataplane its columnar word counts stream through a bounded
    channel into first-seen assembly (StreamingCorpusBuilder) and the
    triplet is a background checkpoint; on the serial path `to_corpus`
    (a native container's id arrays, a Python one's triples).  Else
    word_counts.dat is read (natively)."""
    plane = ctx.plane
    stream = None
    if ctx.features is not None and plane is not None:
        wc = ctx.word_counts
        ctx.word_counts = None
        ch = plane.channel("pre.wc->corpus")
        plane.spawn(
            "wc_stream",
            lambda: stream_word_counts(wc, ch),
            stage=Stage.CORPUS.value,
            # put() backpressure waits are idle, not work.
            stall=lambda: ch.stats()["put_stall_s"],
        )
        corpus, builder = consume_corpus(ch, wc.ip_table, wc.word_table)
        handoff = "direct"
        stream = {"chunks": builder.chunks, "rows": builder.rows}
    elif ctx.features is not None:
        corpus = ctx.features.to_corpus()
        handoff = "direct"
    else:
        corpus = Corpus.from_word_counts_file(ctx.path("word_counts.dat"))
        handoff = "file"
    if plane is not None:
        plane.checkpoint("corpus_dat", lambda: corpus.save(ctx.day_dir),
                         stage=Stage.CORPUS.value)
    else:
        corpus.save(ctx.day_dir)
    ctx.corpus = corpus
    out = {"docs": corpus.num_docs, "vocab": corpus.num_terms,
           "tokens": corpus.num_tokens, "handoff": handoff}
    if stream is not None:
        out["stream"] = stream
    return out


def stage_lda(ctx: RunContext) -> dict:
    """EM on the device (or --online SVI, or --eval-holdout's EM on the
    training split), then final.*, doc_results.csv and word_results.csv
    (likelihood.dat streams during the fit).  With the dataplane the
    scoring prep runs on a host thread during the fit, and a batch fit's
    model files are background checkpoints (_demote_lda_artifacts)."""
    if ctx.corpus is not None:
        corpus, corpus_src = ctx.corpus, "handoff"
    else:
        corpus = Corpus.from_model_dat(ctx.path("model.dat"),
                                       ctx.path("words.dat"),
                                       ctx.path("doc.dat"))
        corpus_src = "file"
    plane = ctx.plane
    # The online and holdout trainers write their model files inline.
    streamline = (plane is not None and not ctx.online
                  and not ctx.eval_holdout)
    if (plane is not None and ctx.features is not None and not ctx.online
            and _score_wanted(ctx)):
        # The event index prep needs only the corpus orderings and the
        # featurized day, both final here: it runs during the fit.
        feats = ctx.features
        ctx.score_prep = plane.spawn(
            "score_prep",
            lambda: build_scoring_prep(feats, corpus.doc_names, corpus.vocab,
                                       ctx.dsource),
            stage=Stage.SCORE.value)
    t0 = time.perf_counter()
    counts0 = kernel_counts()
    held: dict = {}
    if ctx.online:
        if ctx.eval_holdout:
            raise ValueError("--eval-holdout is batch-mode only")
        progress = None
        if ctx.journal is not None:
            def progress(info, journal=ctx.journal):
                # The em_ll stream batch EM writes, with the step's rho
                # as its third column (conv has no online analogue).
                journal.append({"kind": "em_ll", "iter": int(info.step),
                                "ll": float(info.likelihood),
                                "rho": float(info.rho)})
        result = train_corpus_online(corpus, ctx.config.online_lda,
                                     out_dir=ctx.day_dir, progress=progress,
                                     device=ctx.device)
        em_s = time.perf_counter() - t0
        rec = online_record(result, counts0, ctx.device, em_s,
                            corpus.num_docs)
    else:
        progress = ctx.journal.em_likelihood if ctx.journal else None
        if ctx.eval_holdout:
            result, held = _train_with_holdout(ctx, corpus, progress)
        else:
            # With checkpoints off, out_dir=None turns off likelihood.dat
            # and checkpoint.npz too: the journal's em_ll stream is the
            # run's record of the fit.
            out_dir = ctx.day_dir if (plane is None or plane.checkpoints) \
                else None
            result = train_corpus(corpus, ctx.config.lda, out_dir=out_dir,
                                  save_final=False, device=ctx.device,
                                  initial_log_beta=ctx.initial_log_beta,
                                  progress=progress)
        em_s = time.perf_counter() - t0
        rec = dict(lda_record(result, counts0, ctx.device), em_s=em_s,
                   em_docs_per_s=corpus.num_docs * result.em_iters / em_s)
    writes = _model_writes(corpus, result)
    if streamline:
        _demote_lda_artifacts(ctx, writes)
    elif mesh.is_coordinator():
        # A multi-process run's model is the same on every rank; the
        # shared day dir has one writer.
        for name, write in writes.items():
            # train_corpus_online wrote final.* (and likelihood.dat).
            if not (ctx.online and name.startswith("final.")):
                atomic_write(ctx.path(name), write)
    ctx.corpus, ctx.result = corpus, result
    rec["corpus"] = corpus_src
    if ctx.eval_quality and mesh.is_coordinator():
        rec.update(_completion_score(ctx, result.log_beta, result.alpha,
                                     corpus))
    rec.update(held)
    return rec


def _model_writes(corpus: Corpus, result) -> dict:
    """{file name: write(path)} of the lda stage's model files."""
    k, v = result.log_beta.shape
    return {
        "final.beta": lambda p: formats.write_beta(p, result.log_beta),
        "final.gamma": lambda p: formats.write_gamma(p, result.gamma),
        "final.other": lambda p: formats.write_other(p, k, v, result.alpha),
        "doc_results.csv": lambda p: formats.write_doc_results(
            p, corpus.doc_names, result.gamma),
        "word_results.csv": lambda p: formats.write_word_results(
            p, corpus.vocab, result.log_beta),
    }


def _demote_lda_artifacts(ctx: RunContext, writes: dict) -> None:
    """The model files as background checkpoints overlapping the score
    stage (the same bytes as the serial writes, each published by
    tmp+rename): final.* as one task, each results CSV as its own."""
    plane = ctx.plane

    def write_final():
        for name in ("final.beta", "final.gamma", "final.other"):
            atomic_write(ctx.path(name), writes[name])

    plane.checkpoint("final_model", write_final, stage=Stage.LDA.value)
    for task, name in (("doc_results", "doc_results.csv"),
                       ("word_results", "word_results.csv")):
        plane.checkpoint(task, lambda name=name: atomic_write(
            ctx.path(name), writes[name]), stage=Stage.LDA.value)


def _train_with_holdout(ctx: RunContext, corpus: Corpus, progress):
    """--eval-holdout FRAC: hash-split the documents by name BEFORE
    training, train beta on the remainder, and report the held-out
    per-token log-likelihood of the excluded split (models/evaluate.py:
    document completion) — valid for hyperparameter selection, unlike
    --eval-quality's training-day score, since beta never saw those
    documents.

    The file contract holds: final.gamma and doc_results.csv carry every
    document (the held-out rows inferred under the trained beta through
    the "xla" E-step, as the JAX runner does; the scorer needs a theta
    row per IP), and final.beta / likelihood.dat are the training
    split's fit."""
    import math

    from ..models.evaluate import hash_split, held_out_per_token_ll

    cfg = ctx.config.lda
    train_idx, held_idx = hash_split(corpus.doc_names, ctx.eval_holdout)
    if len(held_idx) == 0 or len(train_idx) == 0:
        raise ValueError(
            f"--eval-holdout {ctx.eval_holdout} split to "
            f"{len(train_idx)} train / {len(held_idx)} held-out docs of "
            f"{corpus.num_docs}; need both non-empty (tiny day?)"
        )
    result = train_corpus(corpus.select(train_idx), cfg,
                          out_dir=ctx.day_dir, save_final=False,
                          device=ctx.device,
                          initial_log_beta=ctx.initial_log_beta,
                          progress=progress)
    held_batches = make_batches(corpus.select(held_idx),
                                batch_size=cfg.batch_size,
                                min_bucket_len=cfg.min_bucket_len)
    score = held_out_per_token_ll(result.log_beta, result.alpha,
                                  held_batches,
                                  var_max_iters=cfg.var_max_iters,
                                  var_tol=cfg.var_tol, device=ctx.device)
    dev = ctx.device
    full_gamma = np.zeros((corpus.num_docs, result.gamma.shape[1]))
    full_gamma[train_idx] = result.gamma
    log_beta = torch.as_tensor(np.asarray(result.log_beta, np.float32),
                               device=dev)
    alpha = torch.tensor(result.alpha, dtype=torch.float32, device=dev)
    for b in held_batches:
        word_idx = torch.as_tensor(b.word_idx, device=dev)
        counts = torch.as_tensor(b.counts, dtype=torch.float32, device=dev)
        res = estep.e_step(
            log_beta, alpha, word_idx, counts,
            torch.as_tensor(b.doc_mask, dtype=torch.float32, device=dev),
            var_max_iters=cfg.var_max_iters, var_tol=cfg.var_tol,
            backend="xla",
            live=(sparse_estep.live_tokens(word_idx, counts)
                  if dev.type == "cuda" else None))
        sel = b.doc_mask == 1
        full_gamma[held_idx[b.doc_index[sel]]] = res.gamma.to(
            "cpu", torch.float64).numpy()[sel]
    full = LDAResult(log_beta=result.log_beta, gamma=full_gamma,
                     alpha=result.alpha, likelihoods=result.likelihoods,
                     em_iters=result.em_iters, plan=result.plan,
                     stats=result.stats)
    return full, {
        "held_out_frac": ctx.eval_holdout,
        "held_out_docs": int(len(held_idx)),
        "held_out_per_token_ll": score,
        "held_out_perplexity": math.exp(-score),
    }


def _completion_score(ctx: RunContext, log_beta, alpha,
                      corpus: "Corpus | None" = None) -> dict:
    """--eval-quality: the day's model scored by document completion
    (models/evaluate.py: gamma fit on each doc's even token slots, the
    odd slots scored).  Over the TRAINING day this is a drift-monitoring
    number comparable across days, optimistic against a true held-out
    split (--eval-holdout).  A resumed run whose lda stage was skipped
    reads the corpus from model.dat."""
    import math

    from ..models.evaluate import held_out_per_token_ll

    if corpus is None:
        corpus = Corpus.from_model_dat(ctx.path("model.dat"),
                                       ctx.path("words.dat"),
                                       ctx.path("doc.dat"))
    score = held_out_per_token_ll(
        log_beta, alpha, make_batches(corpus, ctx.config.lda.batch_size),
        device=ctx.device)
    return {"completion_per_token_ll": score,
            "completion_perplexity": math.exp(-score)}


def stage_score(ctx: RunContext) -> dict:
    """Scoring -> <dsource>_results.csv, by the resolved engine: the
    float64 host engine, or the device pipeline in chunks of
    pipeline.DEFAULT_CHUNK events, which records `score_dispatch` (also
    journaled as a `dispatch` record).  With the dataplane the event
    indices come from the prep that ran during EM (`prep`: "overlapped")
    and the results CSV is written in the background."""
    spec = sources.get(ctx.dsource)
    if ctx.features is not None:
        features, feat_src = ctx.features, "handoff"
    else:
        features, feat_src = load_features(ctx), "file"
    if not spec.matches_features(features):
        raise MissingArtifactError(
            f"{ctx.path('features.pkl')} holds a "
            f"{type(features).__name__}, not a {ctx.dsource} day; re-run "
            f"pre: `ml_ops {ctx.fdate} {ctx.dsource} --stages pre --force`")
    sc = ctx.config.scoring
    fallback = spec.fallback(sc)
    if ctx.result is not None:
        corpus, result = ctx.corpus, ctx.result
        model = ScoringModel.from_lda(corpus.doc_names, result.gamma,
                                      corpus.vocab, result.log_beta, fallback)
        model_src = "handoff"
    else:
        _require_artifacts(ctx, ["doc_results.csv", "word_results.csv"],
                           Stage.SCORE, Stage.LDA)
        model = ScoringModel.from_files(ctx.path("doc_results.csv"),
                                        ctx.path("word_results.csv"),
                                        fallback)
        model_src = "file"
    prep = None
    if ctx.score_prep is not None:
        # A long join here means the overlap did not hide the prep.
        with maybe_span("dataplane.prep_join"):
            prep = ctx.score_prep.result()
        ctx.score_prep = None
    engine = _score_engine(sc.engine)
    stats = DispatchStats() if engine == "device" else None
    blob, scores = spec.score_csv(features, model, sc.threshold,
                                  engine=engine, stats=stats,
                                  device=ctx.device, prep=prep)
    res_path = ctx.path(ctx.results_name())
    if ctx.plane is not None:
        # A product, not a checkpoint: written in the background, never
        # skipped.
        ctx.plane.output("results_csv",
                         lambda: atomic_write_bytes(res_path, blob),
                         stage=Stage.SCORE.value)
    else:
        atomic_write_bytes(res_path, blob)
    out = {"scored_events": features.num_raw_events,
           "flagged": int(len(scores)),
           "min_score": float(scores[0]) if len(scores) else None,
           "features": feat_src, "model": model_src, "engine": engine,
           "prep": "overlapped" if prep is not None else "inline"}
    if stats is not None:
        out["score_dispatch"] = stats.as_record()
        if ctx.journal is not None:
            ctx.journal.dispatch_stats(stats.as_record(), stage="score")
    return out


_STAGE_FNS = {
    Stage.PRE: stage_pre,
    Stage.CORPUS: stage_corpus,
    Stage.LDA: stage_lda,
    Stage.SCORE: stage_score,
}


def _run_stage(ctx: RunContext, stage: Stage, force: bool) -> None:
    """Run one stage, journaled begin and end.  Its old outputs and
    those of every later stage (made from them) are removed first: a run
    that dies mid-stage leaves the stage not done, and no later stage
    skips on outputs of an older run.  So is the EM checkpoint when the
    corpus is remade or a fresh fit is forced: only an lda stage rerun
    on the same corpus resumes from it.  A stage whose file inputs are
    missing fails before it removes anything (_require_inputs)."""
    if ctx.heartbeat is not None:
        # Fail cleanly at the stage boundary once the device is gone
        # (before touching any output): entering the stage would hang in
        # its first device call.
        ctx.heartbeat.check()
    _require_inputs(ctx, stage)
    stale = [name for later in STAGE_ORDER[STAGE_ORDER.index(stage):]
             for name in ctx.outputs(later)]
    if stage in (Stage.PRE, Stage.CORPUS) or (stage is Stage.LDA and force):
        stale.append(CHECKPOINT)
    if stage is Stage.PRE:
        stale.append(SPILL)
    if mesh.is_coordinator():
        for name in stale:
            if os.path.exists(ctx.path(name)):
                os.unlink(ctx.path(name))
    if mesh.process_count() > 1 and stage is Stage.LDA:
        # Every rank runs lda: none reads the day dir (an EM checkpoint)
        # before rank 0 has cleared it.
        from ..parallel.allreduce import get_collective

        get_collective().barrier("stage_clean")
    if ctx.journal is not None:
        ctx.journal.stage_begin(stage.value)
    t0 = time.perf_counter()
    try:
        with maybe_span(f"stage.{stage.value}", fdate=ctx.fdate,
                        dsource=ctx.dsource):
            info = _STAGE_FNS[stage](ctx)
    except BaseException as e:
        if ctx.journal is not None:
            ctx.journal.stage_end(stage.value, ok=False,
                                  wall_s=time.perf_counter() - t0,
                                  error=repr(e)[:300])
        raise
    wall_s = time.perf_counter() - t0
    ctx.record({"stage": stage.value, "wall_s": wall_s, **info})
    if ctx.journal is not None:
        ctx.journal.stage_end(stage.value, ok=True, wall_s=wall_s, **info)


def _coord_decision(value: bool) -> bool:
    """A per-stage decision made on rank 0 and broadcast, so ranks never
    desync on the files they see (a rank skipping a stage the others run
    would starve their reduce).  The broadcast is also the barrier
    between stages: the other ranks wait here for rank 0's writes."""
    if mesh.process_count() == 1:
        return value
    from ..parallel.allreduce import get_collective

    return bool(get_collective().broadcast_obj(bool(value),
                                               "stage_decision"))


def _all_ranks_ok(ok: bool) -> bool:
    """Every rank's outcome flag gathered: True only if every rank
    succeeded.  The wait polls the failure key, so a rank that posted a
    failure surfaces as PeerFailure here rather than a timeout."""
    if mesh.process_count() == 1:
        return ok
    from ..parallel.allreduce import get_collective

    return all(get_collective().allgather_obj(bool(ok), "stage_outcome"))


def _run_stages(ctx: RunContext, wanted, force: bool) -> None:
    """The stages in order.  In a multi-process run (--multihost) rank 0
    decides each run-or-skip and broadcasts it; pre, corpus and score run
    on rank 0 only, lda on every rank; then every rank's outcome is
    gathered, and a failure anywhere fails every rank (the failing rank
    posts it first, so ranks blocked inside the reduce see it too)."""
    multiproc = mesh.process_count() > 1
    is_coord = mesh.is_coordinator()
    for stage in STAGE_ORDER:
        if stage not in wanted:
            continue
        done = _stage_done(ctx, stage) if is_coord else None
        skip = bool(done) and not force
        if multiproc:
            skip = _coord_decision(skip)
        if skip:
            if not is_coord:
                continue
            record = {"stage": stage.value, "skipped": done}
            if stage is Stage.LDA and ctx.eval_quality:
                # The score needs only the saved model: a resumed run
                # still gets its day-quality number.
                record.update(_completion_score(
                    ctx, formats.read_beta(ctx.path("final.beta")),
                    formats.read_other(ctx.path("final.other"))["alpha"]))
            ctx.record(record)
            if ctx.journal is not None:
                ctx.journal.stage_skipped(stage.value, done)
            continue
        err: "Exception | None" = None
        if is_coord or stage is Stage.LDA:
            try:
                _run_stage(ctx, stage, force)
            except Exception as e:   # relayed to the other ranks below
                err = e
        if multiproc:
            from ..parallel.allreduce import PeerFailure, get_collective

            if err is not None and not isinstance(err, PeerFailure):
                get_collective().fail(f"stage {stage.value}: {err!r}")
            try:
                ok = _all_ranks_ok(err is None)
            except Exception as barrier_err:
                # The local error is the root cause: do not mask it.
                if err is not None:
                    raise err from barrier_err
                raise
            if not ok and err is None:
                raise PeerFailure(f"stage {stage.value} failed on another "
                                  "rank; aborting this rank")
        if err is not None:
            raise err


def _check_modes(dp: DataplaneConfig, stages, online: bool,
                 eval_quality: bool, eval_holdout: float) -> None:
    """The JAX runner's refusals of flag combinations, its messages."""
    if online and eval_holdout:
        raise ValueError("--eval-holdout is batch-mode only")
    if eval_quality and eval_holdout:
        # Together they would score the full corpus under a beta trained
        # on the remainder: neither flag's number.
        raise ValueError(
            "--eval-quality and --eval-holdout are mutually exclusive: "
            "use --eval-quality for drift monitoring (full-day training "
            "and scoring) or --eval-holdout for a true held-out score"
        )
    if not dp.checkpoints:
        # Checkpoints off is the pure-streaming mode: only a full
        # in-process batch chain is coherent without the file contract.
        if not dp.enabled:
            raise ValueError(
                "--no-checkpoints requires the streaming dataplane "
                "(drop --no-dataplane)"
            )
        if stages is not None:
            raise ValueError(
                "--no-checkpoints cannot run a --stages subset: without "
                "the file contract there is nothing for a partial run "
                "to read or resume from"
            )
        if online or eval_holdout:
            raise ValueError(
                "--no-checkpoints supports the plain batch pipeline "
                "only (the online/holdout trainers own their file "
                "contracts)"
            )


def run_pipeline(
    config: PipelineConfig,
    fdate: str,
    dsource: str = "flow",
    device=None,
    force: bool = False,
    stages: "list[Stage] | None" = None,
    initial_log_beta: "np.ndarray | None" = None,
    emit=print,
    online: bool = False,
    publish: "str | None" = None,
    eval_quality: bool = False,
    eval_holdout: float = 0.0,
) -> DayRun:
    """Run (or resume) one day.  Stages whose outputs exist are skipped
    unless `force`; `stages` restricts the run to a subset (run in
    pipeline order).  The records also go to metrics.json in the day
    directory, and every stage to run_journal.jsonl there unless
    config.telemetry.journal is off.  `online` trains by streaming SVI
    (config.online_lda); `eval_quality` / `eval_holdout` add the lda
    stage's quality numbers; `publish` copies the finished day directory
    to that destination (publish_day).  config.dataplane runs the
    streaming dataplane (the default) or the serial path; a background
    write that failed fails the run (RuntimeError naming it) after every
    other write has been joined.

    In a multi-process world (parallel.initialize_distributed) every rank
    calls this on one shared day dir: rank 0 runs pre, corpus and score
    and writes every file, the journal and metrics.json; the lda stage
    trains distributed on every rank (`_run_stages`).  The dataplane is a
    one-process plane: the ranks run the serial path."""
    if dsource not in sources.names():
        raise ValueError(f"dsource must be one of "
                         f"{'|'.join(sources.names())}, got {dsource!r}")
    dp = config.dataplane
    multiproc = mesh.process_count() > 1
    is_coord = mesh.is_coordinator()
    if multiproc and not dp.checkpoints:
        # The ranks meet through the files between stages.
        raise ValueError(
            "--no-checkpoints requires a single-process run: multi-host "
            "ranks coordinate through the inter-stage file contract")
    _check_modes(dp, stages, online, eval_quality, eval_holdout)
    dev = resolve_device(device)
    ctx = RunContext(config, fdate, dsource,
                     formats.ensure_dir(config.day_dir(fdate)), dev,
                     initial_log_beta, emit, online=online,
                     eval_quality=eval_quality, eval_holdout=eval_holdout)
    wanted = stages or STAGE_ORDER
    ctx.wanted = list(wanted)
    tel = config.telemetry
    if tel.journal and is_coord:
        jpath = ctx.path("run_journal.jsonl")
        replayed = Journal.replay(jpath)
        prior_done = RunJournal.completed_stages(replayed)
        ctx.prior_no_checkpoints = any(
            r.get("kind") == "run_start" and r.get("checkpoints") is False
            for r in replayed)
        ctx.journal = RunJournal(
            Journal(jpath, fsync_every=tel.journal_fsync_every))
        ctx.journal_done = set() if force else prior_done
        ctx.journal.run_start(force=force, fdate=fdate, dsource=dsource,
                              stages=[Stage(s).value for s in wanted],
                              journal_done=sorted(prior_done),
                              checkpoints=dp.checkpoints)
        ctx.recorder = Recorder(journal=ctx.journal.journal)
    if tel.heartbeat_s > 0:
        ctx.heartbeat = HeartbeatMonitor(
            interval_s=tel.heartbeat_s, journal=ctx.journal,
            probe=lambda t: device_add_probe(t, device=dev),
            recorder=ctx.recorder).start()
    if dp.enabled and not multiproc:
        ctx.plane = Dataplane(
            dp, recorder=ctx.recorder,
            journal=ctx.journal.journal if ctx.journal is not None else None)
    roofline0 = roofline.emit_count()
    ok = False
    run_err: "BaseException | None" = None
    plane_record = None
    background_errs: list = []
    try:
        with (use_recorder(ctx.recorder) if ctx.recorder is not None
              else contextlib.nullcontext()):
            _run_stages(ctx, wanted, force)
        ok = True
    except BaseException as e:
        run_err = e
        raise
    finally:
        if ctx.plane is not None:
            # Every background write and task joins before the day
            # directory is handed on, on a failing run too.
            plane_record = ctx.plane.drain()
            background_errs = ctx.plane.errors
        if ctx.heartbeat is not None:
            ctx.heartbeat.stop()
        if ctx.journal is not None:
            err = run_err if run_err is not None else (
                background_errs[0][1] if background_errs else None)
            ctx.journal.run_end(
                ok=ok and not background_errs,
                **({} if err is None else {"error": repr(err)[:300]}))
            ctx.journal.close()
    if background_errs:
        name, first = background_errs[0]
        raise RuntimeError(
            f"dataplane background write/task {name!r} failed") from first
    if not dp.checkpoints and os.path.exists(ctx.path(SPILL)):
        # The featurizer's scratch: only this run's score stage read it.
        os.unlink(ctx.path(SPILL))
    records = roofline.emitted_records(since=roofline0)
    if records:
        # Into metrics.json only (stdout keeps one line per stage).
        ctx.metrics.append({"fdate": fdate, "dsource": dsource,
                            "stage": "roofline", "records": records})
    if plane_record is not None and (plane_record["tasks"]
                                     or plane_record["edges"]):
        # Each background task's wall by stage, each channel's stalls
        # (metrics.json only, as the roofline).
        ctx.metrics.append({"fdate": fdate, "dsource": dsource,
                            "stage": "dataplane", **plane_record})

    def dump_metrics():
        with open(ctx.path("metrics.json"), "w") as f:
            json.dump(ctx.metrics, f, indent=1)

    if not is_coord:
        return DayRun(ctx.metrics, ctx.features, ctx.corpus, ctx.result)
    # metrics.json lands before the publish, so the delivered day carries
    # it and a failed delivery cannot lose it.
    dump_metrics()
    if publish:
        t0 = time.perf_counter()
        info = publish_day(ctx.day_dir, publish)
        ctx.record({"stage": "publish",
                    "wall_s": time.perf_counter() - t0, **info})
        dump_metrics()
    return DayRun(ctx.metrics, ctx.features, ctx.corpus, ctx.result)


def publish_day(day_dir: str, dest: str) -> dict:
    """Deliver the finished day directory to the analysts' side: the
    reference's final `scp -r ${LPATH} ${UINODE}:${RPATH}`.  `dest` is a
    local or mounted directory (copied with shutil, over an earlier
    delivery) or an scp-style `host:path`; a failed scp raises with its
    stderr."""
    name = os.path.basename(os.path.normpath(day_dir))
    if ":" in dest.split(os.sep, 1)[0]:
        import subprocess

        proc = subprocess.run(["scp", "-r", day_dir, dest],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"publish to {dest} failed (rc={proc.returncode}): "
                f"{proc.stderr.strip()[-500:]}")
        return {"published": f"{dest}/{name}", "transport": "scp"}
    import shutil

    target = os.path.join(dest, name)
    shutil.copytree(day_dir, target, dirs_exist_ok=True)
    return {"published": target, "transport": "copy"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oni_ml_tpu_torch.runner.ml_ops",
        description="oni_ml_tpu_torch day on the GPU "
        "(replaces ml_ops.sh YYYYMMDD flow|dns TOL)",
    )
    p.add_argument("fdate", help="day to analyze, YYYYMMDD")
    p.add_argument("dsource", choices=list(sources.names()))
    p.add_argument("tol", nargs="?", type=float,
                   default=float(os.environ.get("TOL", 1.1)),
                   help="suspicion threshold (ml_ops.sh defaults TOL=1.1)")
    p.add_argument("--data-dir", default=None, help="working dir (LPATH)")
    p.add_argument("--flow-path", default=None,
                   help="netflow CSV input: file, directory, glob, or "
                   "comma-separated list (FLOW_PATH)")
    p.add_argument("--dns-path", default=None,
                   help="DNS input: CSV (or parquet) file, directory, glob, "
                   "or comma-separated list (DNS_PATH)")
    p.add_argument("--proxy-path", default=None,
                   help="proxy/HTTP log CSV input, same forms (PROXY_PATH)")
    p.add_argument("--top-domains", default=None,
                   help="top-1m.csv path (the DNS whitelist)")
    p.add_argument("--qtiles", default=None,
                   help="precomputed flow quantile cuts file (flow_qtiles "
                   "format, features/qtiles.py); skips the in-run ECDF pass "
                   "and pins word identity across days")
    p.add_argument("--pre-workers", type=int, default=0, metavar="N",
                   help="pre-stage shard workers: each day file split into "
                   "line-aligned byte ranges featurized concurrently, with a "
                   "first-seen merge keeping every output byte-identical to "
                   "the sequential pass (0 = auto from the host's cores, 1 = "
                   "sequential)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the LDA stage (default cuda; a machine "
                   "without one raises unless --device cpu)")
    p.add_argument("--topics", type=int, default=20)
    p.add_argument("--alpha", type=float, default=2.5)
    p.add_argument("--em-max-iters", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save (beta, alpha, iteration) every N EM "
                   "iterations to checkpoint.npz; an interrupted lda stage "
                   "resumes from it (0 = off)")
    p.add_argument("--dup-factor", type=int, default=None,
                   help="feedback duplication (default: DUPFACTOR env or 1000)")
    p.add_argument("--warm-start", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="seed each EM iteration's fixed point from the "
                   "previous gamma")
    p.add_argument("--stages", default=None,
                   help="comma-separated subset of pre,corpus,lda,score")
    p.add_argument("--force", action="store_true",
                   help="re-run stages whose outputs exist")
    p.add_argument("--no-journal", action="store_true",
                   help="do not write run_journal.jsonl")
    p.add_argument("--heartbeat", type=float, default=0.0, metavar="SECS",
                   help="probe device liveness every SECS seconds on a "
                   "background thread (a tiny add on the device, "
                   "journaled); a device that stops answering becomes a "
                   "clean BackendLost failure at the next stage boundary "
                   "(exit 3) instead of a hang (0 = off)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the whole run "
                   "(CPU and, on the card, CUDA activity) to "
                   "DIR/<fdate>.<dsource>.trace.json (Chrome trace JSON)")
    p.add_argument("--eval-quality", action="store_true",
                   help="score the day's model by document completion "
                   "(per-token log-likelihood / perplexity on each doc's "
                   "odd token slots; models/evaluate.py) and record it in "
                   "the lda stage metrics — a drift-monitoring number "
                   "comparable across days, optimistic vs a true held-out "
                   "split")
    p.add_argument("--eval-holdout", type=float, default=0.0,
                   metavar="FRAC",
                   help="hash-split FRAC of documents out BEFORE training, "
                   "train beta on the remainder, and record the held-out "
                   "per-token log-likelihood of the excluded split in the "
                   "lda stage metrics.  doc_results.csv still covers every "
                   "document (held-out docs get their theta inferred under "
                   "the trained beta).  Batch mode only; mutually exclusive "
                   "with --eval-quality")
    p.add_argument("--online", action="store_true",
                   help="streaming (stochastic variational) LDA instead of "
                   "batch EM")
    p.add_argument("--eta", type=float, default=0.01,
                   help="online: topic-word Dirichlet prior")
    p.add_argument("--tau0", type=float, default=64.0,
                   help="online: learning-rate delay")
    p.add_argument("--kappa", type=float, default=0.7,
                   help="online: learning-rate decay exponent")
    p.add_argument("--publish", default=None, metavar="DEST",
                   help="after all stages complete, deliver the day "
                   "directory to DEST: a local/NFS path (copied) or an "
                   "scp-style host:path — the reference's final scp to "
                   "the UI node")
    p.add_argument("--no-dataplane", action="store_true",
                   help="disable the streaming dataplane (dataplane/): "
                   "every stage writes its artifacts inline.  Artifacts are "
                   "byte-identical either way; the dataplane only changes "
                   "when files land and what the stages read")
    p.add_argument("--multihost", action="store_true",
                   help="distributed EM over rank processes (the "
                   "reference's mpiexec fan-out, minus MPI): start one "
                   "process per rank with torchrun's variables "
                   "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; "
                   "LOCAL_RANK picks cuda:(LOCAL_RANK mod the cards), "
                   "so on one card every rank shares it), e.g. "
                   "`torchrun --nproc-per-node 2 -m "
                   "oni_ml_tpu_torch.runner.ml_ops ... --multihost`.  "
                   "Each rank trains its own document shards on its own "
                   "device and the beta/alpha sufficient statistics "
                   "cross processes through an explicit allreduce (a ring "
                   "over the rendezvous store).  Needs --data-dir on a "
                   "filesystem every rank sees: rank 0 is the one writer, "
                   "the others read its stage outputs and join the reduce")
    p.add_argument("--em-shards", type=int, default=0, metavar="N",
                   help="distributed EM's document shard count (0 = auto: "
                   "8, grown to cover the process count).  The shard plan "
                   "and the reduction tree derive from the corpus and N, "
                   "not the rank count, so runs at different rank counts "
                   "with the same N write byte-identical files "
                   "(ONI_ML_TPU_EM_SHARDS overrides)")
    p.add_argument("--no-checkpoints", action="store_true",
                   help="skip the inter-stage checkpoint files entirely "
                   "(features.pkl, word_counts.dat, words/doc/model.dat, "
                   "final.*, likelihood.dat, doc/word_results.csv): the run "
                   "writes only its products (results CSV, metrics.json, "
                   "run_journal.jsonl), and a later --stages resume against "
                   "such a day is refused.  Full-chain batch runs only")
    return p


@contextlib.contextmanager
def _profiled(out_dir: "str | None", device: str, name: str):
    """A torch.profiler trace of the block, exported as Chrome trace
    JSON to out_dir/name when the block completes (nothing when
    out_dir is None)."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, name))


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # `ml_ops serve ...` is the streaming scoring service
    # (runner/serve.py): a long-running process over a completed day's
    # artifacts, not a fifth stage, so it routes before the YYYYMMDD
    # parser.
    if argv and argv[0] == "serve":
        from . import serve

        return serve.main(argv[1:])
    # `ml_ops continuous ...` is the standing service (runner/
    # continuous.py): replayed or live slices, window refreshes and
    # gated publishes, routed here for the same reason.
    if argv and argv[0] == "continuous":
        from . import continuous

        return continuous.main(argv[1:])
    # `ml_ops replica ...` / `ml_ops route ...` are the replicated
    # serving fleet (runner/route.py): serve replica processes behind an
    # async router with consistent-hash placement and shadow-promotion
    # failover; long-running services, routed here like serve.
    if argv and argv[0] == "replica":
        from .route import replica_main

        return replica_main(argv[1:])
    if argv and argv[0] == "route":
        from .route import route_main

        return route_main(argv[1:])
    p = build_parser()
    args = p.parse_args(argv)
    if len(args.fdate) != 8 or not args.fdate.isdigit():
        p.error("fdate must be YYYYMMDD")
    try:
        stages = ([Stage(s) for s in args.stages.split(",")]
                  if args.stages else None)
    except ValueError as e:
        p.error(str(e))
    env = os.environ
    config = PipelineConfig(
        data_dir=args.data_dir or env.get("LPATH", "."),
        flow_path=args.flow_path or env.get("FLOW_PATH", ""),
        dns_path=args.dns_path or env.get("DNS_PATH", ""),
        proxy_path=args.proxy_path or env.get("PROXY_PATH", ""),
        top_domains_path=args.top_domains or "",
        qtiles_path=args.qtiles or "",
        pre_workers=args.pre_workers,
        lda=LDAConfig(
            num_topics=args.topics, alpha_init=args.alpha,
            em_max_iters=args.em_max_iters, batch_size=args.batch_size,
            seed=args.seed, warm_start_gamma=args.warm_start,
            checkpoint_every=args.checkpoint_every,
            em_shards=args.em_shards,
        ),
        online_lda=OnlineLDAConfig(
            num_topics=args.topics, alpha=args.alpha, eta=args.eta,
            tau0=args.tau0, kappa=args.kappa, batch_size=args.batch_size,
            seed=args.seed, checkpoint_every=args.checkpoint_every,
        ),
        feedback=FeedbackConfig(
            dup_factor=(args.dup_factor if args.dup_factor is not None
                        else int(env.get("DUPFACTOR", 1000)))
        ),
        scoring=ScoringConfig(threshold=args.tol),
        telemetry=TelemetryConfig(journal=not args.no_journal,
                                  heartbeat_s=args.heartbeat),
        dataplane=DataplaneConfig(enabled=not args.no_dataplane,
                                  checkpoints=not args.no_checkpoints),
    )
    if args.multihost:
        mesh.initialize_distributed(device=args.device)
    try:
        with _profiled(args.profile, args.device,
                       f"{args.fdate}.{args.dsource}.trace.json"):
            run_pipeline(config, args.fdate, args.dsource,
                         device=args.device, force=args.force,
                         stages=stages, online=args.online,
                         publish=args.publish,
                         eval_quality=args.eval_quality,
                         eval_holdout=args.eval_holdout)
    except BackendLost as e:
        # The heartbeat's point: a dead device exits as a structured,
        # journaled failure, not a hang.  So does a distributed run that
        # failed on another rank (PeerFailure).
        print(json.dumps({"fdate": args.fdate, "dsource": args.dsource,
                          "error": "backend_lost", "detail": str(e)}),
              flush=True)
        return 3
    except MissingArtifactError as e:
        print(json.dumps({"fdate": args.fdate, "dsource": args.dsource,
                          "error": "missing_artifact", "detail": str(e)}),
              flush=True)
        return 2
    finally:
        if args.multihost:
            mesh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
