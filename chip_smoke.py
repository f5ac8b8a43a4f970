"""Smoke run of the oni_ml_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build     compile the port's CUDA libraries from csrc/, one nvcc each
             (the bf16 instantiations are libraries of their own, from
             the same sources: ops/_cuda.py VARIANTS), and its C++ host
             libraries from native_src/, one g++ each
             (native_build.py), all in parallel; print the host's cores
             and `g++ --version`.
2. parity    each kernel against its plain PyTorch version on the card,
             at the flow day's shapes, fresh and warm starts (the dense
             E-step in both layouts, at the main shape and on long
             documents, where a block's cell lists overflow to the
             device-memory scratch; the sparse E-step and the fixed
             point at the main shape, on long documents and at B=2,
             L=16,384, where a cluster of 8 CTAs takes each document),
             with the tolerances below; two launches of each E-step
             kernel must give the same bits; each record carries the
             launch geometry; time both (CUDA events), compute the
             card's bound for the same work and, for the sparse E-step
             and the fixed point, time two torch.bmm per iteration as a
             library yardstick.  Each case's cap on fixed-point iterations
             lies above what most blocks need, so the per-block stop
             decision is compared too.  The bf16 storage mode
             (precision "bf16", `--dense-precision bf16`) the same way,
             fresh starts: the sparse E-step over the bf16 table at the
             three shapes, the dense E-step over a bf16-stored corpus at
             the main shape in both layouts, on long documents and at
             B=2, L=16,384, each with its bound at bf16 bytes and, as
             its library yardstick, two torch.bmm (sparse) or cuBLAS
             products (dense) on bf16 operands per iteration.
3. e2e       a small synthetic flow day and a small synthetic DNS day
             through the port's entry point on the card and on the CPU
             (plain versions), with each ONI_ML_TPU_ESTEP value (sparse,
             dense, pallas, xla, compact): the EM trajectories must
             agree; and twice on the card with each: final.* must be the
             same bytes.  The same for a small proxy day under the
             default engine.
4. pipeline  a 2,000,000-event synthetic flow day through the port's
             entry point on the card, its engine from the measured
             dense-vs-sparse crossover (a fresh plan cache, so the run
             measures; resolved again, the plan serves it: `crossover`
             line); every artifact must exist and parse.  Then the same
             corpus trained with the dense engine and with
             ONI_ML_TPU_ESTEP=pallas (the per-batch dispatch through the
             fixed-point kernel) through train_corpus, each scored.
             Each path's kernels must have launched on it (the counts
             are zeroed just before each and read just after).  Then the
             corpus in the bf16 mode with the sparse engine and with the
             dense family: each path's bf16 instantiation launched (every
             launch of its kernel), its final likelihood within rel 5e-3
             of the f32 run of the same engine (the JAX package's bf16
             against f32 bound for the sparse E-step; over a fit the
             dense one compounds, see RTOL_BF16_FIT_LL); from the f32
             dense fit's model, one dense E-step over the day in both
             modes within the JAX dense likelihood bound (1e-3).  And
             the small flow day through `ml_ops.main([...,
             "--dense-precision", "bf16"])`, its engine from a bf16
             crossover: the record names bf16, the member's bf16
             instantiation launched, the final likelihood within 5e-3
             of e2e's f32 card run of the same engine.
5. pipeline_dns  a 2,000,000-event synthetic DNS day (the JAX bench's
             shape: 20,000 clients, 5,000 domains, seed 13) through
             `ml_ops.main([... "dns" ...])` on the card, its engine from
             the crossover measured in a fresh plan cache: stage walls,
             EM docs/s, V, the engine and member with their sources, the
             crossover's times, each kernel's launches enqueued and run;
             the member's kernels must have launched.  Then 20 EM
             iterations of that engine over the day's corpus, profiled
             (ms per iteration, device idle share).
   score_device  the device scoring engine on both 2M-event days:
             `--stages score` under ONI_ML_TPU_SCORE=device, then host,
             at a threshold that keeps about 0.1% of the day: score walls,
             the DispatchStats and the chunk loop's roofline record; the
             survivors must be the host engine's (but for counted events
             on the float32 threshold boundary), featurized columns
             byte-equal, scores within rel 1e-6, in host order up to
             float32 ties.  Then chunked_scores at two chunk sizes must
             equal device_scores in one dispatch bit for bit.
   native_pre  the native C++ pre path against the Python one
             (ONI_ML_TPU_NO_NATIVE=1) on the card's host: the 2M-event
             flow day's `--stages pre,corpus` in Python and natively at
             --pre-workers 1 write the pipeline run's word_counts.dat,
             words.dat, doc.dat and model.dat (native, workers auto); its
             score stage resumed in Python at score_device's threshold
             writes the native day's flow_results.csv; the small flow and
             DNS days (sparse pinned) write every file alike.  Prints the
             pre walls of both paths and the resumed score walls.  The 2M
             days' `pipeline` / `pipeline_dns` lines carry the pre
             engine, its workers and the pass walls, and must have run
             native.
   plans     the plan cache (plans/, tools/) on the card: the four
             probes into the phase's own store, each under a wall budget
             (em_chunk_probe at the bench shape K=20, V=8192, B=4096,
             L=128; estep_probe at densities 1% and 5%; score_probe at
             400,000 events; pre_probe over the 2M flow day at workers
             1, 8 and auto), each recording its knobs, which `plan_cache
             show` lists; then the small flow day (sparse pinned) in a
             fresh process on that store, started at the phase's end
             and joined after `dataplane` (`plans_rerun`): zero sweeps,
             fused_em_chunk and pre_workers from the plan; and with
             --no-plans --no-compilation-cache in a process started
             after small_days: plans off, 3 or more libraries built
             cold, the same bytes as the plan run and e2e's sparse card
             run.
6. resume    on the small flow day with the sparse engine pinned:
             `--stages pre,corpus` then `--stages lda,score` must write
             the one-shot card run's bytes; an EM fit cut at iteration 3
             with checkpoint_every 1 and resumed to 6 must equal the
             uninterrupted card fit (warm start off), under both
             drivers.
   telemetry the small flow day plain and with `--heartbeat 1
             --profile DIR`: final.* byte-equal; the journal holds stage
             spans, em.host_sync spans, one estep_crossover record and
             heartbeats; metrics.json an em.run_chunk roofline record
             with utilization under 100%; DIR a Chrome trace with CUDA
             kernel events.
   dataplane the 2M-event flow and DNS days through ml_ops.main by
             default (the streaming dataplane) and with --no-dataplane,
             the engine pinned to the crossover's pick
             (ONI_ML_TPU_ESTEP_ENGINE): every artifact the same bytes;
             both runs' stage walls, day walls (the stage walls and the
             plane's drain), run walls (the host clock around the call)
             and the plane's record (background task walls by stage, channel stalls).
             The small flow and DNS days with --no-dataplane write the
             e2e phase's (dataplane) card bytes; --no-checkpoints on the
             small flow day writes only the results CSV, metrics.json and
             the journal, and a `--stages score --force` run then stops
             with exit 2 naming features.pkl, the results kept.
   online    streaming SVI (train_corpus_online, K 20, batch 1024) over
             the 2M flow day's corpus three ways: dense_em auto (the
             dense kernel per micro-batch), off (the sparse kernel) and
             off under ONI_ML_TPU_ESTEP=pallas (the fixed point): each
             run's launches (counts zeroed just before, read just after:
             the member's kernel once per micro-batch, the inference
             pass's per-batch kernel and the scatter once per batch),
             wall, micro-batches and documents per second.  On the small
             flow day's corpus (dense_em on): card against CPU (per-step
             likelihood, final beta) within 1e-4, two card runs the same
             bits, step_many against sequential step() within the online
             tests' bounds.
   eval      --eval-quality and --eval-holdout 0.1 on the small flow day
             on the card and on the CPU: completion and held-out
             per-token likelihoods within RTOL_E2E; the card's quality run
             with --publish DIR: DIR/<fdate> holds the day's bytes.
   serve     `ml_ops serve` over the 2M flow and DNS days' models, each
             streamed 40,960 raw events of its own input: refresh off,
             the first 32,768 with every flush on the host (bit-equal to
             the day's own scores over features.pkl) and with every flush
             on the card (rel 1e-6); then all of them at the ServingConfig
             defaults (calibrated dispatch) with a refresh every 8
             flushes, in process (the kernels' counts zeroed just before,
             read just after: the dense kernel, the sparse kernel and the
             scatter once each per refresh) and through the CLI as a
             subprocess (exit 0, every event scored once, >= 2 model
             versions served, an OpenMetrics file): the calibration,
             events/s, flush latency p50/p99 by path, refresh walls.  On
             the flow day, 9 flushes served with the refresh trainer's
             dense_em off, once on the sparse kernel and once under
             ONI_ML_TPU_ESTEP=pallas (counts zeroed and read around
             each).  On each day, the stream's first 8 flushes of
             evidence through one refresh on the card and on the CPU per
             member (dense, and the per-batch sparse and fixed point): p
             and theta within rel 1e-4 of the CPU's on every nonzero
             entry, their median entry moved from the day's by more,
             each member's launches.  `serve --dry-run` on cuda.
   fleet     `serve --fleet` on the card: nine tenants (the 2M flow and
             DNS days' models, three perturbed variants of each, and a
             K=10 model trained here on the small flow day), 147,456 raw
             events interleaved across them.  The defaults (device
             featurize engine, calibrated dispatch), each tenant
             refreshing every 8 of its flushes: every tenant's scores
             bit-equal to its events scored alone on the model version
             that served them, exactly once, >= 2 versions per tenant,
             the refresh kernels' launches counted.  Every dispatch on
             the card (rel 1e-6); the fused engine on single-tenant
             K-groups (rel 1e-6, its call's ms beside the calibrated
             dispatch); --hot-tenants 4 --warm-tenants 2 with a spill
             dir, LRU then LFU (promotions, evictions, a tenant paged
             cold and back, every score its own model's); a bf16 stack
             (half the device bytes, within 2^-7 of the f32 stack's);
             the per-batch refresh members (sparse, fixed point);
             measure_break_even recorded in the run's plan cache; the
             CLI over the two day dirs with 8 tenant names; `serve
             --dry-run --fleet synthetic:4` on cuda.
7. profile   6 EM iterations over the flow day's corpus four ways (sparse
             engine under the chunk driver, sparse under the stepwise
             driver, dense and per-batch pallas under the chunk driver):
             wall without the
             profiler, device-busy time, the kernels that take it and
             the host ops under torch.profiler — for the whole fit and,
             under the chunk driver, for the EM loop alone.  Then, at
             the pipeline's settings, what the iterations enqueued after
             the device stop cost (each engine), and the sparse fit
             under each driver.  Then the sparse [V, K] scatter over the
             day's batches against index_add_.

   continuous  `ml_ops continuous` on the card (runner/continuous.py):
             (1) the small flow day's first event hour in 300-s slices
             at the ContinuousConfig defaults through ContinuousService
             on the card and on the CPU, pinned to the sparse engine, the
             dense engine (under the chunk driver, fused_em_chunk 16) and
             ONI_ML_TPU_ESTEP=pallas: the same (mode, published, drifted,
             version) sequence, held-out ll within rel 1e-4 at every
             refresh, the same flagged events but for float32 ties at the
             threshold, each pinned kernel launched on the card; (2) the
             2M flow day's first 6 event hours at the defaults with the
             fresh control and the quality gate, the engine from the
             crossover: a warm refresh past the warm-up boundary, the
             fresh control run, no build past the boundary, the sparse
             kernel and scatter launched; (3) the 2M flow and DNS days'
             first 3 event hours interleaved and paced at 240x event time
             through the in-process fleet with and without the
             co-scheduler, every tenant scoring in both (each tenant's
             first fit: its wall, summed yield wait and where the
             co-scheduler's first-fit bound acted); (4) the CLI as two
             subprocesses at once (single tenant, two --stream tenants),
             the refusal of --multihost with --stream (exit 2).  Every
             run: exactly once (scored + rejected + unserved before the
             first publish = ingested, scored = offered), no failed
             future, no refresh error or refresh_abandon record.  Prints
             events/s, refreshes, publishes, vetoes, quality checks,
             warm and fresh fit walls and EM iterations, the fresh
             control's speedup and ll delta, freshness (wall s, event
             min), serve p99 idle against during refresh, coalesced
             refreshes, vocab and tiers, retraces_after_warmup and each
             refresh's engine.
   replicated  `ml_ops route` on the card (runner/route.py): six tenants
             (three names over the 2M flow day's model, three over the
             DNS day's), 30,000 of their raw events interleaved on stdin
             of `route --replicas 3 --device cuda --device-score-min 1
             --kv-listen 127.0.0.1:0 --autoscale --max-inflight 32`
             (every flush of the spawned replica processes on the card,
             the replicas joined through the route process's TCP KV,
             their links on shared-memory rings, the autoscaler at its
             default band over windows of 32 events a replica, which
             the flood fills), a rolling redeploy halfway: exit 0,
             every event resolved once, no error, every link on rings,
             an autoscale "up" and no "error" decision, an autoscaled
             replica that scored events, each replica process on cuda
             by its own stats reply (with its peak device memory).  Then
             a FleetRouter over 3 in-process ReplicaServers on cuda: a
             replica killed with half the stream in flight, its tenants
             promoted to their shadows, zero failed futures; one tenant
             refreshed on the card by RefreshLoop (dense step and sparse
             inference, then the fixed point under
             ONI_ML_TPU_ESTEP=pallas), each published through the router
             to primary and shadow; the card's scores within rel 1e-6 of
             the float64 host scorer's before and after each publish.
             Then `continuous --replicated 2` in this process
             (FleetContinuousService(replicated=2) on cuda): the 2M flow
             and DNS days' first 2 event hours paced as continuous part
             3, two replica processes on cuda scoring every flush on the
             card over rings, the flow tenant's primary SIGKILLed while
             a refit is active: exactly once, zero failed futures, a
             failover, both tenants scored, the binding's versions the
             router's, no refresh error, the refits' kernels launched
             here; and the first hour again over TCP (wire_shm off)
             without the kill, its first refits against the ring run's.
             Every ring segment the phase's links named is gone after
             it (/dev/shm's other entries are only counted).  Prints events/s, route
             latency p50/p99, the failover gap, the redeploy wall, the
             autoscale decisions, each replica's peak device memory, the
             refresh walls, the first refit walls with rings and over TCP, the
             first publish's lead before the stream's end and the
             kernels' launches.
   multihost `ml_ops --multihost` (distributed EM over rank processes,
             each its own CUDA context on the one card, torchrun's
             variables): the 2M flow day at --em-shards 8 as one rank
             (local transport), two ranks (kvring) and one rank with
             the NCCL transport named (ONI_ML_TPU_ALLREDUCE=psum), one
             world after the other: final.*, likelihood.dat and the
             results CSVs the same bytes in all three, each world on
             its own transport, the likelihood at the last EM iteration
             both ran within rel 1e-4 of the serial pipeline run's.
             Then at once: the small flow day --online on two ranks and
             on one (per micro-batch within rel 1e-4), on two ranks
             pinned to the dense kernel and to the fixed point, and
             `continuous --multihost` on two ranks over the small day's
             first 3 event hours (both ranks publish, the same model
             digests refresh for refresh).  Every world's ranks agree
             (the trainers check their models' bits); every kernel
             launched in the rank processes (each counts its own).
             Prints per rank the stage walls, EM iterations and wall,
             launches, allreduce ops, bytes and wait.
   mesh      the single-process device mesh (`--mesh DATA,MODEL`,
             parallel/mesh.py, sharded.py), its slots all on the one
             card (devices=[cuda:0] * N): on the 2M flow day's corpus,
             5 EM iterations, each member pinned (the per-batch sparse
             kernel with dense_em off, full-V dense with dense_em on,
             ONI_ML_TPU_ESTEP=pallas): one E-step at 1x1 against the
             unmeshed one (the JAX package's 1x1 bounds), the fit at
             1x1 against no mesh and at (2, 1) and (4, 1) against 1x1
             (likelihood rel 1e-4, beta atol 1e-4, gamma 1e-3, alpha
             rel 1e-4), two (4, 1) runs the same bytes, each member's
             kernels on every slot; the 2M DNS day (V 31,434)
             vocab-sharded at (2, 4), the sparse and the dense plan,
             against their 1x1 runs; the device scorer at (4, 1)
             bit-equal to the unmeshed scorer on the flow day's model,
             theta and p sent once; online SVI at (4, 1) against one
             slot (lambda 2e-4); `ml_ops ... --mesh 1,1` on the small
             flow day, `--mesh 2,2` refused with exit 2 and the JAX
             message, and two `--multihost --mesh 1,1` ranks against one
             at --em-shards 8, the same bytes.  Prints `wall mesh:`.

Then it prints the kernels line (each kernel with its launches on its
flow-day path, as `dns_launches` on the DNS day's, as
`online_launches` on its online run's, as `launches_serve` on the
served streams', as `launches_fleet` on the fleet's and as
`launches_continuous` on the continuous service's, as
`launches_replicated` on the replicated fleet's, as
`launches_multihost` on the rank processes', as `launches_mesh` on
the mesh phase's and as `launches_plans` on the plans phase's), the
card's name
and power limit, and last `{"ok": true, "device": {...}}`.  Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from oni_ml_tpu_torch import native_build  # noqa: E402
from oni_ml_tpu_torch.io import Corpus, formats, make_batches  # noqa: E402
from oni_ml_tpu_torch.ops import (  # noqa: E402
    _cuda, dense_estep, pallas_estep, sparse_estep)
from oni_ml_tpu_torch.runner.ml_ops import (  # noqa: E402
    ENGINE_KERNELS, executed_counts, kernel_counts, launch_counts,
    reset_kernel_counts)
from oni_ml_tpu_torch.telemetry import roofline  # noqa: E402

# Published H100 SXM peaks (telemetry/roofline.py, NVIDIA's data sheet):
# device-memory bytes/s and float32 (non-tensor-core) FLOP/s — the
# kernels' arithmetic is f32 FMA.
PEAK = roofline.H100_SXM

K, V = 20, 5_520
W = dense_estep.padded_width(V)              # 5,632
# Parity tolerances: gamma, phi_c and T rel 1e-4 (rcp.approx + one
# Newton step and another f32 summation order than the plain version),
# docll and ass rel 1e-5, and at most one fixed-point iteration of
# difference per block (the same arithmetic differences can move one
# stop decision, where a block's delta lands within f32 noise of
# var_tol).  Gamma is compared at RTOL_GAMMA in the blocks that stop at
# the same iteration; a block that stops one iteration apart differs by
# one fixed-point step, which the stop rule bounds: there the rule's own
# measure (mean |d gamma| over the doc's mean gamma) must stay under
# 2 var_tol, and at most MAX_MOVED_SHARE of the blocks may move.  The
# tail (phi_c or T, docll, ass) is compared with the plain tail on the
# kernel's own gamma.  The scatter is compared bit for bit.
RTOL_GAMMA = RTOL_PHIC = RTOL_T = 1e-4
RTOL_DOCLL = 1e-5
MAX_ITER_DIFF = 1
MAX_MOVED_SHARE = 0.05
# The dense kernel's bf16 instantiation against its plain version: both
# round each cell's ratio to bf16, from the kernel's Newton reciprocal
# and the plain version's exact divide, so a ratio lands one bf16 step
# (2^-8) apart now and then.  Rounded operands keep the fixed point's
# delta above var_tol, so its blocks stop at the stop rule's stall gate
# (delta under STALL_GATE and no longer falling), where that noise
# decides the iteration: a block may stop several iterations apart (5 at
# the main shape on the H100), and its gamma is settled only to the
# gate's step.  So each document is held by the stop rule's own measure
# (mean |d gamma| over its mean gamma) to (m + 1) gate steps, m the
# iterations its block stopped apart (its m extra steps and the noise
# before them), the iterations within BF16_ITER_DIFF; and the kernel's
# gamma must lie closer to the bf16 plain version's than to the f32
# plain version's by BF16_SEPARATION (median over documents), so the
# rounding did happen; the tail (T, docll, ass, f32 from the kernel's
# gamma) to the f32 bounds.  The sparse bf16 instantiation reads the
# same rounded table as its plain version, so the f32 bounds hold there.
STALL_GATE = 1e-2           # ops/stop.py STALL_GATE
BF16_ITER_DIFF = 10
BF16_MOVED_SHARE = 0.5
BF16_SEPARATION = 10.0
# The JAX package's bounds between its bf16 and f32 E-steps from one beta
# (tests/test_sparse_estep.py: likelihood 5e-3, gamma 2e-2;
# tests/test_dense_estep.py: likelihood 1e-3, gamma 5e-2, each rtol and
# atol, on a random beta).  The dense likelihood bound is held where it
# applies, on one E-step from the f32 dense fit's final model
# (bf16_dense_estep); its gamma bound is not: from a trained model the
# bf16 fixed point stops at the stall gate short of where f32 goes, and
# a document whose mass is split between topics moves more than 5e-2
# (measured on the CPU, the plain version, a 5,000-event day's model:
# likelihood 4.1e-6 apart, a gamma 0.65 past the bound).  A bf16 fit's
# final likelihood against the f32 fit of its engine is held to the
# larger, 5e-3: over a fit the dense bf16 fixed point's accuracy, which
# its stall gate bounds, compounds through beta and the alpha Newton,
# and the gap grows with the corpus: on the CPU the JAX package's own
# dense fits, bf16 against f32, K=20, synthetic flow days, 1.8e-4 at 600
# documents and 6.2e-4 at 6,000 (the port's plain version 1.8e-4 and
# 6.3e-4); the smoke's 2M flow day, 48,000 documents, on the H100:
# 1.2e-3, the bf16 fit the lower.
RTOL_BF16_ESTEP_LL = 1e-3
RTOL_BF16_FIT_LL = 5e-3
# Card against CPU on the small day: the first EM likelihoods, rel 1e-4
# (f32 sums in another order, the approximate reciprocal).
RTOL_E2E = 1e-4
PIPELINE_EVENTS = 2_000_000
DNS_EVENTS = 2_000_000
# Host-clock walls vary between calls (the host's cores are shared):
# each profiled wall is the median of this many runs.
WALL_REPS = 2
REPLACES = {
    "sparse_estep": "oni_ml_tpu/ops/sparse_estep.py:204",    # _sparse_kernel
    "sparse_scatter": "oni_ml_tpu/ops/sparse_estep.py:424",  # XLA segment_sum
    # _dense_kernel_w (W-major strides, the dense path's layout) and
    # _dense_kernel (row-major strides); the kernels line gives each
    # layout's times under "by_layout".
    "dense_estep": "oni_ml_tpu/ops/dense_estep.py:419, "
                   "oni_ml_tpu/ops/dense_estep.py:312",
    "fixed_point_estep": "oni_ml_tpu/ops/pallas_estep.py:123",  # _fixed_point_kernel
}
DENSE_LAYOUT_REPLACES = {"wmajor": "oni_ml_tpu/ops/dense_estep.py:419",
                         "rowmajor": "oni_ml_tpu/ops/dense_estep.py:312"}
SOURCES = {
    "sparse_estep": "oni_ml_tpu_torch/csrc/sparse_estep.cu",
    "sparse_scatter": "oni_ml_tpu_torch/csrc/sparse_estep.cu",
    "dense_estep": "oni_ml_tpu_torch/csrc/dense_estep.cu",
    "fixed_point_estep": "oni_ml_tpu_torch/csrc/fixed_point_estep.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def random_bucket(b, l, min_live, seed, warm):
    """A bucket of b docs of min_live..l live tokens (words drawn from V,
    counts 1..4), zero padding after, the last 3 docs masked (the last
    b // 2 where b < 6, so some docs iterate); beta from uniform noise,
    as the JAX init draws it."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(K, V)) + 1.0 / V
    log_beta = np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)
    lens = rng.integers(min_live, l + 1, size=b)
    live = np.arange(l)[None, :] < lens[:, None]
    word = np.where(live, rng.integers(0, V, size=(b, l)), 0).astype(np.int32)
    counts = np.where(live, rng.integers(1, 5, size=(b, l)), 0).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-min(3, b // 2):] = 0.0
    gamma_prev = None
    if warm:
        mean = 2.5 + counts.sum(1, keepdims=True) / K
        gamma_prev = (mean * rng.uniform(0.5, 1.5, size=(b, K))).astype(np.float32)
    dev = torch.device("cuda")
    t = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    return {
        "log_beta": t(log_beta), "alpha": t(np.float32(2.5)), "word": t(word),
        "counts": t(counts), "mask": t(mask),
        "gamma_prev": None if gamma_prev is None else t(gamma_prev),
    }


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close(name, got, ref, rtol, atol_frac, errs):
    got, ref = got.double(), ref.double()
    diff = (got - ref).abs()
    errs.append(float(diff.max()))
    atol = atol_frac * float(ref.abs().max())
    bad = diff > atol + rtol * ref.abs()
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} values outside rtol {rtol} "
             f"(max abs err {float(diff.max()):.3e})")


def check_fixed_point(label, got, ref, block, var_max_iters, var_tol, errs,
                      bf16=False):
    """Iterations per block and gamma (see the tolerances above; `bf16`:
    the dense bf16 instantiation's), each of `got` and `ref` a (gamma,
    iterations per block) pair; returns (max |d iters|, blocks that
    stopped apart, the largest relative gamma error on the blocks that
    stopped together)."""
    max_diff, moved_share = ((BF16_ITER_DIFF, BF16_MOVED_SHARE) if bf16
                             else (MAX_ITER_DIFF, MAX_MOVED_SHARE))
    gi, ri = got[1].long(), ref[1].long()
    it_diff = int((gi - ri).abs().max())
    if it_diff > max_diff:
        fail(f"{label}: iterations differ by {it_diff} in a block")
    if float(gi.float().mean()) >= var_max_iters:
        fail(f"{label}: every block ran to the cap of {var_max_iters} "
             "iterations, so no stop decision was compared")
    if int(gi.max()) <= 1:
        fail(f"{label}: no block iterated past its first step")
    moved = gi != ri
    if int(moved.sum()) > moved_share * len(gi):
        fail(f"{label}: {int(moved.sum())} of {len(gi)} blocks stop apart")
    same = ~moved.repeat_interleave(block)
    g, r = got[0][same].double(), ref[0][same].double()
    rel_same = float(((g - r).abs() / r.abs()).max()) if bool(same.any()) \
        else 0.0
    if bf16:
        steps = stop_measure(got[0], ref[0])
        apart = (gi - ri).abs().repeat_interleave(block).double()
        bounds = (apart + 1) * STALL_GATE
        errs.append(float((got[0] - ref[0]).abs().max()))
        if bool((steps > bounds).any()):
            worst = int(torch.argmax(steps / bounds))
            fail(f"{label}: a document whose block stopped "
                 f"{int(apart[worst])} iterations apart differs by "
                 f"{float(steps[worst]):.3e} > {float(bounds[worst]):.1e}")
        return it_diff, int(moved.sum()), rel_same
    close("gamma", got[0][same], ref[0][same], RTOL_GAMMA, 0.0, errs)
    if bool(moved.any()):
        step = float(stop_measure(got[0][~same], ref[0][~same]).max())
        if step > 2 * var_tol:
            fail(f"{label}: a block that stopped one iteration apart "
                 f"differs by {step:.3e} > 2 var_tol")
    return it_diff, int(moved.sum()), rel_same


def stop_measure(gamma, ref):
    """Per document, the stop rule's measure of the gap between two
    gammas: mean |d gamma| over the reference's mean gamma."""
    g, r = gamma.double(), ref.double()
    return (g - r).abs().mean(1) / r.mean(1)


def bound(nbytes, flops):
    """(least ms the card could take, what bounds it), from the package's
    peaks (telemetry/roofline.py bound_s)."""
    least, by = roofline.bound_s(flops, nbytes, PEAK)
    return least * 1e3, by


def bmm_yardstick_ms(slab_kbl, b, l):
    """Library yardstick of one fixed-point iteration: its two batched
    products (torch.bmm over the gathered [B, L, K] slab: phinorm, then
    the ratio contraction), in the slab's dtype (bf16 operands for a bf16
    slab)."""
    slab_blk = slab_kbl.permute(1, 2, 0).contiguous()
    e = torch.rand((b, K, 1), device="cuda", dtype=slab_blk.dtype)
    ratio = torch.rand((b, 1, l), device="cuda", dtype=slab_blk.dtype)
    return time_ms(lambda: (torch.bmm(slab_blk, e), torch.bmm(ratio, slab_blk)),
                   20)


def sparse_parity(label, b, l, min_live, warm, var_max_iters, var_tol,
                  precision="f32"):
    """The sparse E-step on a random bucket against its plain version;
    with precision "bf16" over the bf16 table (the same rounded table on
    both sides)."""
    case = random_bucket(b, l, min_live, seed=b + l + int(warm), warm=warm)
    expb = sparse_estep.exp_beta_table(case["log_beta"], precision)
    block = sparse_estep.pick_block(b)
    kw = dict(block=block, gamma_prev=case["gamma_prev"],
              warm=torch.tensor(1 if warm else 0))
    args = (expb, case["alpha"], case["word"], case["counts"], case["mask"],
            var_max_iters, var_tol)
    got = sparse_estep.fixed_point_blocks(*args, **kw)
    again = sparse_estep.fixed_point_blocks(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{label}: gamma, phi_c, docll, ass or iterations differ "
             "between two launches")
    geom = sparse_estep.launch_geometry(b, l, K, block)
    geom["path"] = "shared memory" if geom["staged"] else "device memory"
    ref = sparse_estep.fixed_point_full_reference(*args, **kw)
    errs: list = []
    it_diff, moved, rel_same = check_fixed_point(
        label, (got[0], got[4]), (ref[0], ref[4]), block, var_max_iters,
        var_tol, errs)
    tail = sparse_estep.fixed_point_full_reference(
        *args[:5], 0, var_tol, block=block, gamma_prev=got[0],
        warm=torch.tensor(1))
    close("phi_c", got[1], tail[1], RTOL_PHIC, RTOL_PHIC, errs)
    close("docll", got[2], tail[2], RTOL_DOCLL, RTOL_DOCLL, errs)
    close("ass", got[3], tail[3], RTOL_DOCLL, RTOL_DOCLL, errs)
    ms = time_ms(lambda: sparse_estep.fixed_point_blocks(*args, **kw), 20)
    plain_ms = time_ms(
        lambda: sparse_estep.fixed_point_full_reference(*args, **kw), 3)
    # Bound, from this run's inputs and per-block iteration counts
    # (sparse_estep.kernel_cost: each input read once, each output
    # written once).
    iters = got[4].long().cpu().numpy()
    doc_iters = np.repeat(iters, block)
    live = (case["counts"] != 0).sum(1).cpu().numpy()
    flops, nbytes = sparse_estep.kernel_cost(
        b, l, K, V, live, doc_iters, block, warm,
        table_itemsize=expb.element_size())
    bound_ms, bound_by = bound(nbytes, flops)
    # Library yardstick, as for the fixed point: the two batched products
    # of one iteration over the gathered slab (in the table's dtype),
    # times the mean iteration count.
    one = bmm_yardstick_ms(pallas_estep.gather_slab(expb, case["word"]), b, l)
    rec = {
        "kernel": ("sparse_estep" if precision == "f32"
                   else "sparse_estep_bf16"),
        "precision": precision, "case": label, "B": b, "L": l, "K": K,
        "V": V, "block": block, "warm": warm,
        "var_max_iters": var_max_iters, "var_tol": var_tol,
        "iters_min": int(iters.min()), "iters_max": int(iters.max()),
        "iters_mean": float(iters.mean()), "max_abs_err": max(errs),
        "iter_diff": it_diff, "blocks_stopped_apart": moved,
        "gamma_rel_err_same_stop": rel_same, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops,
        "library_ms": one * float(doc_iters.mean()),
        "library_ms_per_iteration": one,
        "geometry": geom, "bit_identical_relaunch": True,
    }
    rec["kernel_beats_library"] = ms < rec["library_ms"]
    log("parity " + json.dumps(rec))
    return rec


def dense_parity(label, b, l, min_live, wmajor, warm, var_max_iters, var_tol,
                 precision="f32"):
    """The dense E-step over b docs of min_live..l tokens densified to
    [b, W] (duplicate words summed), in the given layout, with `cells` = l
    as the dense path passes it: at the flow day's batch (l 128, about
    1.6% of the cells non-zero) and on long documents (l 4,096: a block's
    lists overflow to the scratch).  With precision "bf16": the bf16
    instantiation over the corpus stored as corpus_dtype gives it (bf16
    where every cell is <= 256), the plain version on the same counts."""
    case = random_bucket(b, l, min_live, seed=b + 7 + int(warm)
                         + (0 if l == 128 else l), warm=warm)
    store = dense_estep.corpus_dtype(dense_estep.max_dense_cell(
        case["word"].cpu().numpy(), case["counts"].cpu().numpy()), precision)
    dense = dense_estep.densify(case["word"], case["counts"], V, dtype=store)
    c = dense.t().contiguous() if wmajor else dense
    eb = dense_estep.padded_exp_beta(case["log_beta"], W)
    block = dense_estep.pick_block(b, V, K)
    kw = dict(block=block, wmajor=wmajor, gamma_prev=case["gamma_prev"],
              warm=torch.tensor(1 if warm else 0), cells=l,
              precision=precision)
    bf16 = precision == "bf16"
    args = (eb, case["alpha"], c, case["mask"], var_max_iters, var_tol)
    got = dense_estep.fixed_point_blocks(*args, **kw)
    again = dense_estep.fixed_point_blocks(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{label}: gamma, T or the tail differ between two launches")
    # Which path each block took follows from its cells: a block whose
    # non-zero cells outnumber the shared memory's keeps its lists in the
    # scratch.
    geom = dense_estep.launch_geometry(b, W, K, block, cells=l)
    nnz_doc = (dense != 0).sum(1).cpu().numpy()
    nnz_block = nnz_doc.reshape(-1, block).sum(1)
    n_scratch = int((nnz_block > geom["smem_cells"]).sum())
    geom.update(blocks_in_shared_memory=len(nnz_block) - n_scratch,
                blocks_in_scratch=n_scratch,
                path=("shared memory" if n_scratch == 0 else "L2 scratch"
                      if n_scratch == len(nnz_block) else "mixed"))
    ref = dense_estep.dense_fixed_point_reference(
        eb, case["alpha"], dense, case["mask"], var_max_iters, var_tol, block,
        gamma_prev=case["gamma_prev"], warm=kw["warm"], precision=precision)
    errs: list = []
    it_diff, moved, rel_same = check_fixed_point(
        label, (got[0], got[4]), (ref[0], ref[4]), block, var_max_iters,
        var_tol, errs, bf16=bf16)
    separation = None
    if bf16:
        # The rounding happened: the kernel's gamma lies closer to the
        # bf16 plain version's than to the f32 one's.
        ref32 = dense_estep.dense_fixed_point_reference(
            eb, case["alpha"], dense, case["mask"], var_max_iters, var_tol,
            block, gamma_prev=case["gamma_prev"], warm=kw["warm"])
        to16 = float(stop_measure(got[0], ref[0]).median())
        to32 = float(stop_measure(got[0], ref32[0]).median())
        separation = to32 / max(to16, 1e-30)
        if not separation >= BF16_SEPARATION:
            fail(f"{label}: the kernel's gamma is {to16:.3e} from the bf16 "
                 f"plain version's and {to32:.3e} from the f32 one's "
                 f"(median stop measure)")
    tail = dense_estep.dense_fixed_point_reference(
        eb, case["alpha"], dense, case["mask"], 0, var_tol, block,
        gamma_prev=got[0], warm=torch.tensor(1), precision=precision)
    close("T", got[1], tail[1], RTOL_T, RTOL_T, errs)
    close("docll", got[2], tail[2], RTOL_DOCLL, RTOL_DOCLL, errs)
    close("ass", got[3], tail[3], RTOL_DOCLL, RTOL_DOCLL, errs)
    ms = time_ms(lambda: dense_estep.fixed_point_blocks(*args, **kw), 10)
    plain_ms = time_ms(lambda: dense_estep.dense_fixed_point_reference(
        eb, case["alpha"], dense, case["mask"], var_max_iters, var_tol, block,
        gamma_prev=case["gamma_prev"], warm=kw["warm"], precision=precision),
        3)
    # Bound, counted from this run's inputs (dense_estep.kernel_cost:
    # the work of C's non-zero cells only).  The kernel does the dense
    # formulation's work, 4*K*W flops per doc and iteration over every
    # cell (sparse_estep.dense_equiv_flops per block): printed beside the
    # bound.
    iters = got[4].long().cpu().numpy()
    flops, nbytes = dense_estep.kernel_cost(
        b, W, K, nnz_doc, nnz_block, iters, block, warm,
        corpus_itemsize=dense.element_size())
    dense_flops = float(sum(sparse_estep.dense_equiv_flops(block, V, K, it)
                            for it in iters))
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {
        "kernel": "dense_estep_bf16" if bf16 else "dense_estep",
        "precision": precision, "corpus_dtype": str(dense.dtype),
        "case": label, "B": b, "W": W, "K": K,
        "layout": "wmajor" if wmajor else "rowmajor", "block": block,
        "warm": warm, "var_max_iters": var_max_iters, "var_tol": var_tol,
        "nonzero_cells": float((dense != 0).float().mean()),
        "iters_min": int(iters.min()), "iters_max": int(iters.max()),
        "iters_mean": float(iters.mean()), "max_abs_err": max(errs),
        "iter_diff": it_diff, "blocks_stopped_apart": moved,
        "gamma_rel_err_same_stop": rel_same, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops, "dense_cell_flops": dense_flops,
        "dense_cell_flops_ms": dense_flops / PEAK.flops_per_s * 1e3,
        "geometry": geom, "bit_identical_relaunch": True,
        "bf16_separation": separation,
    }
    if bf16:
        # The library yardstick in this mode: cuBLAS's two products of one
        # iteration on bf16 operands (f32 output), times the mean
        # iteration count.
        e16 = torch.rand((b, K), device="cuda").to(torch.bfloat16)
        r16 = torch.rand((b, W), device="cuda").to(torch.bfloat16)
        eb16 = eb.to(torch.bfloat16)
        one = time_ms(lambda: (torch.matmul(e16, eb16),
                               torch.matmul(r16, eb16.t())), 20)
        rec.update(library_ms=one * float(iters.mean()),
                   library_ms_per_iteration=one)
    log("parity " + json.dumps(rec))
    if wmajor and not warm and l == 128 and not bf16:
        # Context for a tensor-core kernel later: cuBLAS (TF32 off) on one
        # iteration's two products, times the mean iteration count.
        e = torch.rand((b, K), device="cuda")
        ratio = torch.rand((b, W), device="cuda")
        one = time_ms(lambda: (torch.matmul(e, eb), torch.matmul(ratio, eb.t())),
                      20)
        rec["cublas_ms"] = one * float(iters.mean())
        log("cublas " + json.dumps({
            "shapes": [[b, K, W], [b, W, K]], "ms_per_iteration": one,
            "iters_mean": float(iters.mean()),
            "ms": rec["cublas_ms"], "kernel_ms": ms,
            "kernel_beats_cublas": ms < rec["cublas_ms"],
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        }))
    return rec


def rec_layout(wmajor):
    return "wmajor" if wmajor else "rowmajor"


def fixed_point_parity(label, b, l, min_live, warm, var_max_iters, var_tol):
    """The fixed point over a gathered [K, B, L] slab (the per-batch
    pallas path's kernel) against its plain version, at the sparse
    cases' buckets and the card's doc block."""
    case = random_bucket(b, l, min_live, seed=b + l + 3 + int(warm), warm=warm)
    slab = pallas_estep.gather_slab(
        sparse_estep.exp_beta_table(case["log_beta"]), case["word"])
    block = pallas_estep.pick_block(b)
    kw = dict(block=block, gamma_prev=case["gamma_prev"],
              warm=torch.tensor(1 if warm else 0))
    args = (slab, case["alpha"], case["counts"], case["mask"], var_max_iters,
            var_tol)
    got = pallas_estep.fixed_point_blocks(*args, **kw)
    again = pallas_estep.fixed_point_blocks(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{label}: gamma or iterations differ between two launches")
    geom = pallas_estep.launch_geometry(b, l, K, block)
    geom["path"] = "shared memory" if geom["staged"] else "device memory"
    ref = pallas_estep.fixed_point_reference(*args[:6], block,
                                             gamma_prev=kw["gamma_prev"],
                                             warm=kw["warm"])
    errs: list = []
    it_diff, moved, rel_same = check_fixed_point(
        label, got, ref, block, var_max_iters, var_tol, errs)
    ms = time_ms(lambda: pallas_estep.fixed_point_blocks(*args, **kw), 20)
    plain_ms = time_ms(lambda: pallas_estep.fixed_point_reference(
        *args[:6], block, gamma_prev=kw["gamma_prev"], warm=kw["warm"]), 3)
    # Bound, from this run's inputs and per-block iteration counts
    # (pallas_estep.kernel_cost).
    iters = got[1].long().cpu().numpy()
    doc_iters = np.repeat(iters, block)
    live = (case["counts"] != 0).sum(1).cpu().numpy()
    flops, nbytes = pallas_estep.kernel_cost(b, l, K, live, doc_iters, block,
                                             warm)
    bound_ms, bound_by = bound(nbytes, flops)
    # Library yardstick: the two batched products of one iteration
    # (torch.bmm over [B, L, K]: phinorm, then the ratio contraction),
    # times the mean iteration count.
    one = bmm_yardstick_ms(slab, b, l)
    rec = {
        "kernel": "fixed_point_estep", "case": label, "B": b, "L": l, "K": K,
        "V": V, "block": block, "warm": warm,
        "var_max_iters": var_max_iters, "var_tol": var_tol,
        "iters_min": int(iters.min()), "iters_max": int(iters.max()),
        "iters_mean": float(iters.mean()), "max_abs_err": max(errs),
        "iter_diff": it_diff, "blocks_stopped_apart": moved,
        "gamma_rel_err_same_stop": rel_same, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops,
        "library_ms": one * float(doc_iters.mean()),
        "library_ms_per_iteration": one,
        "geometry": geom, "bit_identical_relaunch": True,
    }
    rec["kernel_beats_library"] = ms < rec["library_ms"]
    log("fixed_point_parity " + json.dumps(rec))
    return rec


# Each source's input flag, and the small day's raw events and columns
# of a results row (TOL 1.1 flags every raw event: all scores are below
# 1; the flow day's first line is its header).
DAY_FLAGS = {"flow": "--flow-path", "dns": "--dns-path",
             "proxy": "--proxy-path"}
SMALL_ROWS = {"flow": (19_999, 37), "dns": (20_000, 16), "proxy": (20_000, 15)}


def day_walls(recs):
    """A day's four stage walls and its day wall: their sum plus the
    dataplane's drain (`join_wall_s` of the plane's record), where the
    background writes that outlast the score stage finish; so the day
    wall runs until every artifact is written, with the plane on or
    off."""
    walls = {s: recs[s]["wall_s"] for s in ("pre", "corpus", "lda", "score")}
    plane = recs.get("dataplane")
    return walls, sum(walls.values()) + (plane["join_wall_s"] if plane
                                         else 0.0)


def run_day(dsource, raw, data, dev, engine, em_iters, *extra):
    """A day through ml_ops.main with ONI_ML_TPU_ESTEP=engine (unset for
    None)."""
    from oni_ml_tpu_torch.runner import ml_ops

    if engine:
        os.environ["ONI_ML_TPU_ESTEP"] = engine
    try:
        rc = ml_ops.main(["20160122", dsource, "1.1", DAY_FLAGS[dsource], raw,
                          "--data-dir", data, "--device", dev,
                          "--em-max-iters", str(em_iters), "--dup-factor",
                          "0", *extra])
    finally:
        os.environ.pop("ONI_ML_TPU_ESTEP", None)
    if rc != 0:
        fail(f"ml_ops {dsource} {extra} on {dev} returned {rc}")
    return os.path.join(data, "20160122")


# ONI_ML_TPU_ESTEP values the small days run, and the family member each
# must train with under the chunk driver.
E2E_MEMBERS = {"sparse": "sparse", "dense": "dense",
               "pallas": "per_batch:pallas", "xla": "per_batch:xla",
               "compact": "compact"}


def small_days(tmp):
    """The small days' raw files: 20,000 events each of flow (400
    sources, 100 destinations), DNS (400 clients, 500 domains) and proxy
    (the proxy spec's benign day behind a header line)."""
    from oni_ml_tpu_torch.sources import get
    from oni_ml_tpu_torch.synth import write_dns_day, write_flow_day

    raws = {name: os.path.join(tmp, f"small_{name}.csv")
            for name in DAY_FLAGS}
    with open(raws["flow"], "w") as f:
        write_flow_day(f, 20_000, n_src=400, n_dst=100, seed=5)
    with open(raws["dns"], "w") as f:
        write_dns_day(f, 20_000, n_clients=400, n_doms=500, seed=5)
    spec = get("proxy")
    with open(raws["proxy"], "w") as f:
        f.write(",".join(spec.columns) + "\n"
                + "\n".join(spec.synth_benign(20_000, seed=5)) + "\n")
    return raws


def e2e_small(tmp, raws):
    """The small flow and DNS days through the port on the card and on
    the CPU (plain versions) from one beta, with each ONI_ML_TPU_ESTEP
    value, and the proxy day under the default engine: the first EM
    iterations' likelihoods must agree to RTOL_E2E.  And a second card
    run of each: final.* byte for byte (no atomics on the path)."""
    cases = [(dsource, engine, member) for dsource in ("flow", "dns")
             for engine, member in E2E_MEMBERS.items()]
    cases.append(("proxy", None, None))
    for dsource, engine, member in cases:
        days = {run: run_day(dsource, raws[dsource], os.path.join(
                    tmp, f"small_{dsource}_{engine}_{run}"),
                    run.split("_")[0], engine, 5)
                for run in ("cuda", "cpu", "cuda_again")}
        lls, members = {}, {}
        for run, day in days.items():
            lls[run] = formats.read_likelihood(os.path.join(day, "likelihood.dat"))
            with open(os.path.join(day, "metrics.json")) as f:
                lda = {r["stage"]: r for r in json.load(f)}["lda"]
            members[run] = lda["member"]
            if (member and lda["member"] != member) or lda["driver"] != "fused":
                fail(f"e2e {dsource} {engine} {run}: trained {lda['member']} "
                     f"under the {lda['driver']} driver")
            with open(os.path.join(day, f"{dsource}_results.csv"), "rb") as f:
                rows = f.read().splitlines()
            n_rows, n_cols = SMALL_ROWS[dsource]
            if len(rows) != n_rows or any(len(r.split(b",")) != n_cols
                                          for r in rows):
                fail(f"e2e {dsource} {engine} {run}: {dsource}_results.csv "
                     f"has {len(rows)} rows or a row without {n_cols} columns")
        a, b = lls["cuda"][:, 0], lls["cpu"][:, 0]
        if a.shape != b.shape or not np.allclose(a, b, rtol=RTOL_E2E, atol=0):
            fail(f"e2e {dsource} {engine} likelihoods differ: cuda "
                 f"{a.tolist()} cpu {b.tolist()}")
        same = {}
        for name in ("final.beta", "final.gamma", "final.other",
                     "likelihood.dat"):
            with open(os.path.join(days["cuda"], name), "rb") as f1, \
                    open(os.path.join(days["cuda_again"], name), "rb") as f2:
                same[name] = f1.read() == f2.read()
        if not all(same.values()):
            fail(f"e2e {dsource} {engine}: two card runs wrote different "
                 f"bytes: {same}")
        log("e2e " + json.dumps({
            "dsource": dsource, "estep_env": engine, "member": members,
            "em_iters": len(a),
            "cuda_vs_cpu_max_rel": float(np.max(np.abs(a - b) / np.abs(b))),
            "card_runs_byte_identical": same,
        }))


def pipeline(tmp):
    """The 2M-event day through run_pipeline, its engine from the
    measured crossover; then the same corpus through train_corpus on the
    dense family's full-V path and on the per-batch pallas path (and on
    the sparse engine, where the crossover did not pick it), each
    scored.  Returns the corpus, each family member's kernel counts
    (launched, ran) on its path, the pre stage's record and the day's
    engine, and leaves the day for bf16_paths in _BF16_INPUTS."""
    from oni_ml_tpu_torch.config import PipelineConfig, ScoringConfig
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.synth import write_flow_day

    raw = os.path.join(tmp, "flow_day.csv")
    t0 = time.perf_counter()
    with open(raw, "w") as f:
        write_flow_day(f, PIPELINE_EVENTS, n_src=40_000, n_dst=8_000, seed=11)
    log(f"pipeline: wrote {PIPELINE_EVENTS} events in "
        f"{time.perf_counter() - t0:.1f} s")
    data = os.path.join(tmp, "data")
    config = PipelineConfig(data_dir=data, flow_path=raw,
                            scoring=ScoringConfig(threshold=1e-20))
    reset_kernel_counts()
    t0 = time.perf_counter()
    run = ml_ops.run_pipeline(config, "20160122", "flow", device="cuda",
                              emit=lambda *a, **k: None)
    run_wall = time.perf_counter() - t0
    day_counts = (launch_counts(), executed_counts())
    day = os.path.join(data, "20160122")
    recs = {r["stage"]: r for r in run.records}
    missing = [n for n in ml_ops.artifacts("flow")
               if not os.path.exists(os.path.join(day, n))]
    if missing:
        fail(f"pipeline artifacts missing: {missing}")
    lda, corpus = recs["lda"], recs["corpus"]
    _SERIAL_LDA["flow"] = lda
    _SERIAL_LDA["flow_lls"] = formats.read_likelihood(
        os.path.join(day, "likelihood.dat"))[:, 0]
    check_day(day, recs, corpus, lda)
    # The crossover's measurement ran E-steps of both engines inside the
    # pipeline (its warm-up and timed runs): their launches are the
    # path's too.
    e_steps = lda["crossover"].get("e_steps", {}) if lda["crossover"] else {}
    check_launches(lda["member"], lda, day_counts, extra={
        kname: e_steps.get(engine, 0) for engine in ("sparse", "dense")
        for kname in ENGINE_KERNELS[engine]})
    crossover(run.corpus, lda)
    walls, day_wall = day_walls(recs)
    log("pipeline " + json.dumps({
        "events": PIPELINE_EVENTS, "docs": corpus["docs"],
        "vocab": corpus["vocab"], "tokens": corpus["tokens"],
        "stage_wall_s": walls, "day_wall_s": day_wall,
        "run_wall_s": run_wall,
        **pre_fields(recs, "flow"),
        "flagged": recs["score"]["flagged"], "lda": lda,
    }))
    path_counts = {lda["member"]: day_counts}
    paths = [("dense", {"estep_engine": "dense"}, None, "dense"),
             ("pallas", {}, "pallas", "per_batch:pallas")]
    if "sparse" not in path_counts:
        paths.append(("sparse", {"estep_engine": "sparse"}, None, "sparse"))
    f32_ll = {lda["member"]: lda["final_likelihood"]}
    for label, cfg_kw, env, member in paths:
        path_counts[member], rec = train_path(label, run, config, cfg_kw,
                                              env, member, recs, tmp)
        f32_ll[member] = rec["final_likelihood"]
    _BF16_INPUTS.update(run=run, config=config, recs=recs, f32_ll=f32_ll)
    return run.corpus, path_counts, recs["pre"], lda["engine"]


# The pipeline's day for the bf16 paths: its run, config, stage records
# and each member's f32 final likelihood.
_BF16_INPUTS: dict = {}


# The bf16 paths: (label, the config, the member, the bf16 kernel).
BF16_PATHS = (("sparse_bf16", {"estep_engine": "sparse"}, "sparse",
               "sparse_estep"),
              ("dense_bf16", {"estep_engine": "dense"}, "dense",
               "dense_estep"))


def bf16_launches() -> dict:
    """The bf16 instantiations' launches since the last reset."""
    return {"sparse_estep": sparse_estep.bf16_launch_count,
            "dense_estep": dense_estep.bf16_launch_count}


def check_bf16_path(label, member, kname, counts, bf16, ll, ll_f32):
    """A bf16 path: every launch of its kernel the bf16 instantiation's,
    at least one run on the card, and its final likelihood within
    RTOL_BF16_FIT_LL of the f32 run of its engine."""
    engine = "sparse" if member == "sparse" else "dense"
    if bf16[kname] != counts[0][kname] or counts[1][kname] <= 0:
        fail(f"{label}: {kname} bf16 launches {bf16[kname]} of "
             f"{counts[0][kname]} (ran {counts[1][kname]})")
    rel = abs(ll - ll_f32) / abs(ll_f32)
    if not rel <= RTOL_BF16_FIT_LL:
        fail(f"{label}: final likelihood {ll} against the f32 {engine} "
             f"run's {ll_f32}: rel {rel:.3e} > {RTOL_BF16_FIT_LL}")
    return rel


def bf16_paths(tmp):
    """The pipeline day's corpus in the bf16 mode on the sparse engine and
    on the dense family (train_path, counts zeroed just before each and
    read just after).  Returns {label: (launched, ran)}."""
    run, config, recs, f32_ll = (_BF16_INPUTS[k] for k in
                                 ("run", "config", "recs", "f32_ll"))
    out = {}
    for label, cfg_kw, member, kname in BF16_PATHS:
        counts, rec = train_path(label, run, config,
                                 dict(cfg_kw, dense_precision="bf16"), None,
                                 member, recs, tmp)
        bf16 = bf16_launches()
        rel = check_bf16_path(label, member, kname, counts, bf16,
                              rec["final_likelihood"], f32_ll[member])
        log(f"{label} " + json.dumps({
            "bf16_launches": bf16[kname], "launches": counts[0][kname],
            "ran": counts[1][kname], "dense_precision": rec["dense_precision"],
            "final_likelihood": rec["final_likelihood"],
            "final_likelihood_f32": f32_ll[member], "rel_to_f32": rel,
            "em_iters": rec["em_iters"], "em_s": rec["em_s"]}))
        out[label] = counts
    bf16_dense_estep(run.corpus, _BF16_INPUTS["models"][("dense", "f32")])
    return out


def bf16_dense_estep(corpus, model):
    """The JAX package's dense bf16 likelihood bound where it applies: one
    E-step from one model in both modes (tests/test_dense_estep.py
    test_bf16_precision_close_and_validated).  From the f32 dense fit's
    final beta and alpha, over the day's batches (make_batches at the
    LDAConfig defaults, densified W-major as the dense path stores them,
    bf16 where every cell is <= 256), the dense kernel in f32 and in bf16
    at the fit's var_max_iters and var_tol: the summed likelihoods within
    RTOL_BF16_ESTEP_LL; the real documents' gamma gap by the stop rule's
    measure printed (median, largest)."""
    from oni_ml_tpu_torch.config import LDAConfig

    cfg = LDAConfig()
    log_beta, alpha = model
    lb = torch.as_tensor(log_beta, dtype=torch.float32, device="cuda")
    a = torch.tensor(alpha, dtype=torch.float32, device="cuda")
    ll = {"f32": 0.0, "bf16": 0.0}
    gaps = []
    for b in make_batches(corpus, cfg.batch_size, cfg.min_bucket_len,
                          pad_multiple=8):
        w, c, m = (torch.as_tensor(x).to("cuda") for x in
                   (b.word_idx, b.counts.astype(np.float32),
                    b.doc_mask.astype(np.float32)))
        store = dense_estep.corpus_dtype(
            dense_estep.max_dense_cell(b.word_idx, b.counts), "bf16")
        gam = {}
        for p, dt in (("f32", torch.float32), ("bf16", store)):
            d = dense_estep.densify(w, c, corpus.num_terms, dtype=dt)
            res = dense_estep.e_step_dense(
                lb, a, d.t().contiguous(), m, cfg.var_max_iters, cfg.var_tol,
                wmajor=True, cells=b.word_idx.shape[1], precision=p)
            ll[p] += float(res.likelihood)
            gam[p] = res.gamma[m == 1].double()
        gaps.append(stop_measure(gam["bf16"], gam["f32"]))
    gaps = torch.cat(gaps)
    rel = abs(ll["bf16"] - ll["f32"]) / abs(ll["f32"])
    log("bf16_dense_estep " + json.dumps({
        "docs": int(gaps.numel()), "likelihood_f32": ll["f32"],
        "likelihood_bf16": ll["bf16"], "rel": rel,
        "gamma_gap_median": float(gaps.median()),
        "gamma_gap_max": float(gaps.max()), "bound": RTOL_BF16_ESTEP_LL}))
    if not rel <= RTOL_BF16_ESTEP_LL:
        fail(f"bf16 dense E-step from the f32 fit's model: likelihood rel "
             f"{rel:.3e} > {RTOL_BF16_ESTEP_LL}")


def bf16_small_day(tmp, raws):
    """The small flow day through ml_ops.main with --dense-precision bf16,
    its engine from a crossover measured at bf16 (counts zeroed just
    before, read just after): the lda record names bf16 and its member,
    whose kernel launched as the bf16 instantiation; the final likelihood
    within RTOL_BF16_FIT_LL of e2e's f32 card run pinned to the same
    engine.  Returns the launches."""
    reset_kernel_counts()
    day = run_day("flow", raws["flow"], os.path.join(tmp, "small_flow_bf16"),
                  "cuda", None, 5, "--dense-precision", "bf16")
    counts = (launch_counts(), executed_counts())
    bf16 = bf16_launches()
    with open(os.path.join(day, "metrics.json")) as f:
        lda = {r["stage"]: r for r in json.load(f)}["lda"]
    member = lda["member"]
    if lda["dense_precision"] != "bf16" or member not in ("sparse", "dense"):
        fail(f"bf16 small day: trained {member} at {lda['dense_precision']}")
    if not (lda["crossover"] or {}).get("shape", "").endswith(".bf16"):
        fail(f"bf16 small day: engine {lda['engine']} ({lda['engine_source']})"
             f" not from a bf16 crossover: {lda['crossover']}")
    kname = ENGINE_KERNELS[member][0]
    f32_day = os.path.join(tmp, f"small_flow_{member}_cuda", "20160122")
    ll_f32 = float(formats.read_likelihood(
        os.path.join(f32_day, "likelihood.dat"))[-1, 0])
    rel = check_bf16_path("bf16 small day", member, kname, counts, bf16,
                          lda["final_likelihood"], ll_f32)
    log("bf16_small_day " + json.dumps({
        "member": member, "engine_source": lda["engine_source"],
        "crossover": lda["crossover"], "bf16_launches": bf16[kname],
        "launches": counts[0][kname], "final_likelihood":
        lda["final_likelihood"], "final_likelihood_f32": ll_f32,
        "rel_to_f32": rel, "wall_s": lda["wall_s"]}))
    return {kname: bf16[kname]}


def crossover(corpus, lda):
    """The day's engine came from the crossover, measured in this run
    (the plan cache is this run's own file); resolved again as a new
    process would (the per-process memo cleared), the plan serves it."""
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import resolve_estep_engine

    cross = lda["crossover"]
    if lda["engine_source"] != "measured" or not cross or (
            cross["engine"] != lda["engine"]):
        fail(f"pipeline engine {lda['engine']} ({lda['engine_source']}) did "
             f"not come from a measured crossover: {cross}")
    sparse_estep._CROSSOVER_CACHE.clear()
    again = resolve_estep_engine(corpus, LDAConfig(), device="cuda")
    rec = {key: cross[key] for key in ("engine", "sparse_s", "dense_s",
                                       "source", "shape")}
    # The work each engine does per E-step at the measured shape (8
    # fixed-point iterations): the sparse engine's over live tokens, the
    # dense engine's over every densified cell.
    k, v, b, l = (int(x[1:]) for x in cross["shape"].split(".")[:4])
    rec["sparse_flops"] = sparse_estep.effective_flops(b, l, k, 8)
    rec["dense_flops"] = sparse_estep.dense_equiv_flops(b, v, k, 8)
    rec["second_resolution"] = {"engine": again[0], "source": again[1]}
    log("crossover " + json.dumps(rec))
    if again != (lda["engine"], "plan"):
        fail(f"second resolution {again}, expected ({lda['engine']!r}, 'plan')")


def train_path(label, run, config, cfg_kw, env, member, recs, tmp):
    """The day's corpus through train_corpus with the given config and
    ONI_ML_TPU_ESTEP, then scored; its kernels must have launched on it.
    Returns its kernel counts (launched, ran) and its lda record."""
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models import train_corpus
    from oni_ml_tpu_torch.runner import ml_ops

    out = formats.ensure_dir(os.path.join(tmp, f"{label}_day"))
    if env:
        os.environ["ONI_ML_TPU_ESTEP"] = env
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        counts0 = kernel_counts()
        result = train_corpus(run.corpus, LDAConfig(**cfg_kw), out_dir=out,
                              device="cuda")
        em_s = time.perf_counter() - t0
        counts = (launch_counts(), executed_counts())
    finally:
        os.environ.pop("ONI_ML_TPU_ESTEP", None)
    rec = dict(ml_ops.lda_record(result, counts0, "cuda"), em_s=em_s,
               em_docs_per_s=run.corpus.num_docs * result.em_iters / em_s)
    t0 = time.perf_counter()
    score = ml_ops.stage_score(ml_ops.RunContext(
        config, "20160122", "flow", out, features=run.features,
        corpus=run.corpus, result=result))
    score_s = time.perf_counter() - t0
    if rec["member"] != member:
        fail(f"{label} day trained {rec['member']}, expected {member}")
    check_launches(member, rec, counts)
    lls = np.asarray([ll for ll, _ in result.likelihoods])
    if not (np.isfinite(result.log_beta).all() and np.isfinite(lls).all()
            and (result.gamma > 0).all() and result.em_iters < 100
            and score["scored_events"] == recs["score"]["scored_events"]):
        fail(f"{label} day: a non-finite model, no convergence, or not "
             "every event scored")
    _BF16_INPUTS.setdefault("models", {})[
        (member, cfg_kw.get("dense_precision", "f32"))] = (result.log_beta,
                                                           result.alpha)
    log(f"pipeline_{label} " + json.dumps({
        "lda": rec, "score_s": score_s, "flagged": score["flagged"],
        "final_likelihood_day": recs["lda"]["final_likelihood"],
        "dense_corpus_bytes": run.corpus.num_docs * W * 4,
    }))
    return counts, rec


# The pre record's fields that the 2M-day lines carry: the featurizer
# engine, its workers with their source, the pass walls, and where the
# dataplane wrote features.pkl and word_counts.dat ("background").
PRE_FIELDS = ("pre_engine", "pre_workers", "pre_workers_source", "parse_s",
              "cuts_s", "word_build_s", "merge_s", "pickle", "wc_write")


def pre_fields(recs, dsource):
    """The pre record's PRE_FIELDS; the 2M days must featurize natively."""
    pre = recs["pre"]
    if pre.get("pre_engine") != "native":
        fail(f"{dsource} 2M day: pre ran {pre.get('pre_engine')} "
             f"({pre.get('python_reason')}), not the native featurizer")
    return {key: pre.get(key) for key in PRE_FIELDS}


def check_day(day, recs, corpus, lda, dsource="flow"):
    vocab = formats.read_words_dat(os.path.join(day, "words.dat"))
    docs = formats.read_doc_dat(os.path.join(day, "doc.dat"))
    ptr, widx, cnts = formats.read_model_dat(os.path.join(day, "model.dat"))
    beta = formats.read_beta(os.path.join(day, "final.beta"))
    gamma = formats.read_gamma(os.path.join(day, "final.gamma"))
    other = formats.read_other(os.path.join(day, "final.other"))
    ll = formats.read_likelihood(os.path.join(day, "likelihood.dat"))
    names, theta = formats.read_doc_results(os.path.join(day, "doc_results.csv"))
    words, p = formats.read_word_results(os.path.join(day, "word_results.csv"))
    with open(os.path.join(day, f"{dsource}_results.csv"), "rb") as f:
        flagged = [r.split(b",") for r in f.read().splitlines()]
    checks = {
        "vocab": len(vocab) == corpus["vocab"] == len(words),
        "docs": len(docs) == corpus["docs"] == len(ptr) - 1 == len(names),
        "beta": beta.shape == (K, len(vocab)) and np.isfinite(beta).all(),
        "gamma": gamma.shape == (len(docs), K) and np.isfinite(gamma).all()
        and (gamma > 0).all(),
        "other": other["num_topics"] == K and other["num_terms"] == len(vocab)
        and other["alpha"] > 0,
        "likelihood": ll.shape[0] == lda["em_iters"] and np.isfinite(ll).all(),
        "doc_results": np.allclose(theta.sum(1), 1.0),
        "word_results": np.allclose(p.sum(0), 1.0),
        "results": all(len(r) == SMALL_ROWS[dsource][1] for r in flagged)
        and len(flagged) == recs["score"]["flagged"],
        "driver": lda["member"] in ENGINE_KERNELS and lda["driver"] == "fused",
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"{dsource} pipeline checks failed: {bad}")


def pipeline_dns(tmp):
    """The 2M-event DNS day (the JAX bench's shape) through ml_ops.main
    on the card, its engine from the crossover measured in a fresh plan
    cache.  Returns the kernel counts (launched, ran) of the run."""
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.synth import write_dns_day

    raw = os.path.join(tmp, "dns_day.csv")
    t0 = time.perf_counter()
    with open(raw, "w") as f:
        write_dns_day(f, DNS_EVENTS, n_clients=20_000, n_doms=5_000, seed=13)
    log(f"pipeline_dns: wrote {DNS_EVENTS} events in "
        f"{time.perf_counter() - t0:.1f} s")
    data = os.path.join(tmp, "dns_data")
    plans = os.environ["ONI_ML_TPU_PLAN_CACHE"]
    os.environ["ONI_ML_TPU_PLAN_CACHE"] = os.path.join(tmp, "dns_plans.jsonl")
    sparse_estep._CROSSOVER_CACHE.clear()
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        rc = ml_ops.main(["20160122", "dns", "1e-20", "--dns-path", raw,
                          "--data-dir", data])
        run_wall = time.perf_counter() - t0
        counts = (launch_counts(), executed_counts())
    finally:
        os.environ["ONI_ML_TPU_PLAN_CACHE"] = plans
    day = os.path.join(data, "20160122")
    if rc != 0:
        fail(f"pipeline_dns: ml_ops returned {rc}")
    missing = [n for n in ml_ops.artifacts("dns")
               if not os.path.exists(os.path.join(day, n))]
    if missing:
        fail(f"pipeline_dns artifacts missing: {missing}")
    with open(os.path.join(day, "metrics.json")) as f:
        recs = {r["stage"]: r for r in json.load(f)}
    lda, corpus = recs["lda"], recs["corpus"]
    check_day(day, recs, corpus, lda, "dns")
    cross = lda["crossover"]
    if lda["engine_source"] != "measured" or not cross or (
            cross["engine"] != lda["engine"]):
        fail(f"pipeline_dns engine {lda['engine']} ({lda['engine_source']}) "
             f"did not come from a measured crossover: {cross}")
    check_launches(lda["member"], lda, counts, extra={
        kname: cross.get("e_steps", {}).get(engine, 0)
        for engine in ("sparse", "dense") for kname in ENGINE_KERNELS[engine]})
    # Where the DNS day's EM time goes: 20 iterations of its engine over
    # its corpus (the trainer's gates pick the same member), profiled.
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import LDATrainer

    dns_corpus = Corpus.from_model_dat(os.path.join(day, "model.dat"),
                                       os.path.join(day, "words.dat"),
                                       os.path.join(day, "doc.dat"))
    _MESH_INPUTS["dns_corpus"] = dns_corpus
    if lda["engine"] == "sparse":
        batches = list(dns_corpus.bucketed_layout(
            min_len=128, batch_cap=1024,
            pad_multiple=sparse_estep.pad_multiple_for("f32")).batches)
    else:
        batches = make_batches(dns_corpus, 1024, 16, pad_multiple=8)
    prof = profile_fit(f"dns_{lda['member']}", LDATrainer(
        LDAConfig(em_max_iters=20, em_tol=0.0), dns_corpus.num_terms,
        device="cuda"), batches, dns_corpus.num_docs, lda["engine"], 20)
    walls, day_wall = day_walls(recs)
    log("pipeline_dns " + json.dumps({
        "events": DNS_EVENTS, "docs": corpus["docs"],
        "vocab": corpus["vocab"], "tokens": corpus["tokens"],
        "stage_wall_s": walls, "day_wall_s": day_wall,
        "run_wall_s": run_wall,
        **pre_fields(recs, "dns"),
        "em_s": lda["em_s"], "em_docs_per_s": lda["em_docs_per_s"],
        "em_iters": lda["em_iters"], "engine": lda["engine"],
        "engine_source": lda["engine_source"], "member": lda["member"],
        "crossover": {key: cross[key] for key in (
            "engine", "sparse_s", "dense_s", "source", "shape")},
        "batches": lda["batches"], "batch_shapes": lda["batch_shapes"],
        "kernel_launches": lda["kernel_launches"],
        "executed_launches": lda["executed_launches"],
        "flagged": recs["score"]["flagged"],
        "dense_corpus_bytes": corpus["docs"] * dense_estep.padded_width(
            corpus["vocab"]) * 4,
        "em_profile": {key: prof[key] for key in (
            "member", "ms_per_em_iteration", "device_busy_s",
            "device_idle_share")},
    }))
    return counts, lda["engine"]


def resume(tmp, raw):
    """The small flow day with the sparse engine pinned: --stages
    pre,corpus then --stages lda,score write the one-shot card run's
    bytes; an EM fit cut at iteration 3 (checkpoint_every 1) and resumed
    to 6 equals the uninterrupted card fit, warm start off, under both
    drivers."""
    from dataclasses import replace

    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models import train_corpus
    from oni_ml_tpu_torch.models.lda import save_checkpoint

    one = run_day("flow", raw, os.path.join(tmp, "resume_one"), "cuda",
                  "sparse", 5)
    split = os.path.join(tmp, "resume_split")
    run_day("flow", raw, split, "cuda", "sparse", 5, "--stages", "pre,corpus")
    two = run_day("flow", raw, split, "cuda", "sparse", 5, "--stages",
                  "lda,score")
    names = ["word_counts.dat", "words.dat", "doc.dat", "model.dat",
             "final.beta", "final.gamma", "final.other", "likelihood.dat",
             "doc_results.csv", "word_results.csv", "flow_results.csv"]
    same = {}
    for name in names:
        with open(os.path.join(one, name), "rb") as f1, \
                open(os.path.join(two, name), "rb") as f2:
            same[name] = f1.read() == f2.read()
    with open(os.path.join(two, "metrics.json")) as f:
        recs = {r["stage"]: r for r in json.load(f)}
    if not all(same.values()) or recs["lda"]["corpus"] != "file" or (
            recs["score"]["features"] != "file"):
        fail(f"resume: the split run differs from the one-shot run: {same}, "
             f"lda corpus {recs['lda']['corpus']}, score features "
             f"{recs['score']['features']}")
    corpus = Corpus.from_model_dat(os.path.join(two, "model.dat"),
                                   os.path.join(two, "words.dat"),
                                   os.path.join(two, "doc.dat"))
    fits = {}
    for driver, chunk in (("fused", 128), ("stepwise", 1)):
        cfg = LDAConfig(em_max_iters=6, em_tol=0.0, warm_start_gamma=False,
                        checkpoint_every=1, fused_em_chunk=chunk,
                        estep_engine="sparse")
        full = train_corpus(corpus, cfg, device="cuda")
        part = train_corpus(corpus, replace(cfg, em_max_iters=3),
                            device="cuda")
        out = formats.ensure_dir(os.path.join(tmp, f"resume_fit_{driver}"))
        save_checkpoint(os.path.join(out, "checkpoint.npz"), part.log_beta,
                        part.alpha, 3, part.likelihoods)
        res = train_corpus(corpus, cfg, out_dir=out, device="cuda")
        fits[driver] = {
            "driver": res.stats["driver"], "em_iters": res.em_iters,
            "likelihoods_equal": res.likelihoods == full.likelihoods,
            "beta_equal": bool(np.array_equal(res.log_beta, full.log_beta)),
            "gamma_equal": bool(np.array_equal(res.gamma, full.gamma)),
            "alpha_equal": res.alpha == full.alpha,
            "checkpoint_removed": not os.path.exists(
                os.path.join(out, "checkpoint.npz")),
        }
        if not all(v for k, v in fits[driver].items()
                   if k not in ("driver", "em_iters")) or (
                res.stats["driver"] != driver):
            fail(f"resume: the {driver} fit resumed at 3 differs from the "
                 f"uninterrupted card fit: {fits[driver]}")
    log("resume " + json.dumps({"split_run_byte_identical": same,
                                "checkpoint_resume": fits}))


# Survivors of the score_device phase's threshold: about this share of a
# 2M-event day (a suspicion threshold keeps a small fraction).
SCORE_KEEP = 1e-3
# Device (float32) against host (float64) scores: rel 1e-6 at K=20; an
# event whose host score lies within this of the threshold may land on
# either side (the float32 boundary) and is counted, not failed.
RTOL_SCORE = 1e-6


def day_scores(day, dsource):
    """(model, the day's index pairs, the device engine's float32 scores
    of every raw event: min(src, dest) for flow) from the day's files,
    through the package (the features.pkl loader, the model files, the
    event index resolution, pipeline.chunked_scores on the card)."""
    from oni_ml_tpu_torch.config import ScoringConfig
    from oni_ml_tpu_torch.runner.ml_ops import _PortUnpickler
    from oni_ml_tpu_torch.scoring import pipeline
    from oni_ml_tpu_torch.scoring import score as score_mod
    from oni_ml_tpu_torch.sources import get

    with open(os.path.join(day, "features.pkl"), "rb") as f:
        features = _PortUnpickler(f).load()
    model = score_mod.ScoringModel.from_files(
        os.path.join(day, "doc_results.csv"),
        os.path.join(day, "word_results.csv"),
        get(dsource).fallback(ScoringConfig()))
    idx = features.event_indices(model.ip_index, model.word_index)
    pairs = [idx[:2], idx[2:]] if dsource == "flow" else [idx]
    del features
    scores = [pipeline.chunked_scores(model, *pr, device="cuda")
              for pr in pairs]
    key = scores[0] if len(scores) == 1 else np.minimum(*scores)
    return model, pairs, key


def gap_threshold(scores, share):
    """A threshold about `share` of the scores fall under: the geometric
    midpoint of two adjacent distinct scores at that quantile."""
    s = np.unique(scores)
    i = max(1, int(np.searchsorted(s, np.quantile(scores, share))))
    return float(np.sqrt(s[i - 1] * s[i]))


def parse_results(path, ncols):
    """[(featurized columns as bytes, [score columns])] of a results
    CSV, in file order."""
    with open(path, "rb") as f:
        rows = f.read().splitlines()
    out = []
    for r in rows:
        head, *cols = r.rsplit(b",", ncols)
        out.append((head, [float(c) for c in cols]))
    return out


def compare_engines(host, dev, tol):
    """The device engine's results against the host engine's: the same
    events (by featurized columns, byte-equal) but for events whose host
    score lies within RTOL_SCORE of the threshold (counted), scores
    within RTOL_SCORE, and the device order ascending in host scores up
    to RTOL_SCORE ties (the order of events a float32 rounding apart may
    swap; counted)."""
    from collections import Counter

    h_count = Counter(h for h, _ in host)
    d_count = Counter(h for h, _ in dev)
    h_scores = dict(host)
    d_scores = dict(dev)
    only_host = list((h_count - d_count).elements())
    only_dev = list((d_count - h_count).elements())

    def key(cols):
        return min(cols)

    off_boundary = [h for h in only_host
                    if abs(key(h_scores[h]) / tol - 1.0) > RTOL_SCORE]
    off_boundary += [h for h in only_dev
                     if abs(key(d_scores[h]) / tol - 1.0) > RTOL_SCORE]
    if off_boundary:
        fail(f"score_device: {len(off_boundary)} events differ between the "
             "engines away from the float32 threshold boundary")
    worst = 0.0
    for h, cols in d_scores.items():
        if h in h_scores:
            ref = np.asarray(h_scores[h])
            worst = max(worst, float(np.max(np.abs(np.asarray(cols) - ref)
                                            / np.abs(ref))))
    if worst > RTOL_SCORE:
        fail(f"score_device: scores differ by rel {worst:.3e} > "
             f"{RTOL_SCORE}")
    seq = [key(h_scores[h]) for h, _ in dev if h in h_scores]
    bad_order = sum(1 for a, b in zip(seq, seq[1:])
                    if b < a * (1.0 - RTOL_SCORE))
    if bad_order:
        fail(f"score_device: {bad_order} device rows out of host order")
    dev_keys = [key(c) for _, c in dev]
    if any(b < a for a, b in zip(dev_keys, dev_keys[1:])):
        fail("score_device: the device rows are not ascending")
    common = [h for h, _ in host if h in d_scores]
    swaps = sum(1 for a, b in zip(common, [h for h, _ in dev
                                           if h in h_scores]) if a != b)
    return {"host_rows": len(host), "device_rows": len(dev),
            "boundary_only_host": len(only_host),
            "boundary_only_device": len(only_dev),
            "max_score_rel_err": worst,
            "rows_swapped_on_float32_ties": swaps}


def score_device(tmp, smi):
    """The device scoring engine on the two 2M-event days that `pipeline`
    and `pipeline_dns` wrote: `--stages score` through ml_ops.main under
    ONI_ML_TPU_SCORE=device, then host, at a threshold that keeps about
    SCORE_KEEP of the day (the days' own 1e-20 keeps none): each
    engine's score wall, the device run's score_dispatch record and its
    chunk loop's roofline record, and the engines' results compared
    (compare_engines).  Then the bitwise check: chunked_scores at two
    chunk sizes against device_scores in one dispatch, on the flow
    day's events.  Returns {dsource: (threshold, the host engine's score
    wall)}: the host run is the last, so its results stay in the day."""
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.scoring import chunked_scores, device_scores

    host = {}
    for dsource, data, raw in (
            ("flow", os.path.join(tmp, "data"),
             os.path.join(tmp, "flow_day.csv")),
            ("dns", os.path.join(tmp, "dns_data"),
             os.path.join(tmp, "dns_day.csv"))):
        day = os.path.join(data, "20160122")
        t0 = time.perf_counter()
        model, pairs, scores = day_scores(day, dsource)
        tol = gap_threshold(scores, SCORE_KEEP)
        prep_s = time.perf_counter() - t0
        runs = {}
        for engine in ("device", "host"):
            os.environ["ONI_ML_TPU_SCORE"] = engine
            try:
                rc = ml_ops.main(["20160122", dsource, repr(tol),
                                  DAY_FLAGS[dsource], raw, "--data-dir",
                                  data, "--stages", "score", "--force"])
            finally:
                os.environ.pop("ONI_ML_TPU_SCORE", None)
            if rc != 0:
                fail(f"score_device {dsource} {engine}: ml_ops returned {rc}")
            with open(os.path.join(day, "metrics.json")) as f:
                recs = {r["stage"]: r for r in json.load(f)}
            runs[engine] = (recs, parse_results(
                os.path.join(day, f"{dsource}_results.csv"),
                2 if dsource == "flow" else 1))
        dev_recs, dev_rows = runs["device"]
        host_recs, host_rows = runs["host"]
        score = dev_recs["score"]
        if score.get("engine") != "device" or "score_dispatch" not in score:
            fail(f"score_device {dsource}: the device run did not score "
                 f"through the pipeline: {score}")
        if host_recs["score"].get("engine") != "host":
            fail(f"score_device {dsource}: the host run scored on "
                 f"{host_recs['score'].get('engine')}")
        loop = [r for r in dev_recs.get("roofline", {}).get("records", [])
                if r["phase"].startswith("score.device.")]
        if len(loop) != 1 or not loop[0]["utilization"]:
            fail(f"score_device {dsource}: no chunk-loop roofline record "
                 f"with utilization: {loop}")
        cmp = compare_engines(host_rows, dev_rows, tol)
        if not cmp["device_rows"]:
            fail(f"score_device {dsource}: no event under the threshold")
        host[dsource] = (tol, host_recs["score"]["wall_s"])
        dispatch = score["score_dispatch"]
        chunk = dispatch["chunk"]
        log("score_device " + json.dumps({
            "dsource": dsource, "card": smi, "events": score["scored_events"],
            "threshold": tol, "threshold_prep_s": prep_s,
            "score_wall_s": {"device": score["wall_s"],
                             "host": host_recs["score"]["wall_s"]},
            "score_dispatch": dispatch,
            "chunk_loop_roofline": loop[0],
            "bound_ms_per_chunk": 1e3 * roofline.bound_s(
                loop[0]["flops"] / loop[0]["dispatches"],
                loop[0]["bytes"] / loop[0]["dispatches"], PEAK)[0],
            "chunk": chunk, **cmp,
        }))
        if dsource == "flow":
            ip, w = pairs[0]
            one = device_scores(model, ip, w, chunk=len(ip), device="cuda")
            sizes = (1 << 16, 100_003)
            same = {c: bool(np.array_equal(
                one, chunked_scores(model, ip, w, chunk=c, device="cuda")))
                for c in sizes}
            if not all(same.values()):
                fail(f"score_device: chunked scores differ from one "
                     f"dispatch: {same}")
            log("score_bitwise " + json.dumps(
                {"events": len(ip), "one_dispatch_vs_chunks": same}))
    return host


# A day's files that the native and the Python pre paths must write
# alike: all but the pickle, the native path's spill, and the run's own
# records.
NOT_PINNED = ("features.pkl", "raw_lines.bin", "metrics.json",
              "run_journal.jsonl")


def same_files(a, b, names):
    """{name: whether day dirs a and b hold the same bytes under it}."""
    out = {}
    for name in names:
        with open(os.path.join(a, name), "rb") as f1, \
                open(os.path.join(b, name), "rb") as f2:
            out[name] = f1.read() == f2.read()
    return out


def ml_ops_day(dsource, tol, raw, data, *extra, python=False):
    """One ml_ops.main run (under ONI_ML_TPU_NO_NATIVE=1 when `python`)
    -> (the day dir, its stage records)."""
    from oni_ml_tpu_torch.runner import ml_ops

    if python:
        os.environ["ONI_ML_TPU_NO_NATIVE"] = "1"
    try:
        rc = ml_ops.main(["20160122", dsource, repr(tol), DAY_FLAGS[dsource],
                          raw, "--data-dir", data, *extra])
    finally:
        os.environ.pop("ONI_ML_TPU_NO_NATIVE", None)
    if rc != 0:
        fail(f"ml_ops {dsource} {extra} (python={python}) returned {rc}")
    day = os.path.join(data, "20160122")
    with open(os.path.join(day, "metrics.json")) as f:
        return day, {r["stage"]: r for r in json.load(f)}


def native_pre_start(tmp):
    """Start the 2M-event flow day's `--stages pre,corpus` on the Python
    path (ONI_ML_TPU_NO_NATIVE=1) in a process of its own, so its
    single-threaded parse runs beside the phases that follow `pipeline`
    until native_pre joins it (it ran inline there until the mesh phase
    needed the room).
    Returns the process and its output files."""
    base = os.path.join(tmp, "native_pre_py")
    fo, fe = open(base + ".out", "w"), open(base + ".err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", "20160122",
         "flow", repr(1e-20), "--flow-path",
         os.path.join(tmp, "flow_day.csv"), "--data-dir", base, "--stages",
         "pre,corpus", "--device", "cuda"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, ONI_ML_TPU_NO_NATIVE="1"), stdout=fo,
        stderr=fe)
    return {"proc": proc, "files": (fo, fe), "base": base}


def native_pre_join(started):
    """Wait for native_pre_start's run (killed past 600 s); fails unless
    it exited 0.  Returns its day dir and stage records."""
    proc = started["proc"]
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    for f in started["files"]:
        f.close()
    if proc.returncode != 0:
        with open(started["base"] + ".err") as f:
            fail(f"native_pre: the Python pre run exited {proc.returncode}: "
                 f"{f.read()[-2500:]}")
    day = os.path.join(started["base"], "20160122")
    with open(os.path.join(day, "metrics.json")) as f:
        return day, {r["stage"]: r for r in json.load(f)}


def native_pre(tmp, raws, flow_pre, host_score, host, py_started):
    """The native pre path against the Python one (ONI_ML_TPU_NO_NATIVE=1)
    on the card's host.  The 2M-event flow day: `--stages pre,corpus` in
    Python (started earlier, native_pre_start) and natively at
    --pre-workers 1 must write the word counts and the corpus triplet of
    the pipeline's run (native, workers auto); the Python day's score
    stage, resumed at score_device's threshold over the pipeline's
    model, must write the native day's results.  The small flow and DNS
    days (sparse engine pinned, so both runs train alike): every file of
    the day alike, results CSVs included."""
    flow_day = os.path.join(tmp, "data", "20160122")
    raw = os.path.join(tmp, "flow_day.csv")
    tol, native_score_s = host_score["flow"]
    w1_day, w1 = ml_ops_day("flow", 1e-20, raw,
                            os.path.join(tmp, "native_pre_w1"), "--stages",
                            "pre,corpus", "--pre-workers", "1")
    if (w1["pre"]["pre_engine"] != "native"
            or w1["pre"]["pre_workers"] != 1):
        fail(f"native_pre: the native run took {w1['pre']}")
    files = ["word_counts.dat", "words.dat", "doc.dat", "model.dat"]
    py_day, py = native_pre_join(py_started)
    if py["pre"]["pre_engine"] != "python":
        fail(f"native_pre: the Python run took {py['pre']}")
    equal = {"python": same_files(flow_day, py_day, files),
             "native_workers_1": same_files(flow_day, w1_day, files)}
    for name in ("doc_results.csv", "word_results.csv"):
        shutil.copy(os.path.join(flow_day, name), os.path.join(py_day, name))
    _, py_score = ml_ops_day("flow", tol, raw,
                             os.path.join(tmp, "native_pre_py"), "--stages",
                             "score", python=True)
    equal["python"].update(same_files(flow_day, py_day, ["flow_results.csv"]))
    shutil.rmtree(py_day, ignore_errors=True)
    shutil.rmtree(w1_day, ignore_errors=True)
    small = {}
    for dsource in ("flow", "dns"):
        days = {"native": run_day(dsource, raws[dsource], os.path.join(
            tmp, f"native_pre_small_{dsource}_native"), "cuda", "sparse", 5)}
        os.environ["ONI_ML_TPU_NO_NATIVE"] = "1"
        try:
            days["python"] = run_day(dsource, raws[dsource], os.path.join(
                tmp, f"native_pre_small_{dsource}_python"), "cuda", "sparse",
                5)
        finally:
            os.environ.pop("ONI_ML_TPU_NO_NATIVE", None)
        names = {run: sorted(n for n in os.listdir(day) if n not in NOT_PINNED)
                 for run, day in days.items()}
        if names["native"] != names["python"]:
            fail(f"native_pre small {dsource}: the days hold other files: "
                 f"{names}")
        small[dsource] = same_files(days["native"], days["python"],
                                    names["native"])
    bad = [f"{k}:{n}" for k, v in {**equal, **small}.items()
           for n, ok in v.items() if not ok]
    if bad:
        fail(f"native_pre: the native and Python paths wrote other bytes: "
             f"{bad}")
    log("native_pre " + json.dumps({
        "host": host, "events": PIPELINE_EVENTS,
        "pre_wall_s": {"native": flow_pre["wall_s"],
                       "native_workers_1": w1["pre"]["wall_s"],
                       "python": py["pre"]["wall_s"]},
        "native_pre_workers": flow_pre["pre_workers"],
        "corpus_wall_s": {"native_workers_1": w1["corpus"]["wall_s"],
                          "python": py["corpus"]["wall_s"]},
        "resumed_score_wall_s": {"native": native_score_s,
                                 "python": py_score["score"]["wall_s"]},
        "score_threshold": tol, "flagged": py_score["score"]["flagged"],
        "bytes_equal_2m_flow": equal, "bytes_equal_small": small,
    }))


# The plans phase: the plan cache's probes into a store of their own,
# then the small flow day on that store in a fresh process and with
# --no-plans --no-compilation-cache in another (started early, so its
# cold build overlaps the phases before).  The probes' budgets (seconds
# of sweep each; the first candidate always runs) and depths.
PLANS_BUDGET_S = {"em_chunk": 10.0, "estep": 5.0, "score": 8.0, "pre": 10.0}
PLANS_DENSITIES = "1,5"
PLANS_PRE_WORKERS = "1,8,0"
PLANS_DAY_FILES = ("word_counts.dat", "flow_results.csv", "doc_results.csv",
                   "word_results.csv", "final.beta", "final.gamma",
                   "final.other", "likelihood.dat")
# Every knob the four probes record.
PLANS_KNOBS = ("fused_em_chunk", "estep_engine", "score_device_chunk",
               "dispatch_calibration", "pre_workers")


def plans_day_cmd(raw, data, *extra):
    """The small flow day through the CLI in a process of its own, as
    e2e runs it (5 EM iterations, no feedback rows)."""
    return [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops",
            "20160122", "flow", "1.1", "--flow-path", raw, "--data-dir",
            data, "--em-max-iters", "5", "--dup-factor", "0", *extra]


def plans_off_start(tmp, raw):
    """Start the small flow day with --no-plans --no-compilation-cache
    (the sparse engine pinned, so its bytes are comparable) in a process
    of its own: it builds every library it loads in a temporary
    directory, beside the phases before `plans`."""
    base = os.path.join(tmp, "plans_off")
    fo, fe = open(base + ".out", "w"), open(base + ".err", "w")
    proc = subprocess.Popen(
        plans_day_cmd(raw, base, "--no-plans", "--no-compilation-cache"),
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, ONI_ML_TPU_ESTEP="sparse"), stdout=fo,
        stderr=fe)
    return {"proc": proc, "files": (fo, fe), "base": base}


def plans_day_records(base, proc_rc, err_path, label):
    if proc_rc != 0:
        with open(err_path) as f:
            fail(f"plans {label}: the day exited {proc_rc}: "
                 f"{f.read()[-2500:]}")
    day = os.path.join(base, "20160122")
    with open(os.path.join(day, "metrics.json")) as f:
        return day, {r["stage"]: r for r in json.load(f)}


def run_tool(module, argv):
    """oni_ml_tpu_torch.tools.<module>.main(argv) in this process -> its
    JSON lines (each also logged)."""
    import contextlib
    import importlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(
            f"oni_ml_tpu_torch.tools.{module}").main(argv)
    if rc != 0:
        fail(f"plans: {module} returned {rc}")
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    for rec in lines:
        log(f"plans {module} " + json.dumps(rec, default=str))
    return lines


def plans_phase(tmp, raws, started):
    """(a) The four probes, each under its budget, into the phase's own
    store: each must record its knobs, and `plan_cache show` list them.
    (c) The small flow day with --no-plans --no-compilation-cache
    (started by plans_off_start) joined: plans off, a cold build of 3 or
    more libraries.  Then (b), the small flow day in a fresh process on
    the probes' store (sparse pinned), is started; plans_rerun_join
    checks it later.  Returns the state plans_rerun_join takes: each
    kernel's launches so far (the probes' in this process, counts zeroed
    just before and read just after, and (c)'s own), (c)'s day, the
    chunk the probe recorded and (b)'s process."""
    from oni_ml_tpu_torch.scoring import score as score_mod

    store = os.path.join(tmp, "probes.jsonl")
    # The probes fill this process's calibration and crossover memos;
    # they are put back after, so later phases measure against the
    # smoke's own store as before.
    memos = (dict(score_mod._CALIBRATION),
             dict(sparse_estep._CROSSOVER_CACHE))
    t0 = time.perf_counter()
    reset_kernel_counts()
    common = ["--plan-cache", store]
    probes = {
        "em_chunk_probe": run_tool("em_chunk_probe", [
            *common, "--budget-s", str(PLANS_BUDGET_S["em_chunk"])]),
        "estep_probe": run_tool("estep_probe", [
            *common, "--densities", PLANS_DENSITIES,
            "--budget-s", str(PLANS_BUDGET_S["estep"])]),
        "score_probe": run_tool("score_probe", [
            *common, "--budget-s", str(PLANS_BUDGET_S["score"])]),
        "pre_probe": run_tool("pre_probe", [
            *common, "--flow-path", os.path.join(tmp, "flow_day.csv"),
            "--workers", PLANS_PRE_WORKERS, "--reps", "1",
            "--budget-s", str(PLANS_BUDGET_S["pre"])]),
    }
    counts = launch_counts()
    probes_s = time.perf_counter() - t0
    for memo, saved in zip((score_mod._CALIBRATION,
                            sparse_estep._CROSSOVER_CACHE), memos):
        memo.clear()
        memo.update(saved)
    for name, lines in probes.items():
        last = lines[-1]
        if last.get("probe") != "plan_cache_update" or not last["recorded"]:
            fail(f"plans: {name} recorded nothing: {last}")
    shown = run_tool("plan_cache", ["show", "--plan-cache", store])
    listed = {rec["knob"] for rec in shown[1:]}
    if not set(PLANS_KNOBS) <= listed:
        fail(f"plans: show lists {sorted(listed)}, not {PLANS_KNOBS}")
    for kname in ("sparse_estep", "sparse_scatter", "dense_estep"):
        if counts[kname] <= 0:
            fail(f"plans: the probes launched no {kname}: {counts}")
    # (c): the plans-off run started after small_days.
    t1 = time.perf_counter()
    off_proc = started["proc"]
    try:
        off_proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        off_proc.kill()
        off_proc.wait()
    for f in started["files"]:
        f.close()
    off_wait_s = time.perf_counter() - t1
    off_day, off = plans_day_records(started["base"], off_proc.returncode,
                                     started["base"] + ".err", "plans-off")
    cc = off["plans"]["compilation_cache"]
    if off["plans"]["enabled"] or cc["enabled"] or cc["builds"] < 3:
        fail(f"plans: the plans-off run's record {off['plans']}")
    if off["lda"]["plans"]["fused_em_chunk"]["source"] != "default":
        fail(f"plans: the plans-off run's chunk {off['lda']['plans']}")
    for kname, n in off["lda"]["kernel_launches"].items():
        counts[kname] += n
    # (b): a fresh process on the probes' store, beside the next phases.
    base = os.path.join(tmp, "plans_on")
    fo, fe = open(base + ".out", "w"), open(base + ".err", "w")
    proc = subprocess.Popen(
        plans_day_cmd(raws["flow"], base, "--plan-cache", store),
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, ONI_ML_TPU_ESTEP="sparse"), stdout=fo,
        stderr=fe)
    log("plans " + json.dumps({
        "probes_s": probes_s, "off_wait_s": off_wait_s,
        "winners": {name: {k: v for k, v in lines[-1].items()
                           if k in PLANS_KNOBS or k in ("truncated",
                                                        "measurements",
                                                        "points", "wall_s")}
                    for name, lines in probes.items()},
        "plans_off": {"plans": off["plans"], "lda_plans": off["lda"]["plans"],
                      "stage_walls": day_walls(off)[0]},
        "probe_launches": counts}, default=str))
    return {"counts": counts, "off_day": off_day,
            "chunk": probes["em_chunk_probe"][-1]["fused_em_chunk"],
            "rerun": {"proc": proc, "files": (fo, fe), "base": base}}


def plans_rerun_join(tmp, state):
    """(b) joined: no sweep, fused_em_chunk (the probe's winner) and
    pre_workers from the plan, and the bytes of (c) and of e2e's sparse
    card run of the same day.  Returns each kernel's launches in the
    plans phase, (b)'s own added."""
    started = state["rerun"]
    proc = started["proc"]
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    for f in started["files"]:
        f.close()
    on_day, on = plans_day_records(started["base"], proc.returncode,
                                   started["base"] + ".err", "re-run")
    if on["plans"]["autotune_sweeps"] != 0:
        fail(f"plans: the re-run ran sweeps: {on['plans']}")
    if on["lda"]["plans"]["fused_em_chunk"] != {"value": state["chunk"],
                                                "source": "plan"}:
        fail(f"plans: the re-run's chunk {on['lda']['plans']}, the probe's "
             f"{state['chunk']}")
    if on["pre"]["plans"]["pre_workers"]["source"] != "plan":
        fail(f"plans: the re-run's pre workers {on['pre']['plans']}")
    same = same_files(on_day, state["off_day"], PLANS_DAY_FILES)
    e2e_day = os.path.join(tmp, "small_flow_sparse_cuda", "20160122")
    same_e2e = same_files(on_day, e2e_day, PLANS_DAY_FILES)
    if not all(same.values()) or not all(same_e2e.values()):
        fail(f"plans: plans on / off / e2e bytes differ: {same} {same_e2e}")
    counts = dict(state["counts"])
    for kname, n in on["lda"]["kernel_launches"].items():
        counts[kname] += n
    log("plans_rerun " + json.dumps({
        "plans": on["plans"], "lda_plans": on["lda"]["plans"],
        "pre_plans": on["pre"]["plans"], "stage_walls": day_walls(on)[0],
        "bytes_equal": same, "bytes_equal_e2e": same_e2e,
        "launches": counts}, default=str))
    return counts


def telemetry(tmp, raw):
    """The flight recorder on the card: the small flow day through
    ml_ops.main, then again with `--heartbeat 1 --profile DIR`; the
    second run's journal must hold stage spans, em.host_sync spans, one
    estep_crossover record and heartbeat records, its metrics.json an
    em.run_chunk roofline record with utilization under 100%, DIR a
    Chrome trace with CUDA kernel events, and final.* (and the results)
    the first run's bytes.  The same two runs again, each in a fresh
    process as a user starts one (`python -m
    oni_ml_tpu_torch.runner.ml_ops`): in this process an earlier phase
    has started the profiler already, and there the profiler starts
    cold; their final.* must be the same bytes too.  The recorded run
    alone goes to a fresh process (the plain one went too until the mesh
    phase needed the room: a fresh process's plain run is the
    in-process one's bytes, which the recorded fresh run shows as
    well)."""
    from collections import Counter

    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.telemetry import Journal

    prof = os.path.join(tmp, "telemetry_profile")
    days = {}
    for label, extra in (("plain", []),
                         ("recorded", ["--heartbeat", "1", "--profile",
                                       prof]),
                         ("fresh_recorded", ["--heartbeat", "1", "--profile",
                                             prof + "_fresh"])):
        data = os.path.join(tmp, f"telemetry_{label}")
        argv = ["20160122", "flow", "1.1", "--flow-path", raw,
                "--data-dir", data, *extra]
        t0 = time.perf_counter()
        if label.startswith("fresh"):
            out = subprocess.run(
                [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops",
                 *argv], cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
            rc = out.returncode
            if rc != 0:
                log(out.stderr[-4000:])
        else:
            rc = ml_ops.main(argv)
        if rc != 0:
            fail(f"telemetry {label}: ml_ops returned {rc}")
        days[label] = (os.path.join(data, "20160122"),
                       time.perf_counter() - t0)
    plain, rec_day = days["plain"][0], days["recorded"][0]
    # Each run's wall outside its four stages: what the profiler's start
    # and its trace export cost on top of the recorded stages (and, in a
    # fresh process, the interpreter's start and the card's).
    outside = {}
    for label, (day, wall) in days.items():
        with open(os.path.join(day, "metrics.json")) as f:
            outside[label] = wall - sum(
                r["wall_s"] for r in json.load(f)
                if r["stage"] in ("pre", "corpus", "lda", "score"))
    same = {}
    for name in ("final.beta", "final.gamma", "final.other",
                 "likelihood.dat", "flow_results.csv"):
        with open(os.path.join(plain, name), "rb") as f:
            want = f.read()
        for label in ("recorded", "fresh_recorded"):
            with open(os.path.join(days[label][0], name), "rb") as f:
                same[f"{label}:{name}"] = f.read() == want
    records = Journal.replay(os.path.join(rec_day, "run_journal.jsonl"))
    kinds = Counter(r["kind"] for r in records)
    span_names = Counter(r["name"] for r in records if r["kind"] == "span")
    with open(os.path.join(rec_day, "metrics.json")) as f:
        recs = {r["stage"]: r for r in json.load(f)}
    em = [r for r in recs.get("roofline", {}).get("records", [])
          if r["phase"] == "em.run_chunk"]
    trace_path = os.path.join(prof, "20160122.flow.trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
    checks = {
        "final_bytes_equal": all(same.values()),
        "stage_spans": all(span_names[f"stage.{s}"] == 1
                           for s in ("pre", "corpus", "lda", "score")),
        "em_host_sync_spans": span_names["em.host_sync"] > 0,
        "one_crossover_record": kinds["estep_crossover"] == 1,
        "heartbeats": kinds["heartbeat"] > 0 and all(
            r["ok"] for r in records if r["kind"] == "heartbeat"),
        "em_roofline": len(em) == 1 and bool(em[0]["utilization"]) and all(
            0 < v < 100 for v in em[0]["utilization"].values()),
        "cuda_kernel_events": kernel_events > 0,
    }
    log("telemetry " + json.dumps({
        "checks": checks, "final_bytes_equal": same,
        "walls_s": {k: v[1] for k, v in days.items()},
        "outside_stages_s": outside,
        "journal_kinds": dict(kinds), "span_names": dict(span_names),
        "em_roofline": em[0] if em else None,
        "trace_events": len(events), "cuda_kernel_events": kernel_events,
        "trace_bytes": os.path.getsize(trace_path),
    }))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"telemetry checks failed: {bad}")


def dataplane(tmp, raws, engines):
    """The streaming dataplane on the card.  The 2M-event flow and DNS
    days through ml_ops.main twice each, by default (dataplane on) and
    with --no-dataplane, the engine pinned to the one the crossover
    picked for the day (ONI_ML_TPU_ESTEP_ENGINE), so only the plane
    differs: every artifact the same bytes (features.pkl names its day's
    spill); both runs' stage walls, day wall, run wall and the plane's
    record (task walls by stage, edge stalls).  Then the small
    flow and DNS days with --no-dataplane against the e2e phase's card
    days (dataplane on, sparse): the same bytes.  Then --no-checkpoints
    on the small flow day: only the products, and a `--stages score
    --force` run afterwards stops naming features.pkl and leaves the
    results CSV as it was."""
    import contextlib
    import io

    from oni_ml_tpu_torch.runner import ml_ops

    big = {"flow": os.path.join(tmp, "flow_day.csv"),
           "dns": os.path.join(tmp, "dns_day.csv")}
    rec = {}
    for dsource, raw in big.items():
        os.environ["ONI_ML_TPU_ESTEP_ENGINE"] = engines[dsource]
        runs = {}
        try:
            for label, extra in (("dataplane", ()),
                                 ("no_dataplane", ("--no-dataplane",))):
                t0 = time.perf_counter()
                day, recs = ml_ops_day(dsource, 1e-20, raw, os.path.join(
                    tmp, f"dp_{dsource}_{label}"), *extra)
                runs[label] = (day, recs, time.perf_counter() - t0)
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP_ENGINE", None)
        names = [n for n in ml_ops.artifacts(dsource) if n != "features.pkl"]
        equal = same_files(runs["dataplane"][0], runs["no_dataplane"][0],
                           names)
        plane = runs["dataplane"][1].get("dataplane")
        if not all(equal.values()) or not plane or not all(
                t["ok"] for t in plane["tasks"].values()):
            fail(f"dataplane {dsource}: the days differ or a task failed: "
                 f"{equal}, {plane}")
        out = {}
        for label, (day, recs, wall) in runs.items():
            walls, day_wall = day_walls(recs)
            out[label] = {"stage_wall_s": walls,
                          "day_wall_s": day_wall,
                          "run_wall_s": wall,
                          "member": recs["lda"]["member"],
                          "em_s": recs["lda"]["em_s"],
                          "prep": recs["score"]["prep"]}
            shutil.rmtree(os.path.dirname(day), ignore_errors=True)
        by_stage: dict = {}
        for name, t in plane["tasks"].items():
            by_stage.setdefault(t["stage"], {})[name] = t["wall_s"]
        out["dataplane"]["record"] = {
            "task_wall_s_by_stage": by_stage, "edges": plane["edges"],
            "background_wall_s": plane["background_wall_s"],
            "join_wall_s": plane["join_wall_s"]}
        out["engine"] = engines[dsource]
        out["bytes_equal"] = all(equal.values())
        rec[dsource] = out
        log(f"dataplane_{dsource} " + json.dumps(out))
    small = {}
    for dsource in ("flow", "dns"):
        serial = run_day(dsource, raws[dsource], os.path.join(
            tmp, f"dp_small_{dsource}"), "cuda", "sparse", 5,
            "--no-dataplane")
        plane_day = os.path.join(tmp, f"small_{dsource}_sparse_cuda",
                                 "20160122")
        names = [n for n in ml_ops.artifacts(dsource) if n != "features.pkl"]
        small[dsource] = same_files(plane_day, serial, names)
        if not all(small[dsource].values()):
            fail(f"dataplane small {dsource}: the dataplane day and the "
                 f"--no-dataplane day differ: {small[dsource]}")
    data = os.path.join(tmp, "dp_products")
    day = run_day("flow", raws["flow"], data, "cuda", "sparse", 5,
                  "--no-checkpoints")
    products = sorted(os.listdir(day))
    with open(os.path.join(day, "flow_results.csv"), "rb") as f:
        results = f.read()
    with open(os.path.join(tmp, "small_flow_sparse_cuda", "20160122",
                           "flow_results.csv"), "rb") as f:
        same_results = f.read() == results
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ml_ops.main(["20160122", "flow", "1.1", "--flow-path",
                          raws["flow"], "--data-dir", data, "--stages",
                          "score", "--force"])
    refusal = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(os.path.join(day, "flow_results.csv"), "rb") as f:
        kept = f.read() == results
    if (products != ["flow_results.csv", "metrics.json",
                     "run_journal.jsonl"] or not same_results or rc != 2
            or "features.pkl" not in refusal.get("detail", "")
            or "--no-checkpoints" not in refusal["detail"] or not kept):
        fail(f"dataplane --no-checkpoints: files {products}, results as the "
             f"checkpointed day's {same_results}, resume rc {rc} "
             f"{refusal}, results kept {kept}")
    log("dataplane_small " + json.dumps({
        "no_dataplane_bytes_equal": small,
        "no_checkpoints_files": products,
        "no_checkpoints_results_equal": same_results,
        "resume_refused": refusal["detail"], "results_kept": kept}))


# Online runs: (label, dense_em, ONI_ML_TPU_ESTEP, the member that takes
# the micro-batch steps, the per-batch kernel of the inference pass).
ONLINE_RUNS = (("dense", "auto", None, "dense", "sparse_estep"),
               ("sparse", "off", None, "per_batch:sparse", "sparse_estep"),
               ("fixed_point", "off", "pallas", "per_batch:pallas",
                "fixed_point_estep"))
# Online on the card against the CPU (the cuda test's bound) and
# step_many against sequential step() (tests/test_torch_online.py's).
RTOL_ONLINE_CPU = 1e-4
RTOL_ONLINE_LL, RTOL_ONLINE_LAM, ATOL_ONLINE_LAM = 1e-5, 2e-4, 1e-4


def check_online_launches(label, res, counts, member, infer):
    """Each micro-batch step launched its member's kernel (and, per
    batch, the [V, K] scatter), the inference pass its per-batch kernel
    and the scatter once per batch, no other kernel; every launch ran
    (online has no device stop)."""
    launched, executed = counts
    steps, nb = res.em_iters, res.stats["batches"]
    want = {name: 0 for name in launched}
    want[infer] += nb
    want["sparse_scatter"] += nb
    for name in ENGINE_KERNELS[member]:
        want[name] += steps
    if (res.stats["member"] != member or launched != want
            or executed != want):
        fail(f"online {label}: member {res.stats['member']}, launched "
             f"{launched}, ran {executed}, expected {member} and {want}")


def online(tmp, corpus):
    """Online SVI on the card.  The 2M flow day's corpus through
    train_corpus_online (K 20, batch 1024, one epoch) three ways: dense_em
    auto (the dense kernel), off (the sparse kernel) and off under
    ONI_ML_TPU_ESTEP=pallas (the fixed point): each kernel's launches,
    the wall, micro-batches and documents per second.  On the small flow
    day's corpus: the card against the CPU (per-step likelihood and
    final lambda), step_many against sequential step(), and two card
    runs the same bits.  Returns each kernel's launches on its path."""
    from dataclasses import replace

    from oni_ml_tpu_torch.config import OnlineLDAConfig
    from oni_ml_tpu_torch.models.online_lda import (OnlineLDATrainer,
                                                    train_corpus_online)

    paths = {}
    for label, dense_em, env, member, infer in ONLINE_RUNS:
        if env:
            os.environ["ONI_ML_TPU_ESTEP"] = env
        try:
            reset_kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = train_corpus_online(corpus, OnlineLDAConfig(
                dense_em=dense_em), device="cuda")
            wall = time.perf_counter() - t0
            counts = (launch_counts(), executed_counts())
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP", None)
        check_online_launches(label, res, counts, member, infer)
        lls = [ll for ll, _ in res.likelihoods]
        if not (np.isfinite(res.log_beta).all() and np.isfinite(lls).all()
                and (res.gamma > 0).all()):
            fail(f"online {label}: a non-finite model")
        paths[member] = counts[0]
        log(f"online_{label} " + json.dumps({
            "docs": corpus.num_docs, "vocab": corpus.num_terms,
            "member": member, "micro_batches": res.em_iters,
            "batch_shapes": res.stats["batch_shapes"], "wall_s": wall,
            "micro_batches_per_s": res.em_iters / wall,
            "docs_per_s": corpus.num_docs / wall,
            "final_likelihood": lls[-1], "kernel_launches": counts[0]}))
    day = os.path.join(tmp, "small_flow_sparse_cuda", "20160122")
    small = Corpus.from_model_dat(os.path.join(day, "model.dat"),
                                  os.path.join(day, "words.dat"),
                                  os.path.join(day, "doc.dat"))
    cfg = OnlineLDAConfig(dense_em="on")
    runs = {}
    for label, dev in (("cuda", "cuda"), ("cpu", "cpu"), ("cuda_again",
                                                           "cuda")):
        lls = []
        res = train_corpus_online(small, cfg, device=dev, progress=lambda
                                  info: lls.append(float(info.likelihood)))
        runs[label] = (res, np.asarray(lls))
    (a, la), (b, lb) = runs["cuda"], runs["cpu"]
    cpu_ll = float(np.max(np.abs(la - lb) / np.abs(lb)))
    beta_a, beta_b = np.exp(a.log_beta), np.exp(b.log_beta)
    cpu_beta = float(np.max(np.abs(beta_a - beta_b) / np.maximum(beta_b,
                                                                  1e-7)))
    again = runs["cuda_again"]
    same_bits = bool(np.array_equal(a.log_beta, again[0].log_beta)
                     and np.array_equal(la, again[1])
                     and np.array_equal(a.gamma, again[0].gamma))
    from oni_ml_tpu_torch.io import make_batches as mb

    # Each micro-batch four times over: same-shape runs of 4 that step_many
    # takes on the device schedule.
    stream = [bt for bt in mb(small, 1024, 16, pad_multiple=8)
              for _ in range(4)]
    seq = OnlineLDATrainer(replace(cfg, dense_em="off"), small.num_terms,
                           small.num_docs, device="cuda")
    for bt in stream:
        seq.step(bt)
    many = OnlineLDATrainer(replace(cfg, dense_em="off"), small.num_terms,
                            small.num_docs, device="cuda")
    infos = many.step_many(stream, chunk=16)
    seq_ll = np.asarray([float(h.likelihood) for h in seq.history])
    many_ll = np.asarray([float(i.likelihood) for i in infos])
    lam_s, lam_m = seq.lam.cpu().numpy(), many.lam.cpu().numpy()
    many_ok = bool(np.allclose(many_ll, seq_ll, rtol=RTOL_ONLINE_LL, atol=0)
                   and np.allclose(lam_m, lam_s, rtol=RTOL_ONLINE_LAM,
                                   atol=ATOL_ONLINE_LAM))
    rec = {"docs": small.num_docs, "steps": a.em_iters,
           "cuda_vs_cpu_ll_max_rel": cpu_ll,
           "cuda_vs_cpu_beta_max_rel": cpu_beta,
           "card_runs_same_bits": same_bits,
           "step_many_vs_step_ll_max_rel": float(np.max(
               np.abs(many_ll - seq_ll) / np.abs(seq_ll))),
           "step_many_vs_step_lam_max_abs": float(np.max(np.abs(
               lam_m - lam_s))),
           "step_many_ok": many_ok}
    log("online_small " + json.dumps(rec))
    if (cpu_ll > RTOL_ONLINE_CPU or not np.allclose(
            beta_a, beta_b, rtol=RTOL_ONLINE_CPU, atol=1e-7)
            or not same_bits or not many_ok):
        fail(f"online small day: {rec}")
    return paths


# --eval-quality / --eval-holdout on the card against the CPU: the model
# itself carries the card-vs-CPU EM gap (RTOL_E2E), which the scores
# inherit.
RTOL_EVAL = RTOL_E2E


def evaluate(tmp, raw):
    """--eval-quality and --eval-holdout 0.1 on the small flow day (sparse
    pinned, 5 EM iterations) on the card and on the CPU: the completion
    and held-out per-token likelihoods within RTOL_EVAL; the card's
    quality run publishes to a local directory, which must hold the day
    directory's bytes (metrics.json as written before the copy)."""
    dest = formats.ensure_dir(os.path.join(tmp, "published"))
    scores = {}
    for flag, key, extra in (
            ("quality", "completion_per_token_ll", ("--eval-quality",)),
            ("holdout", "held_out_per_token_ll", ("--eval-holdout", "0.1"))):
        for dev, run in (("cuda", "card"), ("cpu", "host")):
            more = ("--publish", dest) if (flag, run) == ("quality",
                                                          "card") else ()
            day = run_day("flow", raw, os.path.join(
                tmp, f"eval_{flag}_{run}"), dev, "sparse", 5, *extra, *more)
            with open(os.path.join(day, "metrics.json")) as f:
                recs = json.load(f)
            scores[f"{flag}_{run}"] = {r["stage"]: r for r in recs}["lda"][key]
            if more:
                pub_day = day
                pub_recs = recs
    rel = {flag: abs(scores[f"{flag}_card"] - scores[f"{flag}_host"])
           / abs(scores[f"{flag}_host"]) for flag in ("quality", "holdout")}
    out = os.path.join(dest, "20160122")
    names = sorted(os.listdir(pub_day))
    copied = sorted(os.listdir(out)) == names and all(
        same_files(pub_day, out, [n for n in names
                                  if n != "metrics.json"]).values())
    with open(os.path.join(out, "metrics.json")) as f:
        delivered = json.load(f)
    copied = copied and delivered == pub_recs[:-1] and (
        pub_recs[-1]["stage"] == "publish")
    rec = {"scores": scores, "cuda_vs_cpu_rel": rel,
           "published_files": len(names), "published_byte_equal": copied}
    log("eval " + json.dumps(rec))
    if (max(rel.values()) > RTOL_EVAL or not copied
            or not all(np.isfinite(v) and v < 0 for v in scores.values())):
        fail(f"eval: {rec}")


# Serving (`ml_ops serve`): the two 2M days' models, each streamed
# SERVE_EVENTS raw events of its own input at the ServingConfig defaults.
# 40,960 events = 10 flushes of max_batch, 1 refresh (each refresh
# runs on the flush's worker, so flushes 9-10 score on the refreshed
# model: >= 2 versions; the members' streams below take the first
# 36,864).  Cut from 262,144 (64 flushes), whose phase
# took 97-104 s on the card and brought the whole run to ~520 s, then
# from 196,608 (48 flushes, 54.6-85.2 s) to make room for the multihost
# phase, then from 131,072 (32 flushes, 68.1-77.2 s) after the whole
# smoke took 1,110 s of its 1,200 on a slow host with the mesh phase,
# then from 98,304 (24 flushes, 61.7 s) for the plans phase, then from
# 65,536 (16 flushes, 52.3 s) for the bf16 paths; the parity streams
# (refresh off, host pinned or every flush on the card) take the first
# 32,768 (8 flushes).
SERVE_EVENTS = 40_960
SERVE_REFRESH_EVERY = 8
SERVE_PARITY_EVENTS = 32_768
# The per-batch members' served streams: one refresh, then a flush on
# the refreshed model.
SERVE_MEMBER_EVENTS = (SERVE_REFRESH_EVERY + 1) * 4096
# Device-path scores against the host's float64 (score_device's bound).
RTOL_SERVE_DEVICE = RTOL_SCORE
# A refresh on the card against the CPU: relative error over every
# nonzero entry of p and theta.  p's entries are ~1/V, so an absolute
# bound says nothing of them; the card reads ~1e-6 (float32 summation
# order), and the published p must move away from the day's p by more
# than this bound, so a step that did nothing cannot pass.
RTOL_REFRESH = 1e-4
# The refresh members: (label, OnlineLDAConfig.dense_em, ONI_ML_TPU_ESTEP,
# the step's member, the inference pass's member).
REFRESH_MEMBERS = (("dense", "auto", None, "dense", "per_batch:sparse"),
                   ("sparse", "off", None, "per_batch:sparse",
                    "per_batch:sparse"),
                   ("fixed_point", "off", "pallas", "per_batch:pallas",
                    "per_batch:pallas"))


def serve_events(tmp, dsource, raw):
    """The day's first SERVE_EVENTS raw events, as a file and as a list:
    its input's first lines, past the flow day's first line, which the
    flow pre stage drops as the header whatever it holds (synth.py
    writes none)."""
    lines = []
    with open(raw) as f:
        if dsource == "flow":
            f.readline()
        for line in f:
            lines.append(line)
            if len(lines) == SERVE_EVENTS:
                break
    path = os.path.join(tmp, f"serve_{dsource}.csv")
    with open(path, "w") as f:
        f.writelines(lines)
    return path, lines


def serve_registry(day, dsource):
    """(registry holding the day's model, the day's serving featurizer,
    the day's host scores of its first SERVE_EVENTS raw events: the
    float64 scorer over features.pkl's own rows, min(src, dest) for
    flow)."""
    from oni_ml_tpu_torch.config import ScoringConfig
    from oni_ml_tpu_torch.runner.ml_ops import _PortUnpickler
    from oni_ml_tpu_torch.scoring.score import _batched_scores
    from oni_ml_tpu_torch.serving import (ModelRegistry,
                                          featurizer_from_features)
    from oni_ml_tpu_torch.sources import get

    reg = ModelRegistry()
    model = reg.load_day(day, get(dsource).fallback(ScoringConfig())).model
    with open(os.path.join(day, "features.pkl"), "rb") as f:
        features = _PortUnpickler(f).load()
    featurizer = featurizer_from_features(features)
    idx = features.event_indices(model.ip_index, model.word_index)
    pairs = [idx[:2], idx[2:]] if dsource == "flow" else [idx]
    del features
    day_scores = [_batched_scores(model, ip[:SERVE_EVENTS], w[:SERVE_EVENTS])
                  for ip, w in pairs]
    return reg, featurizer, (day_scores[0] if len(day_scores) == 1
                             else np.minimum(*day_scores))


def quantiles(values):
    if not values:
        return None
    return {"p50": float(np.percentile(values, 50)),
            "p99": float(np.percentile(values, 99)), "flushes": len(values)}


def flush_stats(records):
    """Flush latency p50/p99 by path (host or device flushes) from the
    flush records, and their error records."""
    flushes = [r for r in records if "trigger" in r and "error" not in r]
    errors = [r for r in records if "error" in r or "on_batch_error" in r]
    return {path: quantiles([r["latency_ms"] for r in flushes
                             if r["scorer"] == path])
            for path in ("host", "device")}, flushes, errors


def serve_stream_in_process(dsource, reg, featurizer, lines, device_min,
                            refresh_every=0, dense_em="auto"):
    """One stream through a BatchScorer on the card, submitted as fast as
    it takes them, the refresh trainer at `dense_em`: (scores, versions,
    wall, the flush records, the refresh walls, the scorer)."""
    from oni_ml_tpu_torch.config import OnlineLDAConfig, ServingConfig
    from oni_ml_tpu_torch.serving import (BatchScorer, MetricsEmitter,
                                          RefreshLoop, event_documents)

    cfg = ServingConfig(device_score_min=device_min,
                        refresh_every=refresh_every)
    metrics = MetricsEmitter(to_stdout=False, keep_records=1 << 20)
    refresh = (RefreshLoop(reg, OnlineLDAConfig(
        num_topics=reg.active().model.num_topics, dense_em=dense_em),
        every=refresh_every, device="cuda") if refresh_every else None)
    refresh_s = []

    def on_batch(snapshot, feats, scores):
        if refresh is not None:
            new = refresh.observe(snapshot, *event_documents(feats, dsource))
            if new is not None:
                refresh_s.append(refresh.last_refresh_s)

    scorer = BatchScorer(reg, featurizer, cfg, metrics=metrics,
                         on_batch=on_batch, device="cuda")
    t0 = time.perf_counter()
    futures = [scorer.submit(line) for line in lines]
    scorer.close()
    wall = time.perf_counter() - t0
    if not all(f.done() for f in futures):
        fail(f"serve {dsource}: a future never resolved")
    results = [f.result(timeout=0) for f in futures]
    scores = np.array([s for s, _ in results])
    versions = np.array([v for _, v in results])
    return scores, versions, wall, list(metrics.records), refresh_s, scorer


def serve_cli(tmp, dsource, day, events):
    """The CLI as a user runs it: a subprocess of `ml_ops serve` over the
    day directory and the events file, refresh every 8 flushes, metrics
    and OpenMetrics files; its records, wall and exit code."""
    out = os.path.join(tmp, f"serve_{dsource}")
    for suffix in (".metrics.jsonl", ".openmetrics.txt"):
        if os.path.exists(out + suffix):  # the metrics file appends
            os.remove(out + suffix)
    cmd = [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", "serve",
           "--day-dir", day, "--dsource", dsource, "--input", events,
           "--refresh-every", str(SERVE_REFRESH_EVERY),
           "--metrics", out + ".metrics.jsonl",
           "--openmetrics", out + ".openmetrics.txt"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"serve {dsource} CLI exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    with open(out + ".metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    with open(out + ".openmetrics.txt") as f:
        om = f.read()
    if not om.endswith("# EOF\n") or "serve_latency_ms_bucket" not in om:
        fail(f"serve {dsource} CLI: the OpenMetrics file is not a scrape")
    return records, wall


def member_launches(counts, steps, member, infer):
    """Fail unless the kernels launched and ran (their own counters)
    exactly `steps` times per kernel of the step's member and of the
    inference pass's member."""
    want = {name: 0 for name in counts[0]}
    for m in (member, infer):
        for name in ENGINE_KERNELS[m]:
            want[name] += steps
    if counts[0] != want or counts[1] != want:
        fail(f"{member} / {infer} refresh: launched {counts[0]}, ran "
             f"{counts[1]}, expected {want}")


def serve_day(tmp, dsource, data, raw):
    """One 2M day served: host parity, device parity, the calibrated
    stream with refresh in process (its kernel launches), and the CLI."""
    from oni_ml_tpu_torch.config import ServingConfig
    from oni_ml_tpu_torch.plans.warmup import warmup_serving
    from oni_ml_tpu_torch.scoring import dispatch_calibration

    day = os.path.join(data, "20160122")
    events, lines = serve_events(tmp, dsource, raw)
    reg, featurizer, day_scores = serve_registry(day, dsource)
    day_model = reg.active().model
    n = len(lines)
    # Refresh off, every flush on the host: the day's own scores, bit
    # for bit (serving's featurization with the day's cuts builds the
    # day's words).
    m = SERVE_PARITY_EVENTS
    host, _, host_wall, host_recs, _, _ = serve_stream_in_process(
        dsource, reg, featurizer, lines[:m], None)
    if not np.array_equal(host, day_scores[:m]):
        bad = int(np.sum(host != day_scores[:m]))
        fail(f"serve {dsource}: {bad} host-path scores differ from the "
             "day's own scores")
    # Refresh off, every flush on the card, after the warm-up that the
    # CLI runs at --device-score-min 1 (every power-of-two size to
    # max_batch).
    warm = warmup_serving(day_model, ServingConfig.max_batch, 1,
                          device="cuda")
    dev, _, dev_wall, dev_recs, _, _ = serve_stream_in_process(
        dsource, reg, featurizer, lines[:m], 1)
    dev_rel = float(np.max(np.abs(dev - host) / np.abs(host)))
    if dev_rel > RTOL_SERVE_DEVICE or not all(
            r["scorer"] == "device" for r in dev_recs if "trigger" in r):
        fail(f"serve {dsource}: device-path scores rel {dev_rel:.3e} "
             f"(> {RTOL_SERVE_DEVICE}) or a flush off the card")
    # The defaults: calibrated dispatch, refresh every 8 flushes; the
    # kernels' counts zeroed just before and read just after.
    cal = dispatch_calibration(device="cuda")
    reset_kernel_counts()
    scores, versions, wall, recs, refresh_s, scorer = \
        serve_stream_in_process(dsource, reg, featurizer, lines, 0,
                                SERVE_REFRESH_EVERY)
    counts = (launch_counts(), executed_counts())
    lat, flushes, errors = flush_stats(recs)
    served = sorted(set(versions.tolist()))
    if (errors or scorer.events_scored != n or len(scores) != n
            or len(served) < 2 or not np.all(np.isfinite(scores))):
        fail(f"serve {dsource}: events_scored {scorer.events_scored} of {n}, "
             f"versions {served}, errors {errors[:3]}")
    # The path's kernels: the refresh step's member (the dense kernel at
    # dense_em auto) and the inference pass's per-batch kernel and
    # scatter, once per refresh each.
    steps = len(refresh_s)
    member_launches(counts, steps, "dense", "per_batch:sparse")
    # The CLI: exactly once across its hot-swaps.
    cli_recs, cli_wall = serve_cli(tmp, dsource, day, events)
    end = [r for r in cli_recs if r.get("event") == "stream_end"][0]
    cli_lat, cli_flushes, cli_errors = flush_stats(cli_recs)
    cli_versions = sorted({r["model_version"] for r in cli_flushes})
    plans_rec = [r for r in cli_recs if r.get("event") == "plans"][0]
    cli_refresh = [r["refresh_s"] for r in cli_recs
                   if r.get("event") == "model_refresh"]
    if (cli_errors or end["submitted"] != n or end["events_scored"] != n
            or len(cli_versions) < 2):
        fail(f"serve {dsource} CLI: {end}, versions {cli_versions}, errors "
             f"{cli_errors[:3]}")
    rec = {
        "dsource": dsource, "events": n,
        "model": {"ips": len(reg.active().model.ip_index),
                  "vocab": len(reg.active().model.word_index)},
        "parity_events": m, "host_bit_equal_to_day": True,
        "device_max_rel": dev_rel, "calibration": cal,
        "host_stream": {"wall_s": host_wall, "events_per_s": m / host_wall,
                        "latency_ms": flush_stats(host_recs)[0]["host"]},
        "device_stream": {"wall_s": dev_wall, "events_per_s": m / dev_wall,
                          "latency_ms": flush_stats(dev_recs)[0]["device"],
                          "warmup": warm},
        "default_stream": {
            "wall_s": wall, "events_per_s": n / wall, "latency_ms": lat,
            "flushes": len(flushes), "versions_served": len(served),
            "refreshes": steps, "refresh_s": refresh_s,
            "exactly_once": True, "launches": counts[0]},
        "cli": {"process_wall_s": cli_wall, "events_per_s": n / cli_wall,
                "latency_ms": cli_lat, "flushes": len(cli_flushes),
                "versions_served": cli_versions, "refreshes":
                len(cli_refresh), "refresh_s": cli_refresh,
                "calibration_source":
                    plans_rec.get("dispatch_calibration", {}).get("source"),
                "warmup": plans_rec["warmup"], "knobs": plans_rec["knobs"],
                "exit": 0, "exactly_once": True},
    }
    log("serve " + json.dumps(rec))
    return counts[0], featurizer, lines, day_model


def serve_members(dsource, featurizer, lines, model):
    """The per-batch refresh members on the served path: the day's model
    served its first SERVE_MEMBER_EVENTS events at the defaults, the
    refresh trainer at dense_em off (so the step takes the per-batch
    E-step), once with the sparse kernel and once under
    ONI_ML_TPU_ESTEP=pallas; the kernels' counts zeroed just before each
    stream and read just after.  Returns the launches summed over both
    streams."""
    from oni_ml_tpu_torch.serving import ModelRegistry

    total, out = {}, {}
    evidence = lines[:SERVE_MEMBER_EVENTS]
    for label, _, env, member, infer in REFRESH_MEMBERS[1:]:
        reg = ModelRegistry()
        reg.publish(model, "day")
        if env:
            os.environ["ONI_ML_TPU_ESTEP"] = env
        try:
            reset_kernel_counts()
            scores, versions, wall, recs, refresh_s, scorer = \
                serve_stream_in_process(dsource, reg, featurizer, evidence,
                                        0, SERVE_REFRESH_EVERY, "off")
            counts = (launch_counts(), executed_counts())
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP", None)
        _, flushes, errors = flush_stats(recs)
        served = sorted(set(versions.tolist()))
        if (errors or scorer.events_scored != len(evidence)
                or len(served) < 2 or not refresh_s
                or not np.all(np.isfinite(scores))):
            fail(f"serve {dsource} {label} refresh: events_scored "
                 f"{scorer.events_scored} of {len(evidence)}, versions "
                 f"{served}, refreshes {len(refresh_s)}, errors {errors[:3]}")
        member_launches(counts, len(refresh_s), member, infer)
        for name, c in counts[0].items():
            total[name] = total.get(name, 0) + c
        out[label] = {"wall_s": wall, "events_per_s": len(evidence) / wall,
                      "flushes": len(flushes), "versions_served": len(served),
                      "refresh_s": refresh_s, "launches": counts[0]}
    log("serve_members " + json.dumps({
        "dsource": dsource, "events": len(evidence), "members": out}))
    return total


def rel_errors(a, b):
    """|a - b| / |b| over b's nonzero entries; inf where b is zero and a
    is not."""
    nz = b != 0
    if np.any(a[~nz] != 0):
        return np.array([np.inf])
    return np.abs(a - b)[nz] / np.abs(b[nz])


def refresh_card_vs_cpu(dsource, featurizer, lines, model):
    """The same accumulated evidence (the stream's first
    SERVE_REFRESH_EVERY flushes) through a RefreshLoop on the card and on
    the CPU, once per member: the published p and theta within
    RTOL_REFRESH of the CPU's on every nonzero entry, the card's p and
    the theta rows of the evidence's IPs moved from the day's by more
    than that on the median entry (p has entries near 1e-38, so its
    largest move says nothing), and each card refresh's launches those
    of its member."""
    from oni_ml_tpu_torch.config import OnlineLDAConfig
    from oni_ml_tpu_torch.serving import (ModelRegistry, RefreshLoop,
                                          event_documents)

    evidence = lines[:SERVE_REFRESH_EVERY * 4096]
    feats = featurizer([featurizer.validate(line) for line in evidence])
    ips, words = event_documents(feats, featurizer.dsource)
    rows = sorted({model.ip_index[ip] for ip in ips if ip in model.ip_index})
    out = {}
    for label, dense_em, env, member, infer in REFRESH_MEMBERS:
        if env:
            os.environ["ONI_ML_TPU_ESTEP"] = env
        try:
            got = {}
            for dev in ("cuda", "cpu"):
                r = ModelRegistry()
                snap = r.publish(model, "day")
                loop = RefreshLoop(r, OnlineLDAConfig(
                    num_topics=model.num_topics, dense_em=dense_em),
                    every=1, device=dev)
                if dev == "cuda":
                    reset_kernel_counts()
                new = loop.observe(snap, ips, words)
                if dev == "cuda":
                    counts = (launch_counts(), executed_counts())
                got[dev] = (new.model, loop.last_refresh_s)
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP", None)
        member_launches(counts, 1, member, infer)
        card, cpu = got["cuda"][0], got["cpu"][0]
        rel, moved = {}, {}
        for name in ("p", "theta"):
            a, b = getattr(card, name), getattr(cpu, name)
            rel[name] = float(np.max(rel_errors(a, b)))
            day = getattr(model, name)
            if name == "theta":
                a, day = a[rows], day[rows]
            moved[name] = float(np.median(rel_errors(a, day)))
            if not rel[name] <= RTOL_REFRESH:
                fail(f"refresh {dsource} {label}: {name} card vs CPU rel "
                     f"{rel[name]:.3e} > {RTOL_REFRESH}")
            if not moved[name] > RTOL_REFRESH:
                fail(f"refresh {dsource} {label}: {name} moved from the "
                     f"day's by a median rel {moved[name]:.3e}, not past "
                     f"{RTOL_REFRESH}")
        out[label] = {"max_rel": rel, "moved_median_rel": moved,
                      "card_refresh_s": got["cuda"][1],
                      "cpu_refresh_s": got["cpu"][1], "launches": counts[0]}
    log("serve_refresh " + json.dumps({
        "dsource": dsource, "evidence_events": len(evidence),
        "pairs": len(ips), "docs": len(set(ips)), "rtol": RTOL_REFRESH,
        "members": out}))


def serve_phase(tmp):
    """`ml_ops serve` on the card over the two 2M days' models; the flow
    day's per-batch refresh members served; the refresh card against CPU
    per member on each day; `serve --dry-run`.  Returns the launches on
    the served streams per kernel: the default streams' (both days) and
    the per-batch members'."""
    import contextlib
    import io

    from oni_ml_tpu_torch.runner import serve

    t0 = time.perf_counter()
    total = {}
    days = []
    for dsource, data, raw in (
            ("flow", os.path.join(tmp, "data"),
             os.path.join(tmp, "flow_day.csv")),
            ("dns", os.path.join(tmp, "dns_data"),
             os.path.join(tmp, "dns_day.csv"))):
        counts, featurizer, lines, model = serve_day(tmp, dsource, data, raw)
        if dsource == "flow":
            for name, c in serve_members(dsource, featurizer, lines,
                                         model).items():
                counts[name] += c
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
        days.append((dsource, featurizer, lines, model))
    for day in days:
        refresh_card_vs_cpu(*day)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--dry-run"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or summary.get("serve_dry_run") != "ok" or (
            summary.get("device") != "cuda:0" and summary.get("device")
            != "cuda"):
        fail(f"serve --dry-run on cuda: rc {rc}, {summary}")
    log("serve_dry_run " + json.dumps(summary))
    if any(total[name] <= 0 for name in total):
        fail(f"serve path: a kernel never launched: {total}")
    log(f"serve phase: {time.perf_counter() - t0:.1f} s")
    return total


# The fleet phase (serve --fleet on the card).  Tenants: the 2M flow and
# DNS days' models and three _perturbed_model variants of each (other
# seeds, so demux corruption cannot hide behind equal values), and one
# K=10 tenant trained here on the small flow day, so the card runs two
# pack groups.  The default stream gives each 2M-day tenant its day's
# first FLEET_BIG_EVENTS raw events and the K=10 tenant its first
# FLEET_SMALL_EVENTS: 147,456 events, interleaved round-robin (196,608,
# 22,528 a 2M-day tenant, until the multihost phase needed the room).
FLEET_BIG_EVENTS = 16_384
FLEET_SMALL_EVENTS = 16_384
FLEET_REFRESH_EVERY = 8
FLEET_VARIANT_SEEDS = (101, 102, 103)
# Residency runs: each tenant's first FLEET_RESIDENCY_EVENTS in two
# visits (every tenant's first half, then every second half), so each
# tenant pages in once a visit through 4 hot slots per K and 2 warm.
FLEET_RESIDENCY_EVENTS = 8_192
FLEET_HOT, FLEET_WARM = 4, 2
# Their per-tenant admission bound: a visit's submitter blocks on its
# tenant's queue until the pager has promoted the tenant, so the run
# pages as the tenants arrive (not only at the close-time drain).
FLEET_RESIDENCY_QUEUE = 1024
# The per-batch refresh members' stream: two tenants, 9 flushes each.
FLEET_MEMBER_EVENTS = 9 * 2048
RTOL_FLEET_DEVICE = RTOL_SCORE
# A bf16 stack against the f32 stack's device scores: bfloat16's 8
# significand bits through a K-term float32 dot.
RTOL_BF16 = 2.0 ** -7


def first_lines(raw, dsource, n):
    """A day input's first n raw events (past the flow day's first line,
    which its pre stage drops as the header)."""
    lines = []
    with open(raw) as f:
        if dsource == "flow":
            f.readline()
        for line in f:
            lines.append(line)
            if len(lines) == n:
                break
    return lines


def fleet_tenants(tmp, raws):
    """The fleet's tenants: name -> dsource, model, featurizer, raw
    lines, day source (day dir and fallback, for the day's own model),
    and each day's host features of its lines, featurized once: the
    oracle every run is held to.  Trains the K=10 tenant (the small flow
    day, 5 EM iterations)."""
    from oni_ml_tpu_torch.config import ScoringConfig
    from oni_ml_tpu_torch.runner.serve import (_load_featurizer,
                                               _perturbed_model)
    from oni_ml_tpu_torch.serving import ModelRegistry
    from oni_ml_tpu_torch.sources import get

    t0 = time.perf_counter()
    k10 = run_day("flow", raws["flow"], os.path.join(tmp, "fleet_k10"),
                  "cuda", None, 5, "--topics", "10")
    train_s = time.perf_counter() - t0
    days = {
        "flow": (os.path.join(tmp, "data", "20160122"),
                 os.path.join(tmp, "flow_day.csv"), FLEET_BIG_EVENTS),
        "dns": (os.path.join(tmp, "dns_data", "20160122"),
                os.path.join(tmp, "dns_day.csv"), FLEET_BIG_EVENTS),
        "k10": (k10, raws["flow"], FLEET_SMALL_EVENTS),
    }
    tenants, day_feats = {}, {}
    featurize_s = featurize_n = 0
    for day, (day_dir, raw, n) in days.items():
        dsource = "dns" if day == "dns" else "flow"
        fallback = get(dsource).fallback(ScoringConfig())
        model = ModelRegistry().load_day(day_dir, fallback).model
        fz = _load_featurizer(day_dir, None)
        lines = first_lines(raw, dsource, n)
        t1 = time.perf_counter()
        feats = fz([fz.validate(line) for line in lines])
        featurize_s += time.perf_counter() - t1
        featurize_n += len(lines)
        day_feats[day] = get(dsource).event_pairs(feats)
        names = (["k10"] if day == "k10" else
                 [f"{day}{i}" for i in range(4)])
        for i, name in enumerate(names):
            tenants[name] = {
                "day": day, "dsource": dsource, "featurizer": fz,
                "lines": lines, "day_dir": day_dir,
                "model": model if i == 0 else _perturbed_model(
                    model, FLEET_VARIANT_SEEDS[i - 1]),
                "day_source": (day_dir, fallback) if i == 0 else None}
    for t in tenants.values():
        t["expect"] = host_scores(t["model"], day_feats[t["day"]],
                                  np.arange(len(t["lines"])))
    return tenants, day_feats, {
        "k10_train_s": train_s,
        "host_featurize_us_per_event": 1e6 * featurize_s / featurize_n}


def host_scores(model, pairs, idx):
    """score_features on the host over events `idx` of a day's (keys,
    words) blocks: min over the blocks of the float64 dot."""
    from oni_ml_tpu_torch.scoring import batched_scores

    out = None
    for keys, words in pairs:
        s = batched_scores(model, model.ip_rows([keys[i] for i in idx]),
                           model.word_rows([words[i] for i in idx]), None)
        out = s if out is None else np.minimum(out, s)
    return out


def interleaved(tenants, names, n=None):
    """(tenant, line) round-robin over `names`, each its first n lines
    (all of them for n None)."""
    lists = {t: tenants[t]["lines"][:n] for t in names}
    stream = []
    for i in range(max(len(v) for v in lists.values())):
        stream += [(t, lists[t][i]) for t in names if i < len(lists[t])]
    return stream


def fleet_run(label, tenants, stream, *, device_min=0, refresh_every=0,
              engine="auto", precision="f32", hot=0, warm=0, policy="lru",
              spill="", dense_em="auto", journal=None, queue_max=None):
    """One stream through a FleetScorer on the card, submitted as fast
    as it takes them: per tenant its scores and versions in submit
    order, the models it was served by version, the wall, the records,
    the refresh walls, the scorer's counts and the residency stats."""
    from oni_ml_tpu_torch.config import OnlineLDAConfig, ServingConfig
    from oni_ml_tpu_torch.serving import (FleetRegistry, FleetScorer,
                                          MetricsEmitter, RefreshLoop,
                                          ResidencyManager, TenantSpec,
                                          event_documents)

    names = list(dict.fromkeys(t for t, _ in stream))
    cfg = ServingConfig(device_score_min=device_min,
                        refresh_every=refresh_every, featurize_engine=engine,
                        stack_precision=precision,
                        tenant_queue_max=(queue_max or
                                          ServingConfig.tenant_queue_max))
    metrics = MetricsEmitter(to_stdout=False, keep_records=1 << 20,
                             journal=journal)
    fleet = FleetRegistry(journal=journal, recorder=metrics.recorder,
                          capacity_tiers=hot > 0, stack_precision=precision)
    mgr = (ResidencyManager(fleet, hot_capacity=hot, warm_capacity=warm,
                            policy=policy, spill_dir=spill, journal=journal,
                            recorder=metrics.recorder) if hot else None)
    models, refreshes, refresh_s = {}, {}, []
    for t in names:
        fleet.add_tenant(TenantSpec(tenant=t, dsource=tenants[t]["dsource"]),
                         hot=not hot)
        snap = fleet.publish(t, tenants[t]["model"], f"smoke-{t}")
        models[t] = {snap.version: snap.model}
        if mgr is not None:
            mgr.register(t, day_source=tenants[t]["day_source"])
        if refresh_every:
            refreshes[t] = RefreshLoop(
                fleet.view(t), OnlineLDAConfig(
                    num_topics=tenants[t]["model"].num_topics,
                    dense_em=dense_em),
                every=refresh_every, device="cuda")

    def on_batch(tenant, snapshot, feats, scores):
        models[tenant].setdefault(snapshot.version, snapshot.model)
        loop = refreshes.get(tenant)
        if loop is not None:
            new = loop.observe(snapshot, *event_documents(
                feats, tenants[tenant]["dsource"]))
            if new is not None:
                refresh_s.append(loop.last_refresh_s)

    scorer = FleetScorer(fleet, {t: tenants[t]["featurizer"] for t in names},
                         cfg, metrics=metrics, on_batch=on_batch,
                         journal=journal, residency=mgr, device="cuda")
    if mgr is not None:
        mgr.set_pending_probe(lambda t: scorer.pending(t) > 0)
    t0 = time.perf_counter()
    futures = [(t, scorer.submit(t, line)) for t, line in stream]
    scorer.close()
    wall = time.perf_counter() - t0
    stats = mgr.stats_snapshot() if mgr is not None else None
    if mgr is not None:
        mgr.close()
    if not all(f.done() for _, f in futures):
        fail(f"fleet {label}: a future never resolved")
    out = {t: ([], []) for t in names}
    for t, f in futures:
        s, v = f.result(timeout=0)
        out[t][0].append(s)
        out[t][1].append(v)
    recs = list(metrics.records)
    errors = [r for r in recs if "error" in r or "on_batch_error" in r]
    if (errors or scorer.counts["failures"] or scorer.events_scored
            != len(stream)):
        fail(f"fleet {label}: events_scored {scorer.events_scored} of "
             f"{len(stream)}, failures {scorer.counts['failures']}, "
             f"errors {errors[:3]}")
    return {"scores": {t: np.array(v[0]) for t, v in out.items()},
            "versions": {t: np.array(v[1]) for t, v in out.items()},
            "models": models, "wall": wall, "records": recs,
            "refresh_s": refresh_s, "counts": dict(scorer.counts),
            "plan": scorer.plan, "residency": stats, "fleet": fleet,
            "scorer": scorer, "metrics": metrics, "events": len(stream)}


def fleet_summary(run):
    """events/s, flush latency p50/p99 by scorer, dispatches per flush,
    tenants per packed dispatch, featurize µs per event by engine,
    refresh walls."""
    agg = [r for r in run["records"] if "segments" in r and "tenant" not in r]
    c = run["counts"]

    def per_event(path):
        n = c[f"featurize_{path}_events"]
        return 1e6 * c[f"featurize_{path}_s"] / n if n else None

    return {
        "events": run["events"], "wall_s": run["wall"],
        "events_per_s": run["events"] / run["wall"],
        "flushes": len(agg),
        "latency_ms": {path: quantiles([r["latency_ms"] for r in agg
                                        if r["scorer"] == path])
                       for path in ("host", "device")},
        "dispatches_per_flush": float(np.mean([r["segments"] for r in agg])),
        "tenants_per_dispatch": float(np.mean(
            [r["tenants"] / r["segments"] for r in agg if r["segments"]])),
        "featurize_us_per_event": {"device": per_event("device"),
                                   "host": per_event("host")},
        "counts": {k: v for k, v in c.items() if not k.endswith("_s")},
        "refreshes": len(run["refresh_s"]), "refresh_s": run["refresh_s"],
    }


def check_fleet_scores(label, run, tenants, day_feats, ref=None, rtol=0.0):
    """Every tenant's scores against the host oracle on the model version
    that scored each event (bit for bit where every flush scored on the
    host and rtol is 0, else within rtol), or against `ref` (scores per
    tenant) within rtol.  -> the largest relative difference."""
    on_card = any(r.get("scorer") == "device" for r in run["records"])
    worst = 0.0
    for t, got in run["scores"].items():
        versions = run["versions"][t]
        if ref is not None:
            want = ref[t]
        else:
            want = np.empty(len(got))
            for v in np.unique(versions):
                idx = np.nonzero(versions == v)[0]
                want[idx] = (tenants[t]["expect"][idx] if v == 1 else
                             host_scores(run["models"][t][int(v)],
                                         day_feats[tenants[t]["day"]], idx))
        if not np.all(np.isfinite(got)):
            fail(f"fleet {label}: tenant {t} has non-finite scores")
        if ref is None and not on_card and rtol == 0.0:
            if not np.array_equal(got, want):
                fail(f"fleet {label}: tenant {t}: "
                     f"{int(np.sum(got != want))} scores differ from its "
                     "own model's alone")
            continue
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        worst = max(worst, rel)
        if not rel <= (rtol or RTOL_FLEET_DEVICE):
            fail(f"fleet {label}: tenant {t} rel {rel:.3e} > "
                 f"{rtol or RTOL_FLEET_DEVICE}")
    return worst


def stack_device_bytes(run, k):
    """Bytes of the K-group stack's device copies (tensor nbytes)."""
    from oni_ml_tpu_torch.scoring.score import _device_model

    theta, p = _device_model(run["fleet"].stack(k).model, run["scorer"].device)
    return {"dtype": str(theta.dtype), "bytes": int(theta.nbytes + p.nbytes),
            "theta_rows": int(theta.shape[0]), "p_rows": int(p.shape[0])}


def residency_runs(tmp, tenants, day_feats):
    """--hot-tenants 4 --warm-tenants 2 with a spill dir, LRU then LFU:
    promotions, evictions and cold reloads, every score the tenant's own
    model's alone at version 1, a tenant paged cold and back among them;
    the promotion stalls."""
    from oni_ml_tpu_torch.telemetry import Journal

    half = FLEET_RESIDENCY_EVENTS // 2
    names = list(tenants)
    stream = []
    for lo in (0, half):
        for t in names:
            stream += [(t, line) for line in
                       tenants[t]["lines"][lo:lo + half]]
    out = {}
    for policy in ("lru", "lfu"):
        jpath = os.path.join(tmp, f"fleet_{policy}.jsonl")
        journal = Journal(jpath)
        run = fleet_run(f"residency_{policy}", tenants, stream,
                        hot=FLEET_HOT, warm=FLEET_WARM, policy=policy,
                        spill=os.path.join(tmp, f"spill_{policy}"),
                        journal=journal, queue_max=FLEET_RESIDENCY_QUEUE)
        journal.close()
        check_fleet_scores(f"residency_{policy}", run, tenants, day_feats)
        res = run["residency"]
        versions = {int(v) for t in names for v in run["versions"][t]}
        records = list(Journal.replay(jpath))
        cold = {r["tenant"] for r in records
                if r["kind"] == "residency_evict" and r.get("tier_to")
                == "cold"}
        back = {r["tenant"] for r in records
                if r["kind"] == "residency_promote" and r.get("ok")
                and r.get("tier_from") == "cold"}
        stalls = [r["stall_s"] for r in records
                  if r["kind"] == "residency_promote" and "stall_s" in r]
        if (res["promotions"] <= 0 or res["evictions"] <= 0
                or res["failures"] or versions != {1} or not cold & back):
            fail(f"fleet residency {policy}: {res}, versions {versions}, "
                 f"paged cold and back {sorted(cold & back)}")
        out[policy] = {**fleet_summary(run), "residency": res,
                       "paged_cold_and_back": sorted(cold & back),
                       "promotion_stall_s": quantiles(stalls),
                       "same_model_version": True}
    return out


def fleet_cli(tmp, tenants):
    """`serve --fleet manifest.json --device cuda` as a subprocess: 8
    tenant names over the two 2M day dirs, a tagged interleaved stream,
    refresh every 8: exit 0, every event scored once, >= 2 versions per
    tenant, no error record."""
    names = [t for t in tenants if tenants[t]["day"] != "k10"]
    manifest = os.path.join(tmp, "fleet.json")
    with open(manifest, "w") as f:
        json.dump({"tenants": [{"tenant": t, "day_dir": tenants[t]["day_dir"],
                                "dsource": tenants[t]["dsource"]}
                               for t in names]}, f)
    events = os.path.join(tmp, "fleet_events.tsv")
    n = 0
    with open(events, "w") as f:
        for t, line in interleaved(tenants, names):
            f.write(f"{t}\t{line}")
            n += 1
    out = os.path.join(tmp, "fleet_cli")
    cmd = [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", "serve",
           "--fleet", manifest, "--device", "cuda", "--input", events,
           "--refresh-every", str(FLEET_REFRESH_EVERY),
           "--metrics", out + ".metrics.jsonl",
           "--openmetrics", out + ".openmetrics.txt"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"serve --fleet CLI exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    with open(out + ".metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    end = [r for r in recs if r.get("event") == "stream_end"][0]
    agg = [r for r in recs if "segments" in r and "tenant" not in r]
    errors = [r for r in recs if "error" in r or "on_batch_error" in r]
    plans_rec = [r for r in recs if r.get("event") == "plans"][0]
    if (errors or end["submitted"] != n or end["events_scored"] != n
            or min(end["final_versions"].values()) < 2
            or end["fleet_counts"]["failures"]):
        fail(f"serve --fleet CLI: {end}, errors {errors[:3]}")
    return {"tenants": len(names), "events": n, "process_wall_s": wall,
            "events_per_s": n / wall, "flushes": len(agg),
            "latency_ms": {path: quantiles([r["latency_ms"] for r in agg
                                            if r["scorer"] == path])
                           for path in ("host", "device")},
            "final_versions": end["final_versions"],
            "fleet_counts": end["fleet_counts"], "knobs": plans_rec["knobs"],
            "warmup": plans_rec["warmup"],
            "refresh_s": [r["refresh_s"] for r in recs
                          if r.get("event") == "model_refresh"]}


def fleet_phase(tmp, raws):
    """`serve --fleet` on the card (see the module docstring).  Returns
    the launches on the fleet's path per kernel: the default stream's
    refreshes and the per-batch members' (fixed point included)."""
    import contextlib
    import io

    from oni_ml_tpu_torch.runner import serve
    from oni_ml_tpu_torch.scoring import dispatch_calibration
    from oni_ml_tpu_torch.sources.device import measure_break_even
    from oni_ml_tpu_torch.telemetry import roofline

    t0 = time.perf_counter()
    tenants, day_feats, setup = fleet_tenants(tmp, raws)
    names = list(tenants)
    stream = interleaved(tenants, names)
    if len(stream) != 8 * FLEET_BIG_EVENTS + FLEET_SMALL_EVENTS:
        fail(f"fleet stream holds {len(stream)} events")
    cal = dispatch_calibration(device="cuda")
    out = {"tenants": {t: {"dsource": v["dsource"], "k": v["model"]
                           .num_topics, "events": len(v["lines"])}
                       for t, v in tenants.items()},
           "setup": setup, "calibration": cal}
    # 1. The defaults (device featurize engine, calibrated dispatch),
    # each tenant refreshing every 8 of its flushes; the kernels' counts
    # zeroed just before and read just after.
    reset_kernel_counts()
    run1 = fleet_run("default", tenants, stream,
                     refresh_every=FLEET_REFRESH_EVERY)
    counts1 = (launch_counts(), executed_counts())
    check_fleet_scores("default", run1, tenants, day_feats)
    served = {t: len(run1["models"][t]) for t in names}
    if min(served.values()) < 2:
        fail(f"fleet default: versions served per tenant {served}")
    member_launches(counts1, len(run1["refresh_s"]), "dense",
                    "per_batch:sparse")
    out["default"] = {**fleet_summary(run1), "versions_served": served,
                      "launches": counts1[0], "exactly_once": True,
                      "plan": run1["plan"]}
    # 2. Every K-group dispatch on the card.
    run2 = fleet_run("device", tenants, stream, device_min=1)
    rel2 = check_fleet_scores("device", run2, tenants, day_feats,
                              rtol=RTOL_FLEET_DEVICE)
    if any(r["scorer"] != "device" for r in run2["records"]
           if "segments" in r and "tenant" not in r):
        fail("fleet device: a flush scored off the card")
    out["device"] = {**fleet_summary(run2), "max_rel": rel2,
                     "stack": stack_device_bytes(run2, 20)}
    # 3. The fused engine: every K-group of one tenant, so each flush
    # takes one fused call per group.
    fused = {}
    for group in (("flow0", "k10"), ("dns0",)):
        run3 = fleet_run("fused", tenants, interleaved(tenants, group),
                         engine="fused")
        rel3 = check_fleet_scores("fused", run3, tenants, day_feats,
                                  rtol=RTOL_FLEET_DEVICE)
        hd = run3["metrics"].recorder.histograms["serve.device_score_ms"]
        if run3["counts"]["fused_dispatches"] <= 0:
            fail(f"fleet fused {group}: no fused call")
        cost = roofline.cost_for("serve.featurize_fused")
        fused["+".join(group)] = {
            **fleet_summary(run3), "max_rel": rel3,
            "fused_ms": {"mean": hd.total / hd.count,
                         "p50": hd.quantile(0.5), "p99": hd.quantile(0.99),
                         "calls": hd.count},
            "roofline": roofline.emit("serve.featurize_fused",
                                      hd.total / 1e3, dispatches=hd.count,
                                      recorder=run3["metrics"].recorder),
            "cost": cost}
    fused["calibrated_dispatch_ms"] = (cal["dispatch_s"] * 1e3
                                       if cal["dispatch_s"] else None)
    out["fused"] = fused
    # 4. Tiered residency.
    out["residency"] = residency_runs(tmp, tenants, day_feats)
    # 5. A bf16 stack against run 2's f32 stack.
    run5 = fleet_run("bf16", tenants, stream, device_min=1, precision="bf16")
    rel5 = check_fleet_scores("bf16", run5, tenants, day_feats,
                              ref=run2["scores"], rtol=RTOL_BF16)
    b32, b16 = out["device"]["stack"], stack_device_bytes(run5, 20)
    if b16["bytes"] * 2 != b32["bytes"] or b16["dtype"] != "torch.bfloat16":
        fail(f"fleet bf16: stack {b16} against f32 {b32}")
    out["bf16"] = {**fleet_summary(run5), "max_rel_vs_f32": rel5,
                   "stack": b16}
    # The per-batch refresh members on the fleet's path: the step's
    # dense_em off, once on the sparse kernel and once under
    # ONI_ML_TPU_ESTEP=pallas (the fixed point).
    members = {}
    total = dict(counts1[0])
    for label, _, env, member, infer in REFRESH_MEMBERS[1:]:
        if env:
            os.environ["ONI_ML_TPU_ESTEP"] = env
        try:
            reset_kernel_counts()
            runm = fleet_run(label, tenants, interleaved(
                tenants, ("flow1", "k10"), FLEET_MEMBER_EVENTS),
                refresh_every=FLEET_REFRESH_EVERY, dense_em="off")
            counts = (launch_counts(), executed_counts())
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP", None)
        check_fleet_scores(label, runm, tenants, day_feats)
        if not runm["refresh_s"]:
            fail(f"fleet {label} refresh: no refresh")
        member_launches(counts, len(runm["refresh_s"]), member, infer)
        for name, c in counts[0].items():
            total[name] += c
        members[label] = {**fleet_summary(runm), "launches": counts[0]}
    out["members"] = members
    # measure_break_even on the card's host path, recorded in this run's
    # plan cache; the CLI below reads it from there.
    flow = tenants["flow0"]
    rows = [line.strip().split(",") for line in flow["lines"][:512]]
    be, samples = measure_break_even(flow["featurizer"], rows,
                                     flow["lines"][:512], flow["model"],
                                     device="cuda")
    out["break_even"] = {"featurize_break_even": be, "samples": samples}
    # 6. The CLI, and the fleet dry run on cuda.
    out["cli"] = fleet_cli(tmp, tenants)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--dry-run", "--fleet", "synthetic:4"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or summary.get("serve_fleet_dry_run") != "ok" or \
            not str(summary.get("device")).startswith("cuda"):
        fail(f"serve --dry-run --fleet on cuda: rc {rc}, {summary}")
    out["dry_run"] = {k: summary[k] for k in ("serve_fleet_dry_run",
                                              "device", "tenants",
                                              "events_scored")}
    if any(total[name] <= 0 for name in total):
        fail(f"fleet path: a kernel never launched: {total}")
    out["launches_fleet"] = total
    out["phase_s"] = time.perf_counter() - t0
    log("fleet " + json.dumps(out, default=str))
    log(f"fleet phase: {out['phase_s']:.1f} s")
    return total


# The continuous standing service (runner/continuous.py) on the card.
CONT_SLICE_S = 300.0
# Cut to size (PERF.md §4), in the order the phase's sizing allows:
# part 1's 6 event hours to 2 (its CPU runs took 80 of the first run's
# 214 s), then to 1 (a fresh fit and a warm one per engine: the CPU runs
# took 47 of its 49 s at 2), then part 2's 8 to 6 (the floor that still
# passes the 9 warm-up refreshes).  Part 3 runs 3 hours: both tenants' first refits
# fall due 30 event minutes in and run one after the other on the one
# refresh worker, and under the fleet's ingest the flow day's first fit
# took 6.6-16.5 s where it takes 3.0 s alone, so at 2 hours (30 s paced)
# its first publish landed 1.3-6.3 s before the stream's end, or after.
CONT_SMALL_HOURS = 1
CONT_FLOW_HOURS = 6
CONT_FLEET_HOURS = 3
# Part 3's replay pace (event seconds per wall second): unpaced, the
# ingest ran through 2 event hours before the first refit published, so
# nothing was scored and no serve slot met a refit.  At 240x one tenant's
# in-process scoring keeps the serve plane near saturation once its model
# published (~5,500 events/s against ~6,600 scored a second), and the
# co-scheduled first fit of the other tenant, yielding to every slot,
# once missed all 37 s left of the stream; the co-scheduler now bounds a
# first fit's summed yielding at starvation_s, and the phase checks
# that every tenant scores.
CONT_FLEET_SPEED = 240.0
RTOL_CONT_LL = 1e-4
# A flagged event that one run flags and the other does not must score
# within this relative band below the threshold (float32 ties).
RTOL_CONT_TIE = 1e-3
# Part 1's pinned runs: (label, ONI_ML_TPU_ESTEP, ContinuousConfig
# overrides, the kernels the card run must launch).  The dense kernel
# runs under the chunk driver (the stepwise driver takes the dense
# family per batch).
CONT_ENGINES = (("sparse", "sparse", {}, ("sparse_estep", "sparse_scatter")),
                ("dense", "dense", {"fused_em_chunk": 16},
                 ("dense_estep",)),
                ("pallas", "pallas", {}, ("fixed_point_estep",
                                          "sparse_scatter")))


_CONT_DAYS: dict = {}


def cont_slices(raw, dsource, hours):
    """The raw day's first `hours` event hours as 300-s slices (each day
    is read and sliced once per run)."""
    from oni_ml_tpu_torch.runner.continuous import slice_events

    if (raw, dsource) not in _CONT_DAYS:
        with open(raw) as f:
            _CONT_DAYS[raw, dsource] = slice_events(f.readlines(), dsource,
                                                    CONT_SLICE_S)
    slices = _CONT_DAYS[raw, dsource]
    end = slices[0].t0 + hours * 3600.0
    return [slice_copy(s) for s in slices if s.t1 <= end]


def cont_config(data, **cc):
    from oni_ml_tpu_torch.config import ContinuousConfig, PipelineConfig

    return PipelineConfig(data_dir=data, continuous=ContinuousConfig(**cc))


def cont_check(label, svc, payload):
    """Exactly once, no failed future, no abandoned refresh, no build
    past the warm-up boundary."""
    ledger = {"ingested": svc.events, "unserved": svc.events_unserved,
              "offered": svc.events_offered, "scored": svc.events_scored,
              "rejected": svc.events_rejected,
              "failures": svc.score_failures}
    if (svc.events_scored + svc.events_rejected + svc.events_unserved
            != svc.events or svc.events_scored != svc.events_offered
            or svc.score_failures):
        fail(f"continuous {label}: not exactly once: {ledger}")
    if (payload["retraces_after_warmup"] or 0) > 0:
        fail(f"continuous {label}: {payload['retraces_after_warmup']} "
             "builds after the warm-up boundary")
    return ledger


def cont_summary(payload, wall, events):
    """The printed figures of one service run."""
    keys = ("refreshes", "publishes", "vetoes", "quality_checks",
            "quality_vetoes", "skipped_refreshes", "freshness_p50_s",
            "freshness_p99_s", "freshness_event_p50_min",
            "freshness_event_p99_min", "serve_idle_p99_ms",
            "serve_refresh_p99_ms", "vocab", "vocab_capacity",
            "tier_rebuilds", "retraces_after_warmup", "flagged", "warm",
            "fresh")
    out = {k: payload.get(k) for k in keys}
    ctrl = payload.get("fresh_control") or {}
    out.update(events=events, wall_s=wall, events_per_s=events / wall,
               warm_start_speedup=ctrl.get("warm_start_speedup"),
               held_out_ll_delta=ctrl.get("held_out_ll_delta"),
               fresh_control=ctrl or None,
               engines=[(r["refresh"], r["mode"], r["estep_engine"],
                         r["estep_engine_source"], r["member"],
                         r["em_iters"], r["train_wall_s"])
                        for r in payload["refresh_records"]])
    return out


def cont_journal_abandons(path):
    with open(path) as f:
        return [r for r in map(json.loads, f)
                if r.get("kind") == "refresh_abandon"]


def cont_run(label, tmp, dsource, slices, dev, env=None, fresh=False,
             **cc):
    """One ContinuousService run over `slices` on `dev`, the kernels'
    counts zeroed just before and read just after."""
    from oni_ml_tpu_torch.runner.continuous import ContinuousService

    data = os.path.join(tmp, f"cont_{label}_{dev}")
    if env:
        os.environ["ONI_ML_TPU_ESTEP"] = env
    try:
        svc = ContinuousService(cont_config(data, **cc), dsource,
                                out_dir=os.path.join(data, "continuous"),
                                fresh_control=fresh, device=dev)
        reset_kernel_counts()
        t0 = time.perf_counter()
        payload = svc.run(slices)
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        os.environ.pop("ONI_ML_TPU_ESTEP", None)
    ledger = cont_check(f"{label} {dev}", svc, payload)
    with open(os.path.join(data, "continuous",
                           "flagged_events.jsonl")) as f:
        flagged = [json.loads(line) for line in f]
    return {"payload": payload, "wall": wall, "counts": counts,
            "ledger": ledger, "flagged": flagged, "service": svc}


def cont_flag_diff(card, cpu, threshold):
    """Flagged events one run flags and the other does not; each must
    lie in the float32 tie band under the threshold."""
    def key(r):
        return (tuple(r["flagged"]), r["model_version"])

    a = {key(r): r["score"] for r in card}
    b = {key(r): r["score"] for r in cpu}
    only = [(k, s) for k, s in a.items() if k not in b] + \
        [(k, s) for k, s in b.items() if k not in a]
    far = [s for _, s in only if s < threshold * (1 - RTOL_CONT_TIE)]
    return len(a), len(b), len(only), far


def cont_card_vs_cpu(tmp, raw):
    """Part 1: the small flow day's first hours on the card and on the
    CPU under each pinned engine."""
    from oni_ml_tpu_torch.config import ServingConfig

    slices = cont_slices(raw, "flow", CONT_SMALL_HOURS)
    out = {"slices": len(slices), "events": sum(s.events for s in slices)}
    counts = {}
    for label, env, cc, kernels in CONT_ENGINES:
        runs = {dev: cont_run(f"small_{label}", tmp, "flow",
                              [slice_copy(s) for s in slices], dev,
                              env=env, **cc)
                for dev in ("cuda", "cpu")}
        seq = {dev: [(r["mode"], r["published"], r["drifted"], r["version"])
                     for r in runs[dev]["payload"]["refresh_records"]]
               for dev in runs}
        if seq["cuda"] != seq["cpu"] or not seq["cuda"]:
            fail(f"continuous card vs CPU {label}: {seq}")
        ll = {dev: np.array([r["held_out_ll"] for r in
                             runs[dev]["payload"]["refresh_records"]])
              for dev in runs}
        rel = float(np.max(np.abs(ll["cuda"] - ll["cpu"])
                           / np.abs(ll["cpu"])))
        if rel > RTOL_CONT_LL:
            fail(f"continuous card vs CPU {label}: held-out ll rel {rel}")
        n_card, n_cpu, n_diff, far = cont_flag_diff(
            runs["cuda"]["flagged"], runs["cpu"]["flagged"],
            ServingConfig.threshold)
        if far:
            fail(f"continuous card vs CPU {label}: {len(far)} flagged "
                 f"events differ away from the threshold: {far[:5]}")
        launched = runs["cuda"]["counts"]
        if any(launched[k] <= 0 for k in kernels):
            fail(f"continuous {label}: the card run launched {launched}")
        counts[label] = launched
        out[label] = {"refreshes": len(seq["cuda"]),
                      "sequence": seq["cuda"], "max_rel_ll": rel,
                      "flagged_card": n_card, "flagged_cpu": n_cpu,
                      "flagged_tie_diff": n_diff, "launches": launched,
                      "card": cont_summary(runs["cuda"]["payload"],
                                           runs["cuda"]["wall"],
                                           out["events"]),
                      "cpu_wall_s": runs["cpu"]["wall"]}
        log(f"continuous card_vs_cpu {label} "
            + json.dumps(out[label], default=str))
    return out, counts


def slice_copy(sl, shift=0.0):
    """A fresh IngestSlice of the same lines (the service stamps arrival
    walls on the slices it consumes), its span moved by `shift`."""
    from oni_ml_tpu_torch.runner.continuous import IngestSlice

    return IngestSlice(lines=sl.lines, t0=sl.t0 - shift, t1=sl.t1 - shift,
                       index=sl.index)


def cont_flow_replay(tmp, raw):
    """Part 2: the 2M flow day's first event hours at the ContinuousConfig
    defaults, the fresh control and the quality gate on, the engine from
    the crossover."""
    slices = cont_slices(raw, "flow", CONT_FLOW_HOURS)
    events = sum(s.events for s in slices)
    run = cont_run("flow2m", tmp, "flow", slices, "cuda", fresh=True,
                   quality_gate=True)
    payload, svc = run["payload"], run["service"]
    recs = payload["refresh_records"]
    warm_after = [r for r in recs if r["refresh"] > svc.warmup_refreshes
                  and r["mode"] == "warm"]
    if not warm_after:
        fail(f"continuous flow replay: no warm refresh past the warm-up "
             f"boundary ({svc.warmup_refreshes}): "
             f"{[(r['refresh'], r['mode']) for r in recs]}")
    if payload["fresh_control"] is None:
        fail("continuous flow replay: the fresh control did not run")
    if payload["retraces_after_warmup"] != 0:
        fail("continuous flow replay: retraces_after_warmup "
             f"{payload['retraces_after_warmup']}")
    # The engine resolves once per capacity tier; the crossover is
    # measured at most there (the plan store serves it after).
    resolved = [r for r in recs if r["estep_resolved"]]
    measured = [r for r in resolved if r["estep_engine_source"]
                == "measured"]
    if len(resolved) != payload["tier_rebuilds"]:
        fail(f"continuous flow replay: the engine resolved at refreshes "
             f"{[r['refresh'] for r in resolved]} over "
             f"{payload['tier_rebuilds']} tiers")
    launched = run["counts"]
    if launched["sparse_estep"] <= 0 or launched["sparse_scatter"] <= 0:
        fail(f"continuous flow replay: launches {launched}")
    out = cont_summary(payload, run["wall"], events)
    out.update(slices=len(slices), ledger=run["ledger"], launches=launched,
               warmup_refreshes=svc.warmup_refreshes,
               crossover_measurements=len(measured))
    log("continuous flow_replay " + json.dumps(out, default=str))
    return out, launched


def cont_first_fits(path):
    """The co-scheduler's fit records of first fits in a fleet journal:
    tenant -> (wall_s, yield_wait_s, first_fit_bound_chunk)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if (rec.get("kind") == "cosched" and rec.get("event") == "fit"
                    and rec.get("first_publish")):
                out[rec["tenant"]] = (rec["wall_s"], rec["yield_wait_s"],
                                      rec["first_fit_bound_chunk"])
    return out


def cont_fleet(tmp):
    """Part 3: the 2M flow and DNS days' first event hours, each from its
    own start, interleaved by event time and paced at CONT_FLEET_SPEED,
    through the in-process fleet with and without the co-scheduler."""
    from oni_ml_tpu_torch.runner.continuous import (FleetContinuousService,
                                                    interleave_streams,
                                                    paced_tagged)

    per = {"flow": cont_slices(os.path.join(tmp, "flow_day.csv"), "flow",
                               CONT_FLEET_HOURS),
           "dns": cont_slices(os.path.join(tmp, "dns_day.csv"), "dns",
                              CONT_FLEET_HOURS)}
    events = sum(s.events for sl in per.values() for s in sl)
    out = {"events": events}
    total = {}
    for cosched in (True, False):
        label = "cosched" if cosched else "no_cosched"
        data = os.path.join(tmp, f"cont_fleet_{label}")
        fleet = FleetContinuousService(
            cont_config(data), {t: t for t in per},
            out_dir=os.path.join(data, "continuous_fleet"),
            coscheduler=cosched, device="cuda")
        # Each day from its own start: flow's clock is seconds of the
        # day, DNS's the epoch, so the spans are taken relative to each
        # day's first slice before they interleave.
        tagged = paced_tagged(interleave_streams(
            {t: [slice_copy(s, sl[0].t0) for s in sl]
             for t, sl in per.items()}), CONT_FLEET_SPEED)
        reset_kernel_counts()
        t0 = time.perf_counter()
        payload = fleet.run(tagged)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        abandons = cont_journal_abandons(os.path.join(
            data, "continuous_fleet", "run_journal.jsonl"))
        if payload["refresh_errors"] or abandons:
            fail(f"continuous fleet {label}: refresh errors "
                 f"{payload['refresh_errors']}, {abandons[:3]}")
        if (payload["retraces_after_warmup"] or 0) > 0:
            fail(f"continuous fleet {label}: retraces_after_warmup "
                 f"{payload['retraces_after_warmup']}")
        ledgers = {t: cont_check(f"fleet {label} {t}", svc,
                                 payload["tenants"][t])
                   for t, svc in fleet.services.items()}
        if not all(led["scored"] for led in ledgers.values()):
            fail(f"continuous fleet {label}: a tenant scored nothing: "
                 f"{ledgers}")
        first_fits = cont_first_fits(os.path.join(
            data, "continuous_fleet", "run_journal.jsonl"))
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
        out[label] = {
            "wall_s": wall, "events_per_s": events / wall,
            "refreshes": payload["refreshes"],
            "publishes": payload["publishes"],
            "coalesced_refreshes": payload["coalesced_refreshes"],
            "retraces_after_warmup": payload["retraces_after_warmup"],
            "freshness_event_p99_min": payload.get(
                "freshness_event_p99_min"),
            "cosched": payload["cosched"], "ledgers": ledgers,
            "launches": counts,
            "tenants": {t: {k: p.get(k) for k in (
                "refreshes", "publishes", "serve_idle_p99_ms",
                "serve_refresh_p99_ms", "freshness_p99_s",
                "freshness_event_p99_min", "vocab", "vocab_capacity",
                "tier_rebuilds", "warm", "fresh")}
                for t, p in payload["tenants"].items()},
            "engines": {t: [(r["refresh"], r["mode"], r["estep_engine"],
                             r["estep_engine_source"], r["member"])
                            for r in p["refresh_records"]]
                        for t, p in payload["tenants"].items()},
            # Each tenant's first fit: its wall, its summed yield wait
            # and the chunk at which the co-scheduler's first-fit bound
            # stopped the yielding (None: it never acted).
            "first_fits": first_fits,
        }
        log(f"continuous fleet {label} "
            + json.dumps(out[label], default=str))
    return out, total


def cont_cli(tmp, raws):
    """Part 4: `ml_ops continuous` on cuda as two subprocesses at once,
    single tenant and two --stream tenants (their output to files);
    --multihost with --stream refused with exit 2 (the multihost phase
    runs `continuous --multihost` on one stream; `--replicated` runs in
    the replicated phase)."""
    import contextlib
    import io

    from oni_ml_tpu_torch.runner import continuous

    out = {}
    runs = {"single": ["flow", "--flow-path", raws["flow"]],
            "streams": ["--stream", f"acme=flow:{raws['flow']}",
                        "--stream", f"globex=dns:{raws['dns']}"]}
    # Both processes at once, each on the card.
    procs = {}
    t0 = time.perf_counter()
    for label, args in runs.items():
        data = os.path.join(tmp, f"cont_cli_{label}")
        cmd = [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops",
               "continuous", *args, "--no-sleep", "--device", "cuda",
               "--data-dir", data]
        with open(data + ".out", "w") as fo, open(data + ".err", "w") as fe:
            procs[label] = (subprocess.Popen(
                cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=fo, stderr=fe), data)
    for label, (proc, data) in procs.items():
        proc.wait(timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            with open(data + ".err") as f:
                fail(f"ml_ops continuous {label} exited {proc.returncode}: "
                     f"{f.read()[-2000:]}")
        with open(data + ".out") as f:
            payload = json.loads(f.read().strip().splitlines()[-1])
        if (payload["publishes"] < 1
                or (payload["retraces_after_warmup"] or 0) > 0
                or payload.get("refresh_errors")):
            fail(f"ml_ops continuous {label}: {payload}")
        out[label] = {"process_wall_s": wall, "events": payload["events"],
                      "refreshes": payload["refreshes"],
                      "publishes": payload["publishes"],
                      "coalesced_refreshes":
                          payload.get("coalesced_refreshes")}
    for flags, item in ((["--multihost", "--stream",
                          f"acme=flow:{raws['flow']}"], "single-stream"),):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = continuous.main(flags)
        if rc != 2 or item not in buf.getvalue():
            fail(f"ml_ops continuous {flags[0]}: rc {rc}, "
                 f"{buf.getvalue()!r}")
        out[flags[0]] = {"rc": rc, "message": buf.getvalue().strip()}
    return out


def continuous_phase(tmp, raws):
    """`ml_ops continuous` on the card (see the module docstring).
    Returns the launches on the continuous path per kernel."""
    t0 = time.perf_counter()
    out = {}
    total = {}
    walls = {}
    t1 = time.perf_counter()
    part1, counts1 = cont_card_vs_cpu(tmp, raws["flow"])
    out["card_vs_cpu"] = part1
    walls["card_vs_cpu"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["flow_replay"], counts2 = cont_flow_replay(
        tmp, os.path.join(tmp, "flow_day.csv"))
    walls["flow_replay"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["fleet"], counts3 = cont_fleet(tmp)
    walls["fleet"] = time.perf_counter() - t1
    for counts in (*counts1.values(), counts2, counts3):
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
    if any(total.get(name, 0) <= 0 for name in SOURCES):
        fail(f"continuous path: a kernel never launched: {total}")
    t1 = time.perf_counter()
    out["cli"] = cont_cli(tmp, raws)
    walls["cli"] = time.perf_counter() - t1
    out["launches_continuous"] = total
    out["part_walls_s"] = walls
    out["phase_s"] = time.perf_counter() - t0
    log("continuous " + json.dumps(out, default=str))
    log(f"continuous phase: {out['phase_s']:.1f} s")
    return total


# The replicated phase (`ml_ops route` / `ml_ops replica` on the card).
# Tenants: three names over the 2M flow day's model and three over the
# 2M DNS day's, each its day's first REPL_TENANT_EVENTS raw events,
# interleaved round-robin: 30,000 events through the CLI (60,000 until
# the phase grew by `continuous --replicated`).  The in-process part
# streams each tenant's first REPL_INPROC_EVENTS.
REPL_TENANT_EVENTS = 5_000
REPL_INPROC_EVENTS = 4_096
REPL_REPLICAS = 3
# The CLI's admission window (`route --max-inflight`): the events each
# replica may hold.  Its flushes wait up to fleet_max_wait_ms (50 ms)
# for a batch, so a router that submits faster than REPL_REPLICAS * 32
# events a 50 ms (1,920 events/s) keeps every window full: the
# autoscaler's default band (high 0.75) then reads a load over it.  At
# 64 (3,840 events/s) the router's ~3,100 events/s on rings held the
# windows near the band, and one run made no autoscale decision at all.
REPL_MAX_INFLIGHT = 32
# `continuous --replicated 2`: the 2M flow and DNS days' first event
# hours through two spawned replicas on the card, paced as part 3 of the
# continuous phase.  The kill run replays 2 hours (the binding scores
# once both tenants have published: ~26 s before the end in the first
# chip run); the control over TCP the first hour, whose first refits
# both runs fit before any scoring, beside idle ring pollers or none.
REPL_CONT_REPLICAS = 2
REPL_CONT_HOURS = 2
REPL_CONT_OFF_HOURS = 1
# Its replay pace: the replicas score off this process, and the binding
# scores only once both tenants have published.
REPL_CONT_SPEED = 240.0
# The fleet's bound for card-scored events against the float64 host
# scorer (RTOL_FLEET_DEVICE): float32 gathers and k-order multiply-adds.
RTOL_REPL_DEVICE = RTOL_SCORE


def repl_tenants(tmp):
    """name -> dsource, day_dir, model, raw lines and the host scores of
    those lines under the day's model (the oracle)."""
    from oni_ml_tpu_torch.config import ScoringConfig
    from oni_ml_tpu_torch.runner.serve import _load_featurizer
    from oni_ml_tpu_torch.serving import ModelRegistry
    from oni_ml_tpu_torch.sources import get

    out = {}
    for dsource, day_dir, raw in (
            ("flow", os.path.join(tmp, "data", "20160122"),
             os.path.join(tmp, "flow_day.csv")),
            ("dns", os.path.join(tmp, "dns_data", "20160122"),
             os.path.join(tmp, "dns_day.csv"))):
        model = ModelRegistry().load_day(
            day_dir, get(dsource).fallback(ScoringConfig())).model
        fz = _load_featurizer(day_dir, None)
        lines = first_lines(raw, dsource, REPL_TENANT_EVENTS)
        pairs = get(dsource).event_pairs(
            fz([fz.validate(line) for line in lines]))
        expect = host_scores(model, pairs, np.arange(len(lines)))
        for i in range(REPL_REPLICAS):
            out[f"{dsource}{i}"] = {
                "dsource": dsource, "day_dir": day_dir, "model": model,
                "featurizer": fz, "lines": lines, "pairs": pairs,
                "expect": expect}
    return out


def repl_cli(tmp, tenants, dev="cuda"):
    """`ml_ops route --replicas 3` as a subprocess over the manifest: the
    replicas spawned on `dev` with every flush on the card
    (--device-score-min 1), joined through the TCP KV the route process
    serves (--kv-listen 127.0.0.1:0, the replicas' --kv-connect), their
    links on shared-memory rings, the autoscaler on at its default band
    over admission windows of REPL_MAX_INFLIGHT, the tagged stream on
    stdin, a rolling redeploy of the three replicas halfway.  Exit 0,
    every routed event resolved once, no error, the redeploys, every
    link on rings, an autoscale "up" and no "error" decision, an
    autoscaled replica that scored events, and every replica process
    (the drained ones, their replacements and the autoscaled ones) on
    `dev` by its own stats reply.  The route process runs in its own
    session, killed with its replicas if it outlives its limit."""
    import signal

    names = sorted(tenants)
    manifest = os.path.join(tmp, "repl_fleet.json")
    with open(manifest, "w") as f:
        json.dump({"tenants": [{"tenant": t,
                                "day_dir": tenants[t]["day_dir"],
                                "dsource": tenants[t]["dsource"]}
                               for t in names]}, f)
    events = os.path.join(tmp, "repl_events.tsv")
    n = 0
    with open(events, "w") as f:
        for t, line in interleaved(tenants, names):
            f.write(f"{t}\t{line}")
            n += 1
    cmd = [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", "route",
           "--fleet", manifest, "--replicas", str(REPL_REPLICAS),
           "--kv-listen", "127.0.0.1:0", "--autoscale",
           "--max-inflight", str(REPL_MAX_INFLIGHT), "--device", dev, "--device-score-min", "1",
           "--redeploy-after", str(n // 2)]
    t0 = time.perf_counter()
    with open(events) as stdin:
        proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            stdin=stdin, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"route CLI exited {proc.returncode}: {err[-3000:]}")
    summary = json.loads(err.strip().splitlines()[-1])
    reps = summary["replica_stats"]
    if (summary["routed"] != n or summary["resolved"] != n
            or summary["errors"] or summary["redeploys"] != REPL_REPLICAS
            or len(reps) < 2 * REPL_REPLICAS
            or not all(str(s.get("device", "")).startswith(dev)
                       for s in reps.values())):
        fail(f"route CLI: routed {summary['routed']} resolved "
             f"{summary['resolved']} of {n}, errors {summary['errors']}, "
             f"redeploys {summary['redeploys']}, replicas "
             f"{ {r: s.get('device') for r, s in reps.items()} }")
    links = summary["wire"]
    if set(links) != set(reps) or not all(v["shm"] for v in links.values()):
        fail(f"route CLI: a same-host link is not on rings: {links}")
    decisions = summary["autoscale"]
    scaled = {d["replica"]: reps.get(d["replica"], {}).get("events_scored")
              for d in decisions if d["action"] == "up"}
    if (any(d["action"] == "error" for d in decisions)
            or not scaled or not any(v for v in scaled.values())):
        fail(f"route CLI autoscale: decisions {decisions}, autoscaled "
             f"replicas scored {scaled}; stream {summary['stream_s']} s, "
             f"redeploy {summary['redeploy_s']} s, replicas scored "
             f"{ {r: s.get('events_scored') for r, s in reps.items()} }")
    return {"tenants": len(names), "events": n, "process_wall_s": wall,
            "stream_s": summary["stream_s"],
            "events_per_s": n / summary["stream_s"],
            # The stream's rate outside the redeploy, which the submit
            # loop waits out (drains, joins, model pushes).
            "events_per_s_outside_redeploy": n / (summary["stream_s"]
                                                  - summary["redeploy_s"]),
            "route_ms": {k: summary["hop_ms"][k] for k in ("p50", "p99")},
            "redeploy_s": summary["redeploy_s"],
            "flagged": summary["flagged"],
            "replica_peak_cuda_bytes": {
                r: s.get("cuda_peak_bytes") for r, s in reps.items()},
            "replica_events_scored": {
                r: s["events_scored"] for r, s in reps.items()},
            "replica_batches": {
                r: s["batches_flushed"] for r, s in reps.items()},
            "replica_fleet_counts": {
                r: reps[r].get("fleet_counts") for r in scaled if r in reps},
            "wire": links, "autoscale": decisions}


def repl_check(label, tenants, futs, models, idx):
    """Every future resolved once; each tenant's scores within
    RTOL_REPL_DEVICE of the host scorer's under `models[t]`."""
    worst = 0.0
    for t, fs in futs.items():
        got = np.array([f.result(timeout=120.0)[0] for f in fs])
        want = (tenants[t]["expect"][idx] if models[t] is None else
                host_scores(models[t], tenants[t]["pairs"], idx))
        rel = float(np.max(rel_errors(got, want)))
        if not rel <= RTOL_REPL_DEVICE:
            fail(f"replicated {label} {t}: card vs host max rel {rel:.3e}")
        worst = max(worst, rel)
    return worst


def repl_in_process(tenants, dev="cuda"):
    """A FleetRouter over 3 in-process ReplicaServers on `dev`, every
    flush on the card: half of each tenant's stream, a replica killed
    with those events in flight, the failover awaited, the other half;
    then one tenant refreshed on the card by RefreshLoop (the dense
    kernel's step and the sparse kernel's inference pass; then the fixed
    point's step and inference under ONI_ML_TPU_ESTEP=pallas), each
    result published through the router and scored again.  Checks:
    every future resolved once, none failed; the dead replica's tenants
    promoted to their shadows; primary and shadow on the published
    version; card scores within RTOL_REPL_DEVICE of the host's before
    and after each publish."""
    from oni_ml_tpu_torch.config import OnlineLDAConfig, ServingConfig
    from oni_ml_tpu_torch.serving import (FleetRouter, ModelRegistry,
                                          RefreshLoop, ReplicaServer,
                                          TenantSpec, event_documents)
    from oni_ml_tpu_torch.telemetry.spans import Recorder

    cfg = ServingConfig(device_score_min=1)
    rec = Recorder()
    router = FleetRouter(cfg, recorder=rec)
    replicas = {}
    names = sorted(tenants)
    n = REPL_INPROC_EVENTS
    half = n // 2
    out = {}
    try:
        for i in range(REPL_REPLICAS):
            rid = f"p{i}"
            replicas[rid] = ReplicaServer(rid, cfg, device=dev)
            router.connect_replica(rid, replicas[rid].host,
                                   replicas[rid].port)
        out["wire"] = router.wire()
        for t in names:
            router.add_tenant(
                TenantSpec(tenant=t, dsource=tenants[t]["dsource"]), (),
                tenants[t]["model"], featurizer=tenants[t]["featurizer"])
        router.start()
        before = router.placement()
        victim = before[names[0]].primary
        models = {t: None for t in names}
        t0 = time.perf_counter()
        futs = {t: [] for t in names}
        for lo, hi in ((0, half), (half, n)):
            for i in range(lo, hi, 256):
                for t in names:
                    futs[t] += router.submit_many(
                        t, tenants[t]["lines"][i:min(i + 256, hi)])
            if lo == 0:
                # The failover gap: the kill to the shadow's promotion
                # (the route flips), and to the recovered record (the
                # in-flight hops resent, the shadows refilled).
                t_kill = time.perf_counter()
                replicas[victim].kill()
                deadline = time.monotonic() + 60.0
                gap = None
                while (not router.stats()["failovers"]
                       and time.monotonic() < deadline):
                    if gap is None and router.placement()[
                            names[0]].primary != victim:
                        gap = time.perf_counter() - t_kill
                    time.sleep(0.0005)
                recovered_gap = time.perf_counter() - t_kill
                if gap is None:
                    gap = recovered_gap
        router.flush()
        worst = repl_check("stream", tenants, futs, models, np.arange(n))
        wall = time.perf_counter() - t0
        stats = router.stats()
        after = router.placement()
        fos = stats["failovers"]
        promoted_ok = all(after[t].primary == before[t].shadow
                          for t in names if before[t].primary == victim)
        if (len(fos) != 1 or fos[0]["resend_failures"] or not promoted_ok
                or victim in stats["replicas"]):
            fail(f"replicated kill of {victim}: failovers {fos}, "
                 f"placement {before} -> {after}")
        out.update({"events": n * len(names), "wall_s": wall,
                    "events_per_s": n * len(names) / wall,
                    "killed": victim, "failover_gap_s": gap,
                    "failover_recovered_s": recovered_gap,
                    "failover": fos[0], "max_rel_stream": worst})
        # Refresh one tenant on the card, publish, score again.
        t = names[-1]
        fz = tenants[t]["featurizer"]
        feats = fz([fz.validate(line) for line in tenants[t]["lines"][:n]])
        ips, words = event_documents(feats, tenants[t]["dsource"])
        refreshes = {}
        model = tenants[t]["model"]
        for label, dense_em, env, member, infer in (REFRESH_MEMBERS[0],
                                                    REFRESH_MEMBERS[2]):
            reg = ModelRegistry()
            snap = reg.publish(model, "route")
            if env:
                os.environ["ONI_ML_TPU_ESTEP"] = env
            try:
                before_counts = (launch_counts(), executed_counts())
                t1 = time.perf_counter()
                loop = RefreshLoop(reg, OnlineLDAConfig(
                    num_topics=model.num_topics, dense_em=dense_em),
                    every=1, device=dev)
                new = loop.observe(snap, ips, words)
                refresh_s = time.perf_counter() - t1
                after_counts = (launch_counts(), executed_counts())
            finally:
                os.environ.pop("ONI_ML_TPU_ESTEP", None)
            member_launches(tuple({k: a[k] - b[k] for k in a}
                                  for a, b in zip(after_counts,
                                                  before_counts)),
                            1, member, infer)
            model = new.model
            t1 = time.perf_counter()
            version = router.publish(t, model, source=f"refresh-{label}")
            publish_s = time.perf_counter() - t1
            place = router.placement()[t]
            held = {r: replicas[r]._router_versions.get(t)
                    for r in (place.primary, place.shadow)}
            if any(v != version for v in held.values()):
                fail(f"replicated publish {label}: router version "
                     f"{version}, replicas hold {held}")
            models[t] = model
            f2 = {t: router.submit_many(t, tenants[t]["lines"][:half])}
            router.flush()
            rel = repl_check(f"after publish {label}", tenants, f2, models,
                             np.arange(half))
            refreshes[label] = {"refresh_s": refresh_s,
                                "publish_s": publish_s, "version": version,
                                "replicas": held, "max_rel": rel}
        out["refresh"] = refreshes
        out["route_ms"] = {k: rec.histogram("route.hop_ms").summary()[k]
                           for k in ("p50", "p99")}
        out["replica_stats"] = {r: {"device": s["device"],
                                    "cuda_peak_bytes": s.get(
                                        "cuda_peak_bytes"),
                                    "events_scored": s["events_scored"]}
                                for r, s in router.replica_stats().items()}
    finally:
        router.close()
        for rep in replicas.values():
            rep.stop()
    return out


def shm_segments():
    """This host's Python shared-memory segments (/dev/shm/psm_*).  Other
    processes make and drop their own: only printed."""
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    except FileNotFoundError:
        return set()


def ring_segments(*wires):
    """The ring segments that `FleetRouter.wire()` listings name."""
    return {n for w in wires for link in w.values()
            for n in link.get("segments", ())}


def present_segments(names):
    """Those of the segments `names` that still exist in /dev/shm."""
    return {n for n in names if os.path.exists(os.path.join("/dev/shm", n))}


def repl_continuous(tmp, label, hours, wire_shm, kill, dev="cuda"):
    """`continuous --replicated 2` in this process: the 2M flow and DNS
    days' first `hours` event hours, each from its own start, paced at
    REPL_CONT_SPEED through FleetContinuousService(replicated=2) on
    `dev`, the replicas spawned with `--device` `dev` and every flush on
    the card (device_score_min 1), their links on rings unless not
    `wire_shm`.  With `kill`, the flow tenant's primary is SIGKILLed
    (kill_replica) at the first slice after the binding is ready that
    finds a refit active.  Checks: exactly once per tenant, no failed
    future, no refresh error or refresh_abandon, the refits' kernels
    launched; with `kill` both tenants scored, at least one failover and
    the binding's versions equal to the router's.  Returns the printed
    record and the launches (counted here, around the run)."""
    import dataclasses

    from oni_ml_tpu_torch.config import ServingConfig
    from oni_ml_tpu_torch.runner.continuous import (FleetContinuousService,
                                                    interleave_streams,
                                                    paced_tagged)

    per = {"flow": cont_slices(os.path.join(tmp, "flow_day.csv"), "flow",
                               hours),
           "dns": cont_slices(os.path.join(tmp, "dns_day.csv"), "dns",
                              hours)}
    events = sum(s.events for sl in per.values() for s in sl)
    data = os.path.join(tmp, f"repl_cont_{label}")
    config = dataclasses.replace(cont_config(data), serving=ServingConfig(
        device_score_min=1, wire_shm=wire_shm))
    before = launch_counts()
    fleet = FleetContinuousService(
        config, {t: t for t in per},
        out_dir=os.path.join(data, "continuous_fleet"),
        replicated=REPL_CONT_REPLICAS, device=dev)
    links = fleet.router.wire()
    state = {"ready_t": None, "killed": None, "replica_stats": None}

    def tagged():
        """The paced stream, watching for the binding's start and the
        moment to kill."""
        for t, sl in paced_tagged(interleave_streams(
                {t: [slice_copy(s, sl[0].t0) for s in sl]
                 for t, sl in per.items()}), REPL_CONT_SPEED):
            if state["ready_t"] is None and fleet.binding.ready(t):
                state["ready_t"] = time.perf_counter()
            if (kill and state["killed"] is None
                    and state["ready_t"] is not None
                    and fleet.cosched.refresh_active):
                victim = fleet.router.placement()["flow"].primary
                fleet.kill_replica(victim)
                state["killed"] = {"replica": victim, "slice": sl.index,
                                   "at_s": time.perf_counter() - t0}
            yield t, sl
        state["end_t"] = time.perf_counter()
        state["replica_stats"] = fleet.router.replica_stats()

    t0 = time.perf_counter()
    payload = fleet.run(tagged())
    wall = time.perf_counter() - t0
    after = launch_counts()
    counts = {k: after[k] - before[k] for k in after}
    abandons = cont_journal_abandons(os.path.join(
        data, "continuous_fleet", "run_journal.jsonl"))
    serving = payload["serving"]
    ledgers = {t: cont_check(f"replicated {label} {t}", svc,
                             payload["tenants"][t])
               for t, svc in fleet.services.items()}
    versions = {t: fleet.router._tenants[t]["version"] for t in per}
    failovers = payload["router"]["failovers"]
    members = {r["member"] for p in payload["tenants"].values()
               for r in p["refresh_records"]}
    if (serving["failed_futures"] or payload["refresh_errors"] or abandons
            or (kill and not all(led["scored"] > 0
                                 for led in ledgers.values()))):
        fail(f"continuous --replicated {label}: failed futures "
             f"{serving['failed_futures']}, refresh errors "
             f"{payload['refresh_errors']} {abandons[:3]}, ledgers "
             f"{ledgers}")
    if (kill and (state["killed"] is None or not failovers
                  or serving["versions"] != versions)):
        fail(f"continuous --replicated {label}: kill {state['killed']}, "
             f"failovers {failovers}, binding versions "
             f"{serving['versions']} vs router {versions}")
    if not all(v["shm"] is wire_shm for v in links.values()):
        fail(f"continuous --replicated {label}: links {links}")
    need = {"sparse_scatter", *(k for m in members
                                for k in ENGINE_KERNELS[m])}
    if any(counts[k] <= 0 for k in need):
        fail(f"continuous --replicated {label}: the refits (members "
             f"{members}) launched {counts}")
    reps = state["replica_stats"] or {}
    if not all(str(s.get("device", "")).startswith(dev)
               for s in reps.values()):
        fail(f"continuous --replicated {label}: replicas {reps}")
    walls = {t: [(r["refresh"], r["mode"], r["member"],
                  r["estep_engine_source"], r["train_wall_s"])
                 for r in p["refresh_records"]]
             for t, p in payload["tenants"].items()}
    return {
        "events": events, "wall_s": wall, "events_per_s": events / wall,
        "links": links, "killed": state["killed"],
        "failovers": failovers, "ledgers": ledgers,
        "versions": serving["versions"],
        "first_publish_lead_s": (state["end_t"] - state["ready_t"]
                                 if state["ready_t"] else None),
        "refit_walls": walls,
        "serve_p99_ms": {k: serving.get(k) for k in (
            "serve_idle_p99_ms", "serve_refresh_p99_ms")},
        "coalesced_refreshes": payload["coalesced_refreshes"],
        "replica_stats": {r: {k: s.get(k) for k in (
            "device", "events_scored", "batches_flushed",
            "cuda_peak_bytes")} for r, s in reps.items()},
        "launches": counts,
    }, counts


def first_refit_walls(rings, tcp):
    """Each tenant's first refit wall in both runs (fitted before the
    binding scores, beside two idle ring pollers or none), and the
    rings' sum over TCP's over the tenants whose first refit took its
    engine from the same source in both runs (a crossover measured in
    one run only adds its E-steps to that run's fit)."""
    out = {}
    for t in rings["refit_walls"]:
        a = rings["refit_walls"][t][0]
        b = tcp["refit_walls"][t][0] if tcp["refit_walls"].get(t) else None
        out[t] = {"rings_s": a[4], "tcp_s": b[4] if b else None,
                  "comparable": bool(b) and a[0] == b[0] == 1
                  and a[3] == b[3]}
    pairs = [(v["rings_s"], v["tcp_s"]) for v in out.values()
             if v["comparable"]]
    out["rings_over_tcp"] = (sum(a for a, _ in pairs)
                             / sum(b for _, b in pairs) if pairs else None)
    return out


def replicated_phase(tmp, smi, dev="cuda"):
    """`ml_ops route` / `ml_ops replica` on the card (see the module
    docstring).  Returns the launches on the replicated path per kernel
    (the in-process part's two card refreshes)."""
    t0 = time.perf_counter()
    segments = shm_segments()
    reset_kernel_counts()
    tenants = repl_tenants(tmp)
    out = {"card": smi, "shm_psm_before": len(segments)}
    t1 = time.perf_counter()
    out["cli"] = repl_cli(tmp, tenants, dev)
    out["cli_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["in_process"] = repl_in_process(tenants, dev)
    out["in_process_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    cont = {}
    cont["rings"], _ = repl_continuous(tmp, "rings", REPL_CONT_HOURS, True,
                                       kill=True, dev=dev)
    cont["tcp"], _ = repl_continuous(tmp, "tcp", REPL_CONT_OFF_HOURS, False,
                                     kill=False, dev=dev)
    cont["first_refit_walls"] = first_refit_walls(cont["rings"],
                                                  cont["tcp"])
    out["continuous"] = cont
    out["continuous_s"] = time.perf_counter() - t1
    log("replicated continuous " + json.dumps(cont, default=str))
    total = launch_counts()
    out["launches_replicated"] = total
    for name in ("sparse_estep", "dense_estep", "fixed_point_estep",
                 "sparse_scatter"):
        if total.get(name, 0) <= 0:
            fail(f"replicated path: {name} never launched: {total}")
    # Every ring segment the phase's links negotiated is gone: unlinked
    # by its owner at close, or by a SIGKILLed replica's resource
    # tracker.  Only those are checked; the rest of /dev/shm is printed.
    names = ring_segments(out["cli"]["wire"], out["in_process"]["wire"],
                          cont["rings"]["links"])
    if not names:
        fail("replicated phase: no link named a ring segment")
    deadline = time.monotonic() + 30.0
    while present_segments(names) and time.monotonic() < deadline:
        time.sleep(0.1)
    leaked = sorted(present_segments(names))
    out["ring_segments"] = len(names)
    out["shm_psm_after"] = len(shm_segments())
    log(f"replicated /dev/shm: the phase's links named {len(names)} ring "
        f"segments, {len(leaked)} left {leaked}; psm_* entries "
        f"{len(segments)} before, {out['shm_psm_after']} after")
    if leaked:
        fail(f"replicated phase leaked shared-memory segments: {leaked}")
    out["phase_s"] = time.perf_counter() - t0
    log("replicated " + json.dumps(out, default=str))
    log(f"replicated phase: {out['phase_s']:.1f} s")
    return total


# The multihost phase (`ml_ops --multihost`: distributed EM over rank
# processes, each with its own CUDA context on the one card).  The 2M
# flow day at --em-shards 8 as one rank (local transport), then two
# ranks (kvring over the rendezvous store), each world alone on the card
# (their walls are the ones compared); then, at once: the day as one
# rank with the NCCL transport named (ONI_ML_TPU_ALLREDUCE=psum), the
# small flow day --online on two ranks and on one, the small day on two
# ranks pinned to the dense kernel and to the fixed point, and its first
# MH_CONT_HOURS event hours through `continuous --multihost` on two
# ranks.  (All one after the other took 111.4 s on the card.)
MH_SHARDS = 8
# The distributed day's likelihood against the serial pipeline run's at
# the last EM iteration both ran: the same EM in another summation order
# (each shard batched on its own, the fixed pairwise tree).  The last
# common iteration, not each run's last: one run can stop an iteration
# before the other, which alone moves the final likelihood by up to
# em_tol (1e-4).  The gap between is printed, not bounded: mid-fit, as
# topics rearrange, float32 order differences reach 6e-5 on a 30,000-
# event CPU rehearsal, and both runs converge to the same optimum.
RTOL_MH_LL = 1e-4
MH_SMALL_EM_ITERS = 10
MH_CONT_HOURS = 3
MH_WORLD_TIMEOUT_S = 300
_SERIAL_LDA: dict = {}


def mh_start(tmp, label, nprocs, argv, env=None):
    """One world: `nprocs` rank processes of `python -m
    oni_ml_tpu_torch.runner.ml_ops *argv` ("{rank}" in an argument
    replaced by the rank), with torchrun's variables (one MASTER_PORT;
    RANK and LOCAL_RANK 0..n-1, which all land on cuda:0 of one card);
    each rank's output to files under `tmp`."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(nprocs):
        rank_env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                        RANK=str(r), LOCAL_RANK=str(r), **(env or {}))
        base = os.path.join(tmp, f"mh_{label}_r{r}")
        fo, fe = open(base + ".out", "w"), open(base + ".err", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops",
             *(a.replace("{rank}", str(r)) for a in argv)],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=rank_env,
            stdout=fo, stderr=fe), base, fo, fe))
    return {"label": label, "procs": procs, "t0": time.perf_counter()}


def mh_finish(world):
    """Wait for every rank of a world (all killed past
    MH_WORLD_TIMEOUT_S); fails unless each exited 0.  Returns each rank's
    {"records": stage -> record, "last": its last JSON line} and the
    world's wall."""
    deadline = world["t0"] + MH_WORLD_TIMEOUT_S
    try:
        for proc, _, _, _ in world["procs"]:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, _, fo, fe in world["procs"]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fo.close()
            fe.close()
    wall = time.perf_counter() - world["t0"]
    ranks = []
    for r, (proc, base, _, _) in enumerate(world["procs"]):
        if proc.returncode != 0:
            with open(base + ".err") as f:
                fail(f"multihost {world['label']} rank {r} exited "
                     f"{proc.returncode}: {f.read()[-2500:]}")
        records, last = {}, None
        with open(base + ".out") as f:
            for line in f:
                if not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                last = rec
                if "stage" in rec:
                    records[rec["stage"]] = rec
        ranks.append({"records": records, "last": last})
    return ranks, wall


def mh_rank_summary(rank):
    """One rank's numbers: stage walls, the fit's iterations and wall,
    its kernels' launches, its allreduce ops, bytes and wait."""
    recs = rank["records"]
    lda = recs["lda"]
    ar = lda.get("allreduce") or {}
    iters = max(lda["em_iters"], 1)
    return {
        "walls_s": {k: v["wall_s"] for k, v in recs.items()
                    if "wall_s" in v},
        "em_iters": lda["em_iters"], "em_s": lda["em_s"],
        "final_likelihood": lda["final_likelihood"],
        "engine": lda["engine"], "member": lda["member"],
        "launches": lda["kernel_launches"], "allreduce": ar,
        "allreduce_bytes_per_iter": (ar.get("bytes_out", 0)
                                     + ar.get("bytes_in", 0)) / iters,
        "allreduce_wait_share": (ar.get("wall_s", 0.0) / lda["em_s"]
                                 if lda["em_s"] else None),
    }


def mh_parity(label, ranks):
    """Every rank of a world finished the fit with the same likelihood
    and iteration count (the trainers check their models' bits)."""
    seen = {(r["records"]["lda"]["final_likelihood"],
             r["records"]["lda"]["em_iters"]) for r in ranks}
    if len(seen) != 1:
        fail(f"multihost {label}: the ranks disagree: {seen}")


def mh_small_worlds(tmp, raws, dev):
    """Start the small flow day's worlds, all at once: --online on two
    ranks and on one, two ranks pinned to the dense kernel and to the
    fixed point, and `continuous --multihost` on two ranks (each its own
    data dir) over the day's first MH_CONT_HOURS event hours."""
    small = raws["flow"]
    cont_raw = os.path.join(tmp, "mh_cont_flow.csv")
    with open(cont_raw, "w") as f:
        for sl in cont_slices(small, "flow", MH_CONT_HOURS):
            f.writelines(sl.lines)
    day = ["20160122", "flow", "1.1", "--flow-path", small,
           "--em-max-iters", str(MH_SMALL_EM_ITERS), "--multihost",
           "--em-shards", str(MH_SHARDS)]
    plan = {
        "online_2": (2, [*day, "--online"], None),
        "online_1": (1, [*day, "--online"], None),
        "dense_2": (2, day, {"ONI_ML_TPU_ESTEP": "dense"}),
        "pallas_2": (2, day, {"ONI_ML_TPU_ESTEP": "pallas"}),
        "continuous_2": (2, ["continuous", "flow", "--flow-path", cont_raw,
                             "--no-sleep", "--multihost"], None),
    }
    started = {}
    for label, (nprocs, argv, env) in plan.items():
        data = os.path.join(tmp, f"mh_{label}")
        if label == "continuous_2":
            data += "_r{rank}"
        started[label] = mh_start(tmp, label, nprocs,
                                  [*argv, "--data-dir", data, "--device",
                                   dev], env)
    return started


def multihost_phase(tmp, raws, dev="cuda"):
    """`ml_ops --multihost` on the card (see MH_SHARDS above).  The day's
    three worlds: final.*, likelihood.dat and the results CSVs byte for
    byte the same, each world's transport its own, the likelihood within
    RTOL_MH_LL of the serial pipeline run's.  Online: two ranks against
    one within RTOL_MH_LL per micro-batch.  Continuous: both ranks
    published, the same model digests refresh for refresh.  Every
    kernel launched in the phase's rank processes (each process counts
    its own from 0: the lda records' `kernel_launches`).  Returns the
    launches per kernel."""
    t0 = time.perf_counter()
    serial = _SERIAL_LDA["flow"]
    out, total = {"day": {}}, {}
    day_dirs = {}

    def add(ranks):
        for rank in ranks:
            for name, n in rank["records"]["lda"]["kernel_launches"].items():
                total[name] = total.get(name, 0) + n

    def day_world(label, nprocs, env):
        return mh_start(tmp, f"day_{label}", nprocs, [
            "20160122", "flow", "1e-20", "--flow-path",
            os.path.join(tmp, "flow_day.csv"), "--data-dir",
            os.path.join(tmp, f"mh_day_{label}"), "--multihost",
            "--em-shards", str(MH_SHARDS), "--device", dev], env)

    def check_day_world(label, nprocs, world):
        data = os.path.join(tmp, f"mh_day_{label}")
        ranks, wall = mh_finish(world)
        mh_parity(label, ranks)
        lda = ranks[0]["records"]["lda"]
        ar = lda["allreduce"]
        if (ar["transport"] != label or ar["nprocs"] != nprocs
                or lda["em_shards"]["value"] != MH_SHARDS
                or lda["driver"] != "distributed"):
            fail(f"multihost day {label}: transport {ar}, shards "
                 f"{lda.get('em_shards')}, driver {lda['driver']}")
        if label != "local" and ar["ops"] < lda["em_iters"]:
            fail(f"multihost day {label}: {ar['ops']} allreduce ops for "
                 f"{lda['em_iters']} EM iterations")
        lls = formats.read_likelihood(os.path.join(
            data, "20160122", "likelihood.dat"))[:, 0]
        ref = _SERIAL_LDA["flow_lls"]
        n = min(len(lls), len(ref))
        gaps = np.abs(lls[:n] - ref[:n]) / np.abs(ref[:n])
        rel = float(gaps[-1])
        if rel > RTOL_MH_LL:
            fail(f"multihost day {label}: likelihoods {lls.tolist()} "
                 f"against the serial run's {ref.tolist()} (rel {rel:.3g})")
        add(ranks)
        day_dirs[label] = os.path.join(data, "20160122")
        out["day"][label] = {
            "wall_s": wall, "ll_rel_to_serial": rel,
            "ll_rel_to_serial_max_over_iterations": float(gaps.max()),
            "em_iters_vs_serial": [len(lls), len(ref)],
            "serial": {k: serial[k] for k in ("em_iters", "em_s",
                                              "final_likelihood",
                                              "engine", "member")},
            "ranks": [mh_rank_summary(r) for r in ranks]}

    # One rank, then two, alone on the card: their walls are the ones
    # compared.
    check_day_world("local", 1, day_world("local", 1, None))
    check_day_world("kvring", 2, day_world("kvring", 2, None))
    # The small day's worlds and the NCCL world, at once.
    psum = day_world("psum", 1, {"ONI_ML_TPU_ALLREDUCE": "psum"})
    started = mh_small_worlds(tmp, raws, dev)
    check_day_world("psum", 1, psum)
    names = ("final.beta", "final.gamma", "final.other", "likelihood.dat",
             "doc_results.csv", "word_results.csv", "flow_results.csv")
    same = {w: same_files(day_dirs["local"], day_dirs[w], names)
            for w in ("kvring", "psum")}
    members = {w: v["ranks"][0]["member"] for w, v in out["day"].items()}
    if not all(all(v.values()) for v in same.values()) or \
            len(set(members.values())) != 1:
        fail(f"multihost day: bytes against one rank {same}, members "
             f"{members}")
    out["day_bytes_equal"] = same
    done = {label: mh_finish(w) for label, w in started.items()}
    for label in ("online_2", "online_1", "dense_2", "pallas_2"):
        ranks, wall = done[label]
        mh_parity(label, ranks)
        add(ranks)
        out[label] = {"wall_s": wall,
                      "ranks": [mh_rank_summary(r) for r in ranks]}
    for label, member, kernel in (("dense_2", "dense", "dense_estep"),
                                  ("pallas_2", "per_batch:pallas",
                                   "fixed_point_estep")):
        lda = done[label][0][0]["records"]["lda"]
        if lda["member"] != member or lda["kernel_launches"][kernel] <= 0:
            fail(f"multihost {label}: member {lda['member']}, launches "
                 f"{lda['kernel_launches']}")
    lls = {}
    for label in ("online_2", "online_1"):
        lls[label] = formats.read_likelihood(os.path.join(
            tmp, f"mh_{label}", "20160122", "likelihood.dat"))[:, 0]
    a, b = lls["online_2"], lls["online_1"]
    if a.shape != b.shape or not np.allclose(a, b, rtol=RTOL_MH_LL, atol=0):
        fail(f"multihost online: two ranks' likelihoods {a.tolist()} "
             f"against one rank's {b.tolist()}")
    out["online_max_rel"] = float(np.max(np.abs(a - b) / np.abs(b)))
    ranks, wall = done["continuous_2"]
    digests = [[(r["refresh"], r.get("model_sha256"), r["published"])
                for r in rank["last"]["refresh_records"]] for rank in ranks]
    pubs = [rank["last"]["publishes"] for rank in ranks]
    if (digests[0] != digests[1] or min(pubs) < 1
            or any(d[1] is None for d in digests[0])
            or any(rank["last"].get("refresh_errors") for rank in ranks)):
        fail(f"multihost continuous: digests {digests}, publishes {pubs}")
    out["continuous_2"] = {"wall_s": wall, "publishes": pubs,
                           "refreshes": len(digests[0]),
                           "events": ranks[0]["last"]["events"]}
    if any(total.get(name, 0) <= 0 for name in SOURCES):
        fail(f"multihost path: a kernel never launched: {total}")
    out["launches_multihost"] = total
    out["phase_s"] = time.perf_counter() - t0
    log("multihost " + json.dumps(out, default=str))
    log(f"multihost phase: {out['phase_s']:.1f} s")
    return total


# ---------------------------------------------------------------------------
# The single-process device mesh (`--mesh DATA,MODEL`, parallel/sharded.py)
# ---------------------------------------------------------------------------

# EM iterations of every mesh fit (a 5-iteration trajectory, as the JAX
# package's mesh tests run).
MESH_EM_ITERS = 5
# A mesh fit against the 1x1 run: the JAX package's own bounds for its
# sharded fits against its single device (tests/test_sharded.py:109-122):
# likelihood rel 1e-4 at every iteration, beta (probabilities) atol 1e-4,
# gamma rtol 1e-3 / atol 1e-3, alpha rtol 1e-4.
RTOL_MESH_LL, ATOL_MESH_BETA, TOL_MESH_GAMMA, RTOL_MESH_ALPHA = (
    1e-4, 1e-4, 1e-3, 1e-4)
# One E-step at 1x1 against the unmeshed one: tests/test_sharded.py:
# 265-272's bounds (gamma rtol/atol 1e-6, suff-stats rtol 1e-5 / atol
# 1e-6, likelihood rtol 1e-6).
MESH_ESTEP_TOL = {"gamma": (1e-6, 1e-6), "suff_stats": (1e-5, 1e-6),
                  "likelihood": (1e-6, 0.0)}
# Online at (4, 1) against one slot: tests/test_online_lda.py:148-168.
TOL_MESH_LAM = 2e-4
# The members a mesh runs, each pinned as the dense family's gates allow:
# (label, LDAConfig fields, ONI_ML_TPU_ESTEP, member, its kernels).
MESH_MEMBERS = (
    ("sparse", {"estep_engine": "dense", "dense_em": "off"}, None,
     "per_batch:sparse", ("sparse_estep", "sparse_scatter")),
    ("dense", {"estep_engine": "dense", "dense_em": "on"}, None, "dense",
     ("dense_estep",)),
    ("pallas", {"estep_engine": "dense"}, "pallas", "per_batch:pallas",
     ("fixed_point_estep", "sparse_scatter")),
)
# Set by the earlier phases: the DNS day's corpus (pipeline_dns).
_MESH_INPUTS: dict = {}


def mesh_close(a, b):
    """The largest gaps of a fit against its 1x1 run, and whether each is
    inside its bound."""
    la = np.array([l for l, _ in a.likelihoods])
    lb = np.array([l for l, _ in b.likelihoods])
    if la.shape != lb.shape:
        return {"em_iters": [len(la), len(lb)]}, False
    gaps = {
        "ll_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
        "beta_abs": float(np.max(np.abs(np.exp(a.log_beta)
                                        - np.exp(b.log_beta)))),
        "gamma_excess": float(np.max(np.abs(a.gamma - b.gamma)
                                     - TOL_MESH_GAMMA * np.abs(b.gamma))),
        "alpha_rel": abs(a.alpha - b.alpha) / abs(b.alpha),
    }
    ok = (gaps["ll_rel"] <= RTOL_MESH_LL and gaps["beta_abs"] <= ATOL_MESH_BETA
          and gaps["gamma_excess"] <= TOL_MESH_GAMMA
          and gaps["alpha_rel"] <= RTOL_MESH_ALPHA)
    return gaps, ok


def mesh_every_slot(label, mesh, kernels):
    """Each of `kernels` launched on every slot of `mesh` (its own
    per-slot counts, parallel/sharded.py)."""
    per = {k: list(mesh.launches.get(k, [])) for k in kernels}
    n = mesh.devices.size
    if any(len(v) != n or min(v) <= 0 for v in per.values()):
        fail(f"mesh {label}: a slot launched no {kernels}: {per}")
    return per


def mesh_estep_1x1(label, member, corpus, env):
    """One E-step of the member on the day's first batch, under a 1x1
    mesh and without one, within MESH_ESTEP_TOL; also whether the bytes
    matched."""
    from oni_ml_tpu_torch.models.lda import init_log_beta
    from oni_ml_tpu_torch.ops import estep
    from oni_ml_tpu_torch.parallel import (make_data_parallel_dense_e_step,
                                           make_data_parallel_e_step,
                                           make_mesh)

    b = make_batches(corpus, 1024, 16, pad_multiple=8)[0]
    dev = torch.device("cuda")
    lb = init_log_beta(torch.Generator().manual_seed(0), K, corpus.num_terms,
                       device=dev)
    alpha = torch.tensor(2.5, device=dev)
    w = torch.as_tensor(b.word_idx, device=dev)
    c = torch.as_tensor(b.counts, dtype=torch.float32, device=dev)
    m = torch.as_tensor(b.doc_mask, dtype=torch.float32, device=dev)
    mesh = make_mesh(1, 1, devices=[dev])
    if env:
        os.environ["ONI_ML_TPU_ESTEP"] = env
    try:
        if member == "dense":
            dense = dense_estep.densify(w, c, corpus.num_terms).t().contiguous()
            plain = dense_estep.e_step_dense(lb, alpha, dense, m, 20, 1e-6,
                                             wmajor=True, cells=w.shape[1])
            got = make_data_parallel_dense_e_step(mesh, wmajor=True)(
                lb, alpha, dense, m, None, None, 20, 1e-6, cells=w.shape[1])
        else:
            live = sparse_estep.live_tokens(w, c)
            plain = estep.e_step(lb, alpha, w, c, m, 20, 1e-6, live=live)
            got = make_data_parallel_e_step(mesh)(
                lb, alpha, w, c, m, 20, 1e-6, live=(live,))
        torch.cuda.synchronize()
    finally:
        os.environ.pop("ONI_ML_TPU_ESTEP", None)
    gaps, same = {}, True
    for field, (rtol, atol) in MESH_ESTEP_TOL.items():
        x = getattr(got, field).double().cpu()
        y = getattr(plain, field).double().cpu()
        same = same and torch.equal(getattr(got, field).cpu(),
                                    getattr(plain, field).cpu())
        excess = float(((x - y).abs() - rtol * y.abs() - atol).max())
        gaps[field] = excess
        if excess > 0:
            fail(f"mesh {label}: a 1x1 E-step's {field} differs from the "
                 f"unmeshed one by {excess:.3g} over rtol {rtol} atol {atol}")
    mesh_every_slot(f"{label} 1x1 E-step", mesh,
                    ENGINE_KERNELS[member])
    return {"excess_over_bound": gaps, "bytes_equal": same}


def mesh_fits(corpus, out):
    """(a) and (b): each member's 5-iteration fit on the 2M flow day's
    corpus unmeshed, at 1x1, at (2, 1) and at (4, 1) over one card
    repeated, each through train_corpus(mesh=); the (4, 1) sparse fit
    twice (the same bytes)."""
    from dataclasses import replace

    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import train_corpus
    from oni_ml_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda")
    base = LDAConfig(em_max_iters=MESH_EM_ITERS, em_tol=0.0)
    for label, cfg_kw, env, member, kernels in MESH_MEMBERS:
        cfg = replace(base, **cfg_kw)
        rec = {"member": member, "estep_1x1": mesh_estep_1x1(
            label, member, corpus, env)}
        if env:
            os.environ["ONI_ML_TPU_ESTEP"] = env
        try:
            fits, walls = {}, {}
            shapes = [("none", None), ("1x1", (1, 1)), ("2x1", (2, 1)),
                      ("4x1", (4, 1))]
            if label == "sparse":
                shapes.append(("4x1_again", (4, 1)))
            meshes = {}
            for name, shape in shapes:
                mesh = (make_mesh(*shape, devices=[dev] * (shape[0]
                                                           * shape[1]))
                        if shape else None)
                meshes[name] = mesh
                t0 = time.perf_counter()
                fits[name] = train_corpus(
                    corpus, cfg, device="cuda", mesh=mesh)
                walls[name] = time.perf_counter() - t0
                if fits[name].stats["member"] != member:
                    fail(f"mesh {label} {name}: trained "
                         f"{fits[name].stats['member']}, not {member}")
                if mesh is not None:
                    rec[f"slot_launches_{name}"] = mesh_every_slot(
                        f"{label} {name}", mesh, kernels)
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP", None)
        one = fits["1x1"]
        for name in ("none", "2x1", "4x1"):
            gaps, ok = mesh_close(fits[name], one)
            rec[f"{name}_vs_1x1"] = gaps
            if not ok:
                fail(f"mesh {label}: the {name} fit against the 1x1 fit "
                     f"{gaps}")
        rec["1x1_bytes_equal_unmeshed"] = bool(
            np.array_equal(one.log_beta, fits["none"].log_beta)
            and np.array_equal(one.gamma, fits["none"].gamma))
        rec["batch_shapes"] = {n: fits[n].stats["batch_shapes"][:3]
                               for n in ("none", "1x1")}
        if "4x1_again" in fits:
            a, b = fits["4x1"], fits["4x1_again"]
            same = (np.array_equal(a.log_beta, b.log_beta)
                    and np.array_equal(a.gamma, b.gamma)
                    and a.likelihoods == b.likelihoods and a.alpha == b.alpha)
            rec["4x1_two_runs_bytes_equal"] = same
            if not same:
                fail(f"mesh {label}: two (4, 1) fits differ")
        rec["walls_s"] = walls
        rec["final_likelihood"] = one.likelihoods[-1][0]
        out[label] = rec
        _MESH_INPUTS.setdefault("fits_1x1", {})[label] = (one, cfg, env)


def mesh_vocab(out):
    """(c): the 2M DNS day's corpus (V 31,434) vocab-sharded at (2, 4) over
    one card repeated, the sparse plan and the dense plan (dense_em on),
    each against its 1x1 vocab-sharded run, trimmed back to V."""
    from dataclasses import replace

    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import train_corpus
    from oni_ml_tpu_torch.parallel import make_mesh

    corpus = _MESH_INPUTS["dns_corpus"]
    dev = torch.device("cuda")
    base = LDAConfig(em_max_iters=MESH_EM_ITERS, em_tol=0.0)
    for label, cfg, member in (
            ("vocab_sparse", replace(base, dense_em="off"), "vocab_sparse"),
            ("vocab_dense", replace(base, dense_em="on"), "vocab_dense")):
        fits, walls, meshes = {}, {}, {}
        for name, (d, m) in (("1x1", (1, 1)), ("2x4", (2, 4))):
            meshes[name] = make_mesh(d, m, devices=[dev] * (d * m))
            t0 = time.perf_counter()
            fits[name] = train_corpus(corpus, cfg, device="cuda",
                                      mesh=meshes[name], vocab_sharded=True)
            walls[name] = time.perf_counter() - t0
            res = fits[name]
            if (res.stats["member"] != member
                    or res.log_beta.shape != (K, corpus.num_terms)):
                fail(f"mesh {label} {name}: member {res.stats['member']}, "
                     f"beta {res.log_beta.shape}")
        gaps, ok = mesh_close(fits["2x4"], fits["1x1"])
        if not ok:
            fail(f"mesh {label}: the (2, 4) fit against the 1x1 fit {gaps}")
        rec = {"member": member, "vocab": corpus.num_terms,
               "docs": corpus.num_docs, "2x4_vs_1x1": gaps, "walls_s": walls,
               "final_likelihood": fits["1x1"].likelihoods[-1][0]}
        if member == "vocab_sparse":
            rec["slot_launches_2x4"] = mesh_every_slot(
                f"{label} 2x4", meshes["2x4"], ("sparse_scatter",))
        out[label] = rec


def mesh_scorer(tmp, out):
    """(d): the device scorer's mesh path at (4, 1) on the 2M flow day's
    model, over 2M events drawn from its rows: every score and the
    survivors bit-equal to the scorer with no mesh; theta and p cross the
    link once."""
    from oni_ml_tpu_torch.config import ScoringConfig
    from oni_ml_tpu_torch.parallel import make_mesh
    from oni_ml_tpu_torch.scoring import (DispatchStats, chunked_scores,
                                          filtered_flow_scores)
    from oni_ml_tpu_torch.scoring.score import ScoringModel
    from oni_ml_tpu_torch.sources import get

    day = os.path.join(tmp, "data", "20160122")
    model = ScoringModel.from_files(
        os.path.join(day, "doc_results.csv"),
        os.path.join(day, "word_results.csv"),
        get("flow").fallback(ScoringConfig()))
    rng = np.random.default_rng(17)
    n = PIPELINE_EVENTS
    idx = [rng.integers(0, model.theta.shape[0], n).astype(np.int32),
           rng.integers(0, model.p.shape[0], n).astype(np.int32),
           rng.integers(0, model.theta.shape[0], n).astype(np.int32),
           rng.integers(0, model.p.shape[0], n).astype(np.int32)]
    mesh = make_mesh(4, 1, devices=[torch.device("cuda")] * 4)
    t0 = time.perf_counter()
    plain = chunked_scores(model, idx[0], idx[1], device="cuda")
    t_plain = time.perf_counter() - t0
    stats = DispatchStats()
    t0 = time.perf_counter()
    sharded = chunked_scores(model, idx[0], idx[1], mesh=mesh, stats=stats)
    t_mesh = time.perf_counter() - t0
    key = np.minimum(plain, chunked_scores(model, idx[2], idx[3],
                                           device="cuda"))
    threshold = gap_threshold(key, 0.001)
    f_plain = filtered_flow_scores(model, *idx, threshold, device="cuda")
    f_mesh = filtered_flow_scores(model, *idx, threshold, mesh=mesh,
                                  stats=stats)
    once = 4 * (model.theta.size + model.p.size)
    same = (np.array_equal(plain, sharded)
            and all(np.array_equal(a, b) for a, b in zip(f_plain, f_mesh)))
    if not same or stats.weight_h2d_bytes != once or len(f_mesh[0]) == 0:
        fail(f"mesh scorer: bit-equal {same}, weight bytes "
             f"{stats.weight_h2d_bytes} (once: {once}), survivors "
             f"{len(f_mesh[0])}")
    out["scorer"] = {"events": n, "chunk": stats.chunk,
                     "survivors": int(len(f_mesh[0])), "bit_equal": same,
                     "weight_h2d_bytes": stats.weight_h2d_bytes,
                     "wall_s": {"plain": t_plain, "4x1": t_mesh}}


def mesh_online(tmp, out):
    """(e): online SVI at (4, 1) on the small flow day's corpus against one
    slot: lambda within TOL_MESH_LAM; the per-batch kernels on every
    slot."""
    from oni_ml_tpu_torch.config import OnlineLDAConfig
    from oni_ml_tpu_torch.models.online_lda import OnlineLDATrainer
    from oni_ml_tpu_torch.parallel import make_mesh

    day = os.path.join(tmp, "small_flow_sparse_cuda", "20160122")
    corpus = Corpus.from_model_dat(os.path.join(day, "model.dat"),
                                   os.path.join(day, "words.dat"),
                                   os.path.join(day, "doc.dat"))
    cfg = OnlineLDAConfig(batch_size=256, dense_em="off")
    batches = make_batches(corpus, cfg.batch_size, cfg.min_bucket_len,
                           pad_multiple=8)
    mesh = make_mesh(4, 1, devices=[torch.device("cuda")] * 4)
    one = OnlineLDATrainer(cfg, corpus.num_terms, corpus.num_docs,
                           device="cuda")
    four = OnlineLDATrainer(cfg, corpus.num_terms, corpus.num_docs,
                            mesh=mesh)
    one.step_many(batches)
    four.step_many(batches)
    a, b = four.lam.cpu().numpy(), one.lam.cpu().numpy()
    excess = float(np.max(np.abs(a - b) - TOL_MESH_LAM * np.abs(b)))
    if excess > TOL_MESH_LAM:
        fail(f"mesh online: lambda at (4, 1) off one slot's by {excess:.3g}")
    out["online"] = {"micro_batches": len(batches), "docs": corpus.num_docs,
                     "member": four.member(*batches[0].word_idx.shape),
                     "lam_excess_over_bound": excess,
                     "slot_launches": mesh_every_slot(
                         "online 4x1", mesh,
                         ENGINE_KERNELS[four.member(
                             *batches[0].word_idx.shape)])}


def mesh_cli(tmp, raws, out):
    """(f): `ml_ops ... --mesh 1,1` on the small flow day runs and names its
    mesh; `--mesh 2,2` on a card that cannot fill it exits 2 with the JAX
    runner's message."""
    import contextlib
    import io

    from oni_ml_tpu_torch.runner import ml_ops

    day = run_day("flow", raws["flow"], os.path.join(tmp, "mesh_cli"),
                  "cuda", None, MESH_EM_ITERS, "--mesh", "1,1")
    with open(os.path.join(day, "metrics.json")) as f:
        lda = {r["stage"]: r for r in json.load(f)}["lda"]
    if lda.get("mesh", {}).get("shape") != [1, 1]:
        fail(f"mesh cli: the lda record names no 1x1 mesh: {lda.get('mesh')}")
    n = torch.cuda.device_count()
    spec, (dd, mm) = ("2,2", (2, 2)) if n < 4 else (f"{n + 1},1", (n + 1, 1))
    err = io.StringIO()
    code = None
    with contextlib.redirect_stderr(err):
        try:
            ml_ops.main(["20160122", "flow", "1.1", "--flow-path",
                         raws["flow"], "--data-dir",
                         os.path.join(tmp, "mesh_cli_refused"),
                         "--mesh", spec])
        except SystemExit as e:
            code = e.code
    want = f"mesh {dd}x{mm} needs {dd * mm} devices, have {n}"
    if code != 2 or want not in err.getvalue():
        fail(f"mesh cli: --mesh {spec} on {n} card(s) exited {code}: "
             f"{err.getvalue()[-500:]}")
    out["cli"] = {"mesh_1x1_member": lda["member"],
                  "mesh_1x1_slot_launches": lda["mesh"]["slot_launches"],
                  "refused": {"spec": spec, "exit": code, "message": want}}


def mesh_distinct(out):
    """On a machine with more than one card: the sparse and dense members
    at (2, 1) over two distinct cards against their 1x1 fits (the (b)
    bounds), each slot's kernels on its own card; the scorer at (2, 1)
    over them bit-equal to the unmeshed scorer."""
    from oni_ml_tpu_torch.models.lda import train_corpus
    from oni_ml_tpu_torch.parallel import make_mesh
    from oni_ml_tpu_torch.scoring import chunked_scores
    from oni_ml_tpu_torch.scoring.score import ScoringModel

    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    rec = {"devices": [str(d) for d in devs]}
    for label, _, _, member, kernels in MESH_MEMBERS[:2]:
        one, cfg, env = _MESH_INPUTS["fits_1x1"][label]
        mesh = make_mesh(2, 1, devices=devs)
        t0 = time.perf_counter()
        res = train_corpus(_MESH_INPUTS["flow_corpus"], cfg, device="cuda",
                           mesh=mesh)
        wall = time.perf_counter() - t0
        gaps, ok = mesh_close(res, one)
        if not ok or res.stats["member"] != member:
            fail(f"mesh {label} on two cards: {res.stats['member']}, {gaps}")
        rec[label] = {"vs_1x1": gaps, "wall_s": wall,
                      "slot_launches": mesh_every_slot(
                          f"{label} two cards", mesh, kernels)}
    rng = np.random.default_rng(19)
    model = ScoringModel(ip_index={}, theta=rng.random((3001, K)),
                         word_index={}, p=rng.random((2001, K)))
    ia = rng.integers(0, 3001, 200_000).astype(np.int32)
    ib = rng.integers(0, 2001, 200_000).astype(np.int32)
    same = np.array_equal(
        chunked_scores(model, ia, ib, device="cuda"),
        chunked_scores(model, ia, ib, mesh=make_mesh(2, 1, devices=devs)))
    if not same:
        fail("mesh scorer on two cards: the scores differ")
    rec["scorer_bit_equal"] = same
    out["two_cards"] = rec


def mesh_phase(tmp, raws):
    """The single-process device mesh on the card (`--mesh`,
    parallel/mesh.py and sharded.py), its slots all on cuda:0 where the
    machine has one card (devices=[cuda:0] * N, the counterpart of the
    JAX suite's virtual devices):
    (a) each member at 1x1 against no mesh (an E-step within
        MESH_ESTEP_TOL, the 5-iteration fit within the (b) bounds);
    (b) (2, 1) and (4, 1) against 1x1 (RTOL_MESH_LL etc.), two (4, 1)
        runs the same bytes, each member's kernels on every slot;
    (c) the DNS day vocab-sharded at (2, 4), the sparse and dense plans;
    (d) the scorer at (4, 1) bit-equal; (e) online at (4, 1);
    (f) the CLI, and `--multihost --mesh 1,1` on two ranks against one
        at --em-shards 8 (the same bytes: a rank's local mesh on one card
        holds one slot);
    and where the machine has more than one card, (2, 1) over two
    distinct cards (mesh_distinct).  Returns each kernel's launches in
    the phase."""
    t0 = time.perf_counter()
    out = {}
    day = ["20160122", "flow", "1.1", "--flow-path", raws["flow"],
           "--em-max-iters", str(MH_SMALL_EM_ITERS), "--multihost",
           "--em-shards", str(MH_SHARDS), "--mesh", "1,1", "--device",
           "cuda"]
    worlds = {n: mh_start(tmp, f"mesh_{n}", n, [
        *day, "--data-dir", os.path.join(tmp, f"mh_mesh_{n}")])
        for n in (1, 2)}
    reset_kernel_counts()
    walls = {}
    for part, fn, args in (
            ("fits", mesh_fits, (_MESH_INPUTS["flow_corpus"], out)),
            ("vocab", mesh_vocab, (out,)),
            ("scorer", mesh_scorer, (tmp, out)),
            ("online", mesh_online, (tmp, out)),
            ("cli", mesh_cli, (tmp, raws, out)),
            *((("two_cards", mesh_distinct, (out,)),)
              if torch.cuda.device_count() > 1 else ())):
        t1 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t1
        log(f"mesh {part}: {walls[part]:.1f} s")
    out["walls_s"] = walls
    launches = launch_counts()
    done = {n: mh_finish(w) for n, w in worlds.items()}
    for n, (ranks, wall) in done.items():
        mh_parity(f"mesh_{n}", ranks)
        lda = ranks[0]["records"]["lda"]
        if lda.get("mesh", {}).get("shape") != [1, 1] or \
                lda["driver"] != "distributed":
            fail(f"multihost mesh {n}: {lda.get('mesh')}, {lda['driver']}")
    names = ("final.beta", "final.gamma", "final.other", "likelihood.dat",
             "doc_results.csv", "word_results.csv", "flow_results.csv")
    same = same_files(os.path.join(tmp, "mh_mesh_1", "20160122"),
                      os.path.join(tmp, "mh_mesh_2", "20160122"), names)
    if not all(same.values()):
        fail(f"multihost mesh: two ranks against one {same}")
    out["multihost"] = {"bytes_equal": same,
                        "walls_s": {n: w for n, (_, w) in done.items()}}
    if any(launches[k] <= 0 for k in SOURCES):
        fail(f"mesh path: a kernel never launched: {launches}")
    out["launches_mesh"] = launches
    out["phase_s"] = time.perf_counter() - t0
    log("mesh " + json.dumps(out, default=str))
    return launches


def check_launches(engine, lda, counts, extra=None):
    """Each kernel of the family member `engine` launched once per batch
    per EM iteration enqueued (those after the device stop included) and
    ran (by the kernels' own count on the card) once per batch per EM
    iteration executed; no other kernel launched, but for the `extra`
    launches (name -> count) made outside EM on the path."""
    launched, executed = counts
    enqueued = lda["batches"] * (lda["em_iters"] + lda["skipped_iterations"])
    ran = lda["batches"] * lda["em_iters"]
    extra = extra or {}
    for name, n in launched.items():
        ours = name in ENGINE_KERNELS[engine]
        more = extra.get(name, 0)
        want = (enqueued + more, ran + more) if ours else (more, more)
        got = (n, executed[name])
        if (got != want or lda["kernel_launches"][name] != n
                or lda["executed_launches"][name] != executed[name]):
            fail(f"{engine} path: {name} launched / ran {got} times, "
                 f"expected {want} (record {lda['kernel_launches']}, "
                 f"{lda['executed_launches']})")
        if ours and executed[name] <= 0:
            fail(f"{engine} path: {name} never launched")


def profile_em(corpus):
    """Where the EM time goes: 6 warm EM iterations over the day's
    corpus, three ways (the per-batch pallas path's whole fit only); then
    the scatter's timing record.  The stepwise driver's profile went to
    pay for the mesh phase: fit_drivers times that driver against the
    chunk driver on the same batches.  Each fit's
    set-up (stacking, copies, live-token plans, densifying) is in the
    window but small beside the iterations.  Timed without the profiler, then under torch.profiler
    for device-busy time and the kernels that take it.  The idle share
    is 1 - busy / unprofiled wall."""
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import LDATrainer

    iters = 6
    sparse_batches = list(corpus.bucketed_layout(
        min_len=128, batch_cap=1024,
        pad_multiple=sparse_estep.pad_multiple_for("f32")).batches)
    dense_batches = make_batches(corpus, 1024, 16, pad_multiple=8)
    for label, engine, chunk, batches, env in (
        ("sparse_chunk", "sparse", 128, sparse_batches, None),
        ("dense_chunk", "dense", 128, dense_batches, None),
        ("pallas_chunk", "dense", 128, dense_batches, "pallas"),
    ):
        trainer = LDATrainer(LDAConfig(em_max_iters=iters, em_tol=0.0,
                                       fused_em_chunk=chunk),
                             corpus.num_terms, device="cuda")
        if env:
            os.environ["ONI_ML_TPU_ESTEP"] = env
        try:
            profile_fit(label, trainer, batches, corpus.num_docs, engine,
                        iters)
        finally:
            os.environ.pop("ONI_ML_TPU_ESTEP", None)
        if chunk > 1 and not env:
            profile_chunk_loop(label, batches, corpus.num_docs,
                               corpus.num_terms, engine, iters)
    for engine, batches in (("sparse", sparse_batches),
                            ("dense", dense_batches)):
        stop_tail(engine, batches, corpus.num_docs, corpus.num_terms)
    fit_drivers(sparse_batches, corpus.num_docs, corpus.num_terms)
    return scatter_timing(sparse_batches, corpus.num_terms)


def profile_fit(label, trainer, batches, num_docs, engine, iters):
    from torch.profiler import ProfilerActivity, profile

    trainer.fit(batches, num_docs, engine=engine)            # warm-up
    walls = []
    for _ in range(WALL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.fit(batches, num_docs, engine=engine)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(batches, num_docs, engine=engine)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies): an aten op's row
    # repeats the time of the kernels it launched.
    busy, top_device, top_host = profile_times(prof)
    rec = {
        "case": label, "engine": engine, "member": res.stats["member"],
        "driver": res.stats["driver"],
        "em_iters": res.em_iters, "batches": len(batches),
        "host_syncs": res.stats["host_syncs"], "wall_s": wall,
        "walls_s": walls, "profiled_wall_s": profiled_wall,
        "device_busy_s": busy,
        "device_idle_share": (1.0 - busy / wall) if busy else None,
        "ms_per_em_iteration": wall / iters * 1e3,
        "top_device_us": top_device, "top_host_us": top_host,
    }
    log("profile " + json.dumps(rec))
    if res.em_iters != iters or not busy:
        fail(f"profile {label}: {res.em_iters} EM iterations, device busy {busy}")
    return rec


def profile_times(prof):
    """(device-busy seconds, the top device kernels and the top host ops
    by self time, in microseconds) of a torch.profiler run.  Device-side
    events only count as busy (kernels, copies): an aten op's row
    repeats the time of the kernels it launched.  Read from the
    profiler's raw events: `key_averages()` builds an event tree, which
    took ~7.7 s a run on the H100's host (123 s of profile_em's 171 s); a host op's
    self time is its span less its children's on the same thread, as
    that tree computes it."""
    from torch.autograd import DeviceType

    dev, host, threads = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event():
            continue
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                dev[e.name()] = dev.get(e.name(), 0.0) + e.duration_ns() / 1e3
        elif e.device_type() == DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), e.name()))

    def close(op):
        if op[2] > 0:
            host[op[1]] = host.get(op[1], 0.0) + op[2] / 1e3

    for ops in threads.values():
        ops.sort(key=lambda op: (op[0], -op[1]))
        stack = []  # [end, name, self ns] of the open ops
        for start, end, name in ops:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            if stack:
                stack[-1][2] -= end - start
            stack.append([end, name, end - start])
        while stack:
            close(stack.pop())

    def top(d):
        return {k[:60]: v for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:8]}
    return sum(dev.values()) / 1e6, top(dev), top(host)


def profiled_device_ms(fn, reps):
    """Device time per call of fn (all the kernels it launches), from
    torch.profiler over `reps` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return profile_times(prof)[0] * 1e3 / reps


def profile_chunk_loop(label, batches, num_docs, num_terms, engine, iters):
    """The chunk driver's EM loop alone, set-up excluded: the groups
    built and the runner made beforehand, then the dispatches of the
    same 20 iterations (16 + 4, the default sync) timed (the median of
    WALL_REPS) and profiled."""
    from torch.profiler import ProfilerActivity, profile

    from oni_ml_tpu_torch.models import fused
    from oni_ml_tpu_torch.models.lda import init_log_beta

    groups = fused.stack_batches(batches, "cuda")
    if engine == "dense":
        groups = fused.densify_groups(groups, num_terms, wmajor=True)
    run = fused.make_chunk_runner(
        num_docs=num_docs, num_topics=K, num_terms=num_terms, chunk=128,
        var_max_iters=20, var_tol=1e-6, em_tol=0.0, estimate_alpha=True,
        e_step_fn=sparse_estep.e_step if engine == "sparse" else None,
        dense_wmajor=True, warm_start=True, alpha_max_iters=8)
    lb0 = init_log_beta(torch.Generator().manual_seed(0), K, num_terms,
                        device="cuda")

    def em():
        res = run(lb0, 2.5, float("nan"), groups.arrays, 16)
        res = run(res.log_beta, res.alpha, res.ll_prev, groups.arrays,
                  iters - 16, res.gammas, True)
        int(res.steps_done)
        torch.cuda.synchronize()

    em()
    walls = []
    for _ in range(WALL_REPS):
        t0 = time.perf_counter()
        em()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        em()
    busy, top_device, top_host = profile_times(prof)
    rec = {
        "case": label, "engine": engine, "em_iters": iters,
        "batches": len(batches), "wall_s": wall, "walls_s": walls,
        "device_busy_s": busy,
        "device_idle_share": (1.0 - busy / wall) if busy else None,
        "ms_per_em_iteration": wall / iters * 1e3,
        "device_ms_per_em_iteration": busy / iters * 1e3,
        "top_device_us": top_device, "top_host_us": top_host,
    }
    log("profile_loop " + json.dumps(rec))
    if not busy:
        fail(f"profile_loop {label}: no device time")
    return rec


def median_walls(fns, order):
    """{name: the median of the host walls of fns[name], each call
    timed to its end}, calling in `order` (names in turns)."""
    walls = {name: [] for name in fns}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[name]()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    return {n: float(np.median(w)) for n, w in walls.items()}, walls


def stop_tail(engine, batches, num_docs, num_terms):
    """What the EM iterations enqueued after the device stop cost, at
    the pipeline's settings (LDAConfig defaults, em_tol 1e-4): the chunk
    runner from the trainer's init, in dispatches of host_sync_every
    iterations, until the device stops EM; then that last dispatch again
    from its start state, as the driver enqueues it (n = host_sync_every,
    the iterations after the stop included) and cut at the stop (n = the
    iterations it ran).  Each is timed to its host sync (the median of
    WALL_REPS, in turns) and profiled for device time; the difference is
    the post-stop tail.  The kernels' launches and their own counts of
    the launches that ran are read on one enqueued dispatch."""
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models import fused
    from oni_ml_tpu_torch.models.lda import init_log_beta

    cfg = LDAConfig()
    groups = fused.stack_batches(batches, "cuda")
    if engine == "dense":
        groups = fused.densify_groups(groups, num_terms,
                                      wmajor=cfg.dense_wmajor)
    run = fused.make_chunk_runner(
        num_docs=num_docs, num_topics=cfg.num_topics, num_terms=num_terms,
        chunk=cfg.fused_em_chunk, var_max_iters=cfg.var_max_iters,
        var_tol=cfg.var_tol, em_tol=cfg.em_tol,
        estimate_alpha=cfg.estimate_alpha,
        e_step_fn=sparse_estep.e_step if engine == "sparse" else None,
        dense_wmajor=cfg.dense_wmajor, warm_start=cfg.warm_start_gamma,
        alpha_max_iters=cfg.alpha_max_iters)
    n = min(cfg.fused_em_chunk, cfg.host_sync_every)
    lb0 = init_log_beta(torch.Generator().manual_seed(cfg.seed),
                        cfg.num_topics, num_terms, device="cuda")
    state = (lb0, cfg.alpha_init, float("nan"), None, False)
    start = 0
    while True:
        res = run(*state[:3], groups.arrays, n, *state[3:])
        steps = int(res.steps_done)
        if bool(res.converged) or start + steps >= cfg.em_max_iters:
            break
        start += steps
        state = (res.log_beta, res.alpha, res.ll_prev, res.gammas, True)

    def dispatch(n_steps):
        return lambda: int(run(*state[:3], groups.arrays, n_steps,
                               *state[3:]).steps_done)

    fns = {"enqueued": dispatch(n), "cut": dispatch(steps)}
    order = ["enqueued", "cut", "cut", "enqueued"] * WALL_REPS
    wall, walls = median_walls(fns, order[:2 * WALL_REPS])
    reset_kernel_counts()
    fns["enqueued"]()
    launched, ran = launch_counts(), executed_counts()
    for name in ENGINE_KERNELS[engine]:
        if (launched[name], ran[name]) != (n * len(batches), steps * len(batches)):
            fail(f"stop tail {engine}: {name} launched / ran "
                 f"{(launched[name], ran[name])}, expected "
                 f"{(n * len(batches), steps * len(batches))}")
    device_ms = {k: profiled_device_ms(f, 1) for k, f in fns.items()}
    tail = n - steps
    rec = {
        "case": f"{engine}_stop_tail", "engine": engine, "em_tol": cfg.em_tol,
        "sync": n, "batches": len(batches),
        "dispatch_start_iteration": start, "steps_done": steps,
        "post_stop_iterations": tail,
        "wall_enqueued_s": wall["enqueued"], "wall_cut_s": wall["cut"],
        "walls_s": walls,
        "post_stop_wall_s": wall["enqueued"] - wall["cut"],
        "post_stop_ms_per_iteration": ((wall["enqueued"] - wall["cut"])
                                       / tail * 1e3 if tail else None),
        "executed_ms_per_iteration": wall["cut"] / steps * 1e3,
        "device_ms_enqueued": device_ms["enqueued"],
        "device_ms_cut": device_ms["cut"],
        "post_stop_device_ms": device_ms["enqueued"] - device_ms["cut"],
        "launches": {k: launched[k] for k in ENGINE_KERNELS[engine]},
        "executed_launches": {k: ran[k] for k in ENGINE_KERNELS[engine]},
    }
    log("stop_tail " + json.dumps(rec))
    return rec


def fit_drivers(batches, num_docs, num_terms):
    """The sparse engine's whole fit at the pipeline's settings under
    each driver: the chunk driver (the iterations enqueued after the
    device stop included) against the stepwise one (a host sync per EM
    iteration, nothing enqueued past the stop); one wall each, after a
    warm-up fit each."""
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import LDATrainer

    trainers = {"chunk": LDATrainer(LDAConfig(), num_terms, device="cuda"),
                "stepwise": LDATrainer(LDAConfig(fused_em_chunk=1),
                                       num_terms, device="cuda")}
    results = {name: t.fit(batches, num_docs) for name, t in trainers.items()}
    fns = {name: (lambda t=t: t.fit(batches, num_docs))
           for name, t in trainers.items()}
    # One timed fit each after the warm-up (two each until the mesh
    # phase needed the room).
    wall, walls = median_walls(fns, ["chunk", "stepwise"])
    rec = {
        "case": "sparse_fit_drivers", "walls_s": walls,
        **{f"{name}_{key}": value for name, res in results.items()
           for key, value in (("em_iters", res.em_iters),
                              ("host_syncs", res.stats["host_syncs"]),
                              ("skipped_iterations",
                               res.stats.get("skipped_iterations", 0)),
                              ("wall_s", wall[name]),
                              ("ms_per_em_iteration",
                               wall[name] / res.em_iters * 1e3))},
        "chunk_over_stepwise": wall["chunk"] / wall["stepwise"],
    }
    log("fit_drivers " + json.dumps(rec))
    # The two drivers add the batches' suff-stats in another order (the
    # chunk driver by shape group), so their f32 trajectories part and the
    # stop at em_tol may land an iteration or two apart.
    if abs(results["chunk"].em_iters - results["stepwise"].em_iters) > 2:
        fail(f"fit drivers: chunk {results['chunk'].em_iters} EM iterations, "
             f"stepwise {results['stepwise'].em_iters}")
    return rec


def scatter_timing(batches, v):
    """The sparse [V, K] scatter over the day's batches, on one phi_c
    per batch: the kernel (bit for bit against the CPU's index_add_ and
    the same bits twice), its plain version on the card (index_select +
    index_add_ over the live tokens) and one library call (index_add_
    over every padded slot; padding adds +0.0 to row 0).  Timed in turns,
    per launch (the mean over the day's batches)."""
    from oni_ml_tpu_torch.models.lda import init_log_beta

    dev = torch.device("cuda")
    expb = sparse_estep.exp_beta_table(
        init_log_beta(torch.Generator().manual_seed(0), K, v, device=dev))
    alpha = torch.tensor(2.5, device=dev)
    items = []
    for b in batches:
        w = torch.as_tensor(b.word_idx).to(dev)
        c = torch.as_tensor(b.counts).to(dev)
        m = torch.as_tensor(b.doc_mask).to(dev)
        phic = sparse_estep.fixed_point_blocks(expb, alpha, w, c, m, 20, 1e-6)[1]
        items.append((w.reshape(-1).long(), phic,
                      sparse_estep.live_tokens(w, c)))
    errs = [0.0]
    for _, phic, live in items[:3] + items[-3:]:
        got = sparse_estep.scatter_live(phic, live, v)
        if not torch.equal(got, sparse_estep.scatter_live(phic, live, v)):
            fail("scatter: two launches differ")
        cpu = sparse_estep.scatter_live_reference(
            phic.cpu(), sparse_estep.LiveTokens(*(t.cpu() for t in live)), v)
        if not torch.equal(got.cpu(), cpu):
            fail("scatter: kernel differs from the CPU's index_add_")

    def kernel():
        for _, phic, live in items:
            sparse_estep.scatter_live(phic, live, v)

    def plain():
        for _, phic, live in items:
            sparse_estep.scatter_live_reference(phic, live, v)

    def library():
        for w, phic, _ in items:
            torch.zeros((v, K), device=dev).index_add_(0, w, phic.reshape(-1, K))

    # Per launch, one 49-launch pass is host-bound (the launches take
    # microseconds each on the card), so each variant's time is the
    # device time it took, from torch.profiler, per pass; the CUDA-event
    # time of a pass (host included) is kept beside it.
    device_ms = {f.__name__: 0.0 for f in (library, plain, kernel)}
    for f in (library, plain, kernel, kernel, plain, library):
        device_ms[f.__name__] += profiled_device_ms(f, 5) / 2
    if not all(device_ms.values()):
        fail(f"scatter: the profiler saw no device time: {device_ms}")
    t = [time_ms(f, 10) for f in (library, plain, kernel, kernel, plain, library)]
    n = len(items)
    live_tokens = sum(int(live.pos.numel()) for _, _, live in items)
    words = sum(int(live.seg_word.numel()) for _, _, live in items)
    # sparse_estep.scatter_cost: the live rows of phi_c, their
    # positions, the word runs, the [V, K] output of each launch; one add
    # per live token and topic.
    flops, nbytes = sparse_estep.scatter_cost(live_tokens, words, n, v, K)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {
        "kernel": "sparse_scatter", "batches": n,
        "slots": sum(int(w.numel()) for w, _, _ in items),
        "live_tokens": live_tokens, "distinct_words": words,
        "ms": device_ms["kernel"] / n, "plain_ms": device_ms["plain"] / n,
        "library_ms": device_ms["library"] / n, "bound_ms": bound_ms / n,
        "bound_by": bound_by, "max_abs_err": max(errs),
        "device_ms_per_em_iteration": device_ms,
        "event_ms_per_em_iteration": {"library": (t[0] + t[5]) / 2,
                                      "plain": (t[1] + t[4]) / 2,
                                      "kernel": (t[2] + t[3]) / 2},
    }
    log("scatter " + json.dumps(rec))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    from oni_ml_tpu_torch.plans import device_fingerprint

    fp = device_fingerprint("cuda")
    if roofline.peaks_for(fp) is not PEAK:
        fail(f"card {fp}: the package's peaks are for the H100 SXM; the "
             "bounds and roofline shares would be wrong here")

    # The host: its cores (the pre workers' auto count) and g++, which
    # builds the port's C++ host libraries (native_build.py).
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    host = {"cores": os.cpu_count(), "gxx": gxx}
    log("host " + json.dumps(host))

    # The C++ host libraries build (one g++ each) while nvcc builds the
    # kernels (one nvcc each), all at once.
    t0 = time.perf_counter()
    native_err = []

    def build_native():
        try:
            native_build.build(list(native_build.SOURCES))
        except Exception as e:  # reported below, the run fails
            native_err.append(e)

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    _cuda.build([sparse_estep.KERNEL, sparse_estep.KERNEL_BF16,
                 dense_estep.KERNEL, dense_estep.KERNEL_BF16,
                 dense_estep.KERNEL_BF16_F32CORPUS, pallas_estep.KERNEL])
    native_thread.join()
    if native_err:
        fail(f"native host libraries did not build: {native_err[0]}")
    log(f"build: {time.perf_counter() - t0:.2f} s (in parallel)")
    for lname, info in native_build.BUILD_INFO.items():
        log(f"build native {lname}: {info['seconds']:.2f} s "
            f"({os.path.basename(native_build.lib_path(lname))})")
    for kname, info in _cuda.BUILD_INFO.items():
        log(f"build {kname}: {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {kname}: {line.strip()}")

    # Caps and tolerances.  At the main shapes these random inputs
    # converge slowly, so at var_tol 1e-6 the stop falls where delta is
    # within f32 noise of the stall exit and moves by several iterations
    # with the summation order alone; at var_tol 1e-4 every block stops
    # on its own delta under a cap of 200.  The long docs (block 1)
    # stop at 1-20 under the day's cap of 20 and var_tol 1e-6.
    # B=2 docs of up to 16,384 tokens: a cluster of 8 CTAs per document.
    cases = (("main", 1024, 128, 65, False, 200, 1e-4),
             ("main", 1024, 128, 65, True, 200, 1e-4),
             ("long", 8, 4096, 2049, False, 20, 1e-6),
             ("long", 8, 4096, 2049, True, 20, 1e-6),
             ("cluster", 2, 16384, 8193, False, 20, 1e-6),
             ("cluster", 2, 16384, 8193, True, 20, 1e-6))
    sparse_recs = [
        sparse_parity(f"{lab}{'_warm' if w else ''}", b, l, lo, w, cap, tol)
        for lab, b, l, lo, w, cap, tol in cases
    ]
    if any(r["geometry"]["cluster"] <= 2 for r in sparse_recs[2:]):
        fail("sparse long or cluster case: no cluster of more than 2 CTAs")
    dense_recs = [
        dense_parity(f"dense_{rec_layout(wm)}{'_warm' if w else ''}", 1024,
                     128, 65, wm, w, 200, 1e-4)
        for wm in (True, False) for w in (False, True)
    ]
    # Long documents densified to the full width: a block of one document
    # with thousands of non-zero cells takes the L2-scratch path.
    dense_recs += [
        dense_parity(f"dense_long_{rec_layout(wm)}{'_warm' if w else ''}", 8,
                     4096, 2049, wm, w, 20, 1e-6)
        for wm in (True, False) for w in (False, True)
    ]
    fixed_recs = [
        fixed_point_parity(f"{lab}{'_warm' if w else ''}", b, l, lo, w, cap,
                           tol)
        for lab, b, l, lo, w, cap, tol in cases
    ]
    # The bf16 instantiations, fresh starts: the sparse E-step at the
    # three shapes, the dense E-step at the main shape in both layouts, on
    # long documents and at B=2, L=16,384 (each document's cells up to
    # the full width, in the L2 scratch).
    t_bf16 = time.perf_counter()
    sparse_bf16_recs = [
        sparse_parity(f"{lab}_bf16", b, l, lo, w, cap, tol, "bf16")
        for lab, b, l, lo, w, cap, tol in cases if not w
    ]
    dense_bf16_recs = [
        dense_parity(f"dense_bf16_{rec_layout(wm)}", 1024, 128, 65, wm,
                     False, 200, 1e-4, "bf16")
        for wm in (True, False)
    ] + [
        dense_parity(f"dense_{lab}_bf16_wmajor", b, l, lo, True, False, cap,
                     tol, "bf16")
        for lab, b, l, lo, w, cap, tol in cases[2::2]
    ]
    bf16_parity_s = round(time.perf_counter() - t_bf16, 1)
    if any(r["geometry"]["path"] == "shared memory" for r in dense_recs[4:]):
        fail("dense long documents: no block took the L2-scratch path")
    if fixed_recs[4]["geometry"]["cluster"] <= 2:
        fail("fixed point cluster case: no cluster of more than 2 CTAs")

    # The bf16 parity cases' wall is inside build_and_parity, and apart.
    walls = {"build_and_parity": round(time.perf_counter() - t0, 1),
             "bf16_parity": bf16_parity_s}

    def timed(name, fn, *args):
        """fn(*args), its wall kept under `name` for the walls line (and
        logged at once, so a run that fails later still shows it)."""
        t1 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t1, 1)
        log(f"wall {name}: {walls[name]} s")
        return out

    tmp = tempfile.mkdtemp(prefix="oni_chip_smoke_")
    # This run's own plan cache: the crossover is measured here, not
    # read from an earlier run's cache.
    os.environ["ONI_ML_TPU_PLAN_CACHE"] = os.path.join(tmp, "plans.jsonl")
    py_pre = plans_off = plans_state = None
    try:
        raws = timed("small_days", small_days, tmp)
        plans_off = plans_off_start(tmp, raws["flow"])
        timed("e2e_small", e2e_small, tmp, raws)
        bf16_cli = timed("bf16_small_day", bf16_small_day, tmp, raws)
        corpus, path_counts, flow_pre, flow_engine = timed(
            "pipeline", pipeline, tmp)
        path_counts.update(timed("bf16_paths", bf16_paths, tmp))
        _MESH_INPUTS["flow_corpus"] = corpus
        py_pre = native_pre_start(tmp)
        dns_counts, dns_engine = timed("pipeline_dns", pipeline_dns, tmp)
        host_score = timed("score_device", score_device, tmp, smi)
        timed("native_pre", native_pre, tmp, raws, flow_pre, host_score,
              host, py_pre)
        plans_state = timed("plans", plans_phase, tmp, raws, plans_off)
        timed("resume", resume, tmp, raws["flow"])
        timed("telemetry", telemetry, tmp, raws["flow"])
        timed("dataplane", dataplane, tmp, raws,
              {"flow": flow_engine, "dns": dns_engine})
        plans_counts = timed("plans_rerun", plans_rerun_join, tmp,
                             plans_state)
        online_counts = timed("online", online, tmp, corpus)
        timed("evaluate", evaluate, tmp, raws["flow"])
        serve_counts = timed("serve", serve_phase, tmp)
        fleet_counts = timed("fleet", fleet_phase, tmp, raws)
        continuous_counts = timed("continuous", continuous_phase, tmp, raws)
        replicated_counts = timed("replicated", replicated_phase, tmp, smi)
        multihost_counts = timed("multihost", multihost_phase, tmp, raws)
        mesh_counts = timed("mesh", mesh_phase, tmp, raws)
    finally:
        for started in (py_pre, plans_off,
                        plans_state and plans_state["rerun"]):
            # A phase before the one that joins it failed.
            if started is not None and started["proc"].poll() is None:
                started["proc"].kill()
                started["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    scatter_rec = timed("profile_em", profile_em, corpus)
    walls["total"] = round(time.perf_counter() - t0, 1)
    log("walls_s " + json.dumps(walls))

    entries = []
    for kname, member, rec, errs in (
        ("sparse_estep", "sparse", sparse_recs[0],
         [r["max_abs_err"] for r in sparse_recs]),
        ("sparse_scatter", "sparse", scatter_rec,
         [scatter_rec["max_abs_err"]]),
        ("dense_estep", "dense", dense_recs[0],
         [r["max_abs_err"] for r in dense_recs]),
        ("fixed_point_estep", "per_batch:pallas", fixed_recs[0],
         [r["max_abs_err"] for r in fixed_recs]),
    ):
        launched, ran = path_counts[member]
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launched[kname],
            "executed_launches": ran[kname],
            "dns_launches": dns_counts[0][kname],
            "dns_executed_launches": dns_counts[1][kname],
            # On the online path of the 2M flow day's corpus whose
            # micro-batch steps take this kernel (the dense, sparse and
            # fixed-point runs; the scatter: the sparse run's).
            "online_launches": online_counts[
                {"dense_estep": "dense", "fixed_point_estep":
                 "per_batch:pallas"}.get(kname, "per_batch:sparse")][kname],
            # On the serve path: the two 2M days' default streams (their
            # refreshes: the dense step, the inference pass's sparse
            # kernel and scatter) and, for the fixed point, the refresh
            # under ONI_ML_TPU_ESTEP=pallas.
            "launches_serve": serve_counts[kname],
            # On the fleet's path: the default fleet stream's per-tenant
            # refreshes (the dense step, the inference pass's sparse
            # kernel and scatter) and the per-batch members' (the sparse
            # kernel, and the fixed point under ONI_ML_TPU_ESTEP=pallas).
            "launches_fleet": fleet_counts[kname],
            # On the continuous path: part 1's card runs (the sparse,
            # dense and pallas pinned replays), the 2M flow replay's
            # refreshes (the crossover's engine, the fresh control, the
            # held-out scatter) and the two fleet runs'.
            "launches_continuous": continuous_counts[kname],
            # On the replicated path: the in-process part's two card
            # refreshes of one tenant (the dense step with the sparse
            # inference pass, then the fixed point's step and inference
            # under ONI_ML_TPU_ESTEP=pallas) and the refits of the two
            # `continuous --replicated` runs (the crossover's member and
            # the held-out scatter); the replicas only score.
            "launches_replicated": replicated_counts[kname],
            # On the multihost path: the rank processes' own counts (the
            # 2M day's three worlds on the crossover's engine, the small
            # day's online worlds, and its worlds pinned to the dense
            # kernel and to the fixed point).
            "launches_multihost": multihost_counts[kname],
            # On the mesh path: the phase's fits (each member unmeshed, at
            # 1x1, (2, 1) and (4, 1) on the 2M flow day; the DNS day's
            # (2, 4) sparse plan's local scatter), its online run and the
            # CLI's 1x1 day, in the smoke's process.
            "launches_mesh": mesh_counts[kname],
            # On the plans path: the four probes in the smoke's process
            # (the chunk probe's sparse kernel and scatter, the
            # crossover's sparse and dense E-steps) and the two small
            # days' own (plan-resolved and plans off, sparse pinned).
            "launches_plans": plans_counts[kname],
            "max_abs_err": max(errs), "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
        })
    # The bf16 instantiations, entries of their own: launches on their
    # bf16 paths of the 2M flow day's corpus (every launch of the kernel
    # there is the bf16 instantiation's), and on the small day's CLI run;
    # times at the main shape (W-major for the dense kernel).  Each
    # replaces its Pallas kernel's bf16 mode (the slab stored bf16; the
    # operands cast by _cast_for, the corpus stored by corpus_dtype), from
    # the same source.
    for kname, rec, recs in (("sparse_estep_bf16", sparse_bf16_recs[0],
                              sparse_bf16_recs),
                             ("dense_estep_bf16", dense_bf16_recs[0],
                              dense_bf16_recs)):
        base = kname[:-len("_bf16")]
        launched, ran = path_counts[base.split("_")[0] + "_bf16"]
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], "precision": "bf16",
            "launches": launched[base], "executed_launches": ran[base],
            "cli_launches": bf16_cli.get(base, 0),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "by_case": {r["case"]: {
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "library_ms": r["library_ms"],
                "path": r["geometry"]["path"]} for r in recs},
        })
    # The dense kernel's two layouts (fresh start, the main shape): the
    # dense path runs W-major (dense_wmajor, the JAX default).
    entries[2]["by_layout"] = {
        r["layout"]: {"replaces": DENSE_LAYOUT_REPLACES[r["layout"]],
                      "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
        for r in dense_recs[:4] if not r["warm"]}
    # The redesigned kernels: this run's time per case, and whether each
    # beat its library yardstick (cuBLAS's two f32 products per iteration
    # for dense W-major; two torch.bmm per iteration for the sparse E-step
    # and the fixed point on long documents).
    entries[0].update(
        long_beats_bmm_yardstick=sparse_recs[2]["kernel_beats_library"],
        by_case={r["case"]: {"ms": r["ms"], "library_ms": r["library_ms"],
                             "cluster": r["geometry"]["cluster"],
                             "path": r["geometry"]["path"]}
                 for r in sparse_recs})
    dense_main = dense_recs[0]
    entries[2].update(
        cublas_yardstick_ms=dense_main["cublas_ms"],
        beats_cublas_yardstick=dense_main["ms"] < dense_main["cublas_ms"],
        by_case={r["case"]: {"ms": r["ms"], "path": r["geometry"]["path"]}
                 for r in dense_recs})
    entries[3].update(
        long_beats_bmm_yardstick=fixed_recs[2]["kernel_beats_library"],
        by_case={r["case"]: {"ms": r["ms"], "library_ms": r["library_ms"],
                             "cluster": r["geometry"]["cluster"],
                             "path": r["geometry"]["path"]}
                 for r in fixed_recs})
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
