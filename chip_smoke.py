"""Smoke run of the oni_ml_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build     compile the port's CUDA sources from csrc/, one nvcc each,
             in parallel.
2. parity    each kernel against its plain PyTorch version on the card,
             at the flow day's shapes, fresh and warm starts (the dense
             E-step in both layouts, at the main shape and on long
             documents, where a block's cell lists overflow to the
             device-memory scratch; the fixed point at the main shape,
             on long documents and at B=2, L=16,384, where a cluster of
             8 CTAs takes each document), with the tolerances below;
             two launches of the dense and fixed-point kernels must give
             the same bits; each record carries the launch geometry;
             time both (CUDA events) and compute the card's bound for
             the same work.  Each case's cap on fixed-point iterations
             lies above what most blocks need, so the per-block stop
             decision is compared too.
3. e2e       a small synthetic day through the port on the card and on
             the CPU (plain versions), with each ONI_ML_TPU_ESTEP value
             (sparse, dense, pallas, xla, compact): the EM trajectories
             must agree; and twice on the card with each: final.* must
             be the same bytes.
4. pipeline  a 2,000,000-event synthetic flow day through the port's
             entry point on the card, its engine from the measured
             dense-vs-sparse crossover (a fresh plan cache, so the run
             measures; resolved again, the plan serves it: `crossover`
             line); every artifact must exist and parse.  Then the same
             corpus trained with the dense engine and with
             ONI_ML_TPU_ESTEP=pallas (the per-batch dispatch through the
             fixed-point kernel) through train_corpus, each scored.
             Each path's kernels must have launched on it (the counts
             are zeroed just before each and read just after).
5. profile   20 EM iterations over that day's corpus four ways (sparse
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

Then it prints the kernels line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.  Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from oni_ml_tpu_torch.io import Corpus, formats, make_batches  # noqa: E402
from oni_ml_tpu_torch.ops import (  # noqa: E402
    _cuda, dense_estep, pallas_estep, sparse_estep)
from oni_ml_tpu_torch.runner.ml_ops import (  # noqa: E402
    ENGINE_KERNELS, executed_counts, kernel_counts, launch_counts,
    reset_kernel_counts)

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) FLOP/s — the kernels' arithmetic is f32 FMA.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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
# Card against CPU on the small day: the first EM likelihoods, rel 1e-4
# (f32 sums in another order, the approximate reciprocal).
RTOL_E2E = 1e-4
PIPELINE_EVENTS = 2_000_000
# float32 operations of one digamma_pos (estep_common.cuh): 7 guarded
# recurrence steps (compare, divide, two adds) and the series.
DIGAMMA_FLOPS = 40
# Host-clock walls vary between calls (the host's cores are shared):
# each profiled wall is the median of this many runs.
WALL_REPS = 3
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


def check_fixed_point(label, got, ref, block, var_max_iters, var_tol, errs):
    """Iterations per block and gamma (see the tolerances above), each of
    `got` and `ref` a (gamma, iterations per block) pair; returns
    (max |d iters|, blocks that stopped apart, the largest relative gamma
    error on the blocks that stopped together)."""
    gi, ri = got[1].long(), ref[1].long()
    it_diff = int((gi - ri).abs().max())
    if it_diff > MAX_ITER_DIFF:
        fail(f"{label}: iterations differ by {it_diff} in a block")
    if float(gi.float().mean()) >= var_max_iters:
        fail(f"{label}: every block ran to the cap of {var_max_iters} "
             "iterations, so no stop decision was compared")
    if int(gi.max()) <= 1:
        fail(f"{label}: no block iterated past its first step")
    moved = gi != ri
    if int(moved.sum()) > MAX_MOVED_SHARE * len(gi):
        fail(f"{label}: {int(moved.sum())} of {len(gi)} blocks stop apart")
    same = ~moved.repeat_interleave(block)
    close("gamma", got[0][same], ref[0][same], RTOL_GAMMA, 0.0, errs)
    g, r = got[0][same].double(), ref[0][same].double()
    rel_same = float(((g - r).abs() / r.abs()).max())
    if bool(moved.any()):
        g, r = got[0][~same].double(), ref[0][~same].double()
        step = float(((g - r).abs().mean(1) / r.mean(1)).max())
        if step > 2 * var_tol:
            fail(f"{label}: a block that stopped one iteration apart "
                 f"differs by {step:.3e} > 2 var_tol")
    return it_diff, int(moved.sum()), rel_same


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sparse_parity(label, b, l, min_live, warm, var_max_iters, var_tol):
    case = random_bucket(b, l, min_live, seed=b + l + int(warm), warm=warm)
    expb = sparse_estep.exp_beta_table(case["log_beta"])
    block = sparse_estep.pick_block(b)
    kw = dict(block=block, gamma_prev=case["gamma_prev"],
              warm=torch.tensor(1 if warm else 0))
    args = (expb, case["alpha"], case["word"], case["counts"], case["mask"],
            var_max_iters, var_tol)
    got = sparse_estep.fixed_point_blocks(*args, **kw)
    torch.cuda.synchronize()
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
    # Bound: each input read once, each output written once; operations
    # 4*K per live token per iteration (+1 for the tail), with this
    # run's per-block iteration counts.
    iters = got[4].long().cpu().numpy()
    live = (case["counts"] != 0).sum(1).cpu().numpy()
    flops = float(4 * K * (live * (np.repeat(iters, block) + 1)).sum())
    nbytes = (V * K * 4 + b * l * 8 + b * 4 + 4 + (b * K * 4 if warm else 0)
              + b * K * 4 + b * l * K * 4 + b * 8 + (b // block) * 4)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {
        "kernel": "sparse_estep", "case": label, "B": b, "L": l, "K": K,
        "V": V, "block": block, "warm": warm,
        "var_max_iters": var_max_iters, "var_tol": var_tol,
        "iters_min": int(iters.min()), "iters_max": int(iters.max()),
        "iters_mean": float(iters.mean()), "max_abs_err": max(errs),
        "iter_diff": it_diff, "blocks_stopped_apart": moved,
        "gamma_rel_err_same_stop": rel_same, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops,
    }
    log("parity " + json.dumps(rec))
    return rec


def dense_parity(label, b, l, min_live, wmajor, warm, var_max_iters, var_tol):
    """The dense E-step over b docs of min_live..l tokens densified to
    [b, W] (duplicate words summed), in the given layout, with `cells` = l
    as the dense path passes it: at the flow day's batch (l 128, about
    1.6% of the cells non-zero) and on long documents (l 4,096: a block's
    lists overflow to the scratch)."""
    case = random_bucket(b, l, min_live, seed=b + 7 + int(warm)
                         + (0 if l == 128 else l), warm=warm)
    dense = dense_estep.densify(case["word"], case["counts"], V)
    c = dense.t().contiguous() if wmajor else dense
    eb = dense_estep.padded_exp_beta(case["log_beta"], W)
    block = dense_estep.pick_block(b, V, K)
    kw = dict(block=block, wmajor=wmajor, gamma_prev=case["gamma_prev"],
              warm=torch.tensor(1 if warm else 0), cells=l)
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
        gamma_prev=case["gamma_prev"], warm=kw["warm"])
    errs: list = []
    it_diff, moved, rel_same = check_fixed_point(
        label, (got[0], got[4]), (ref[0], ref[4]), block, var_max_iters,
        var_tol, errs)
    tail = dense_estep.dense_fixed_point_reference(
        eb, case["alpha"], dense, case["mask"], 0, var_tol, block,
        gamma_prev=got[0], warm=torch.tensor(1))
    close("T", got[1], tail[1], RTOL_T, RTOL_T, errs)
    close("docll", got[2], tail[2], RTOL_DOCLL, RTOL_DOCLL, errs)
    close("ass", got[3], tail[3], RTOL_DOCLL, RTOL_DOCLL, errs)
    ms = time_ms(lambda: dense_estep.fixed_point_blocks(*args, **kw), 10)
    plain_ms = time_ms(lambda: dense_estep.dense_fixed_point_reference(
        eb, case["alpha"], dense, case["mask"], var_max_iters, var_tol, block,
        gamma_prev=case["gamma_prev"], warm=kw["warm"]), 3)
    # Bound, counted from this run's inputs.  Every output depends only on
    # the non-zero cells of C (a zero cell adds exactly zero to s, T and
    # the token term), so the function needs 4*K flops per non-zero cell
    # per fixed-point iteration of its block (q and the s contraction),
    # plus 4*K per non-zero cell for the tail (q and T); bytes: C read
    # once, beta, gamma (in when warm, out), T, mask, docll, ass and
    # iters.  The kernel does the dense formulation's work, 4*K*W flops
    # per doc and iteration over every cell: printed beside the bound.
    iters = got[4].long().cpu().numpy()
    flops = float(4 * K * ((nnz_block * iters).sum() + nnz_doc.sum()))
    dense_flops = float(4 * K * W * block * iters.sum() + 4 * K * W * b)
    nbytes = (b * W * 4 + 2 * K * W * 4 + b * 4 + (b * K * 4 if warm else 0)
              + b * K * 4 + b * 8 + (b // block) * 4)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {
        "kernel": "dense_estep", "case": label, "B": b, "W": W, "K": K,
        "layout": "wmajor" if wmajor else "rowmajor", "block": block,
        "warm": warm, "var_max_iters": var_max_iters, "var_tol": var_tol,
        "nonzero_cells": float((dense != 0).float().mean()),
        "iters_min": int(iters.min()), "iters_max": int(iters.max()),
        "iters_mean": float(iters.mean()), "max_abs_err": max(errs),
        "iter_diff": it_diff, "blocks_stopped_apart": moved,
        "gamma_rel_err_same_stop": rel_same, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "flops": flops, "dense_cell_flops": dense_flops,
        "dense_cell_flops_ms": dense_flops / PEAK_F32_FLOPS * 1e3,
        "geometry": geom, "bit_identical_relaunch": True,
    }
    log("parity " + json.dumps(rec))
    if wmajor and not warm and l == 128:
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
    # Bound, from this run's inputs: the slab read once, counts, mask,
    # alpha and gamma in (warm) read once, gamma and the iteration counts
    # written once; operations 4*K per live token (the two contractions)
    # and K + 1 digammas per document, for each fixed-point iteration its
    # block ran.
    iters = got[1].long().cpu().numpy()
    doc_iters = np.repeat(iters, block)
    live = (case["counts"] != 0).sum(1).cpu().numpy()
    flops = float((doc_iters * (4 * K * live + (K + 1) * DIGAMMA_FLOPS)).sum())
    nbytes = (K * b * l * 4 + b * l * 4 + b * 4 + 4 + (b * K * 4 if warm else 0)
              + b * K * 4 + (b // block) * 4)
    bound_ms, bound_by = bound(nbytes, flops)
    # Library yardstick: the two batched products of one iteration
    # (torch.bmm over [B, L, K]: phinorm, then the ratio contraction),
    # times the mean iteration count.
    slab_blk = slab.permute(1, 2, 0).contiguous()
    e = torch.rand((b, K, 1), device="cuda")
    ratio = torch.rand((b, 1, l), device="cuda")
    one = time_ms(lambda: (torch.bmm(slab_blk, e), torch.bmm(ratio, slab_blk)),
                  20)
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


def run_day(raw, data, dev, engine, em_iters):
    """The small day through ml_ops.main with ONI_ML_TPU_ESTEP=engine."""
    from oni_ml_tpu_torch.runner import ml_ops

    os.environ["ONI_ML_TPU_ESTEP"] = engine
    try:
        ml_ops.main(["20160122", "flow", "1.1", "--flow-path", raw,
                     "--data-dir", data, "--device", dev,
                     "--em-max-iters", str(em_iters), "--dup-factor", "0"])
    finally:
        del os.environ["ONI_ML_TPU_ESTEP"]
    return os.path.join(data, "20160122")


# ONI_ML_TPU_ESTEP values the small day runs, and the family member each
# must train with under the chunk driver.
E2E_MEMBERS = {"sparse": "sparse", "dense": "dense",
               "pallas": "per_batch:pallas", "xla": "per_batch:xla",
               "compact": "compact"}


def e2e_small(tmp):
    """A 20,000-event day through the port on the card and on the CPU
    (plain versions) from one beta, with each ONI_ML_TPU_ESTEP value: the
    first EM iterations' likelihoods must agree to RTOL_E2E.  And a
    second card run per value: final.* byte for byte (no atomics on the
    path)."""
    from oni_ml_tpu_torch.synth import write_flow_day

    raw = os.path.join(tmp, "small.csv")
    with open(raw, "w") as f:
        write_flow_day(f, 20_000, n_src=400, n_dst=100, seed=5)
    for engine, member in E2E_MEMBERS.items():
        days = {run: run_day(raw, os.path.join(tmp, f"small_{engine}_{run}"),
                             run.split("_")[0], engine, 5)
                for run in ("cuda", "cpu", "cuda_again")}
        lls = {}
        for run, day in days.items():
            lls[run] = formats.read_likelihood(os.path.join(day, "likelihood.dat"))
            with open(os.path.join(day, "metrics.json")) as f:
                lda = {r["stage"]: r for r in json.load(f)}["lda"]
            if lda["member"] != member or lda["driver"] != "fused":
                fail(f"e2e {engine} {run}: trained {lda['member']} under "
                     f"the {lda['driver']} driver")
            with open(os.path.join(day, "flow_results.csv"), "rb") as f:
                rows = f.read().splitlines()
            # TOL 1.1 flags every raw event (all scores are below 1).
            if len(rows) != 19_999 or any(len(r.split(b",")) != 37 for r in rows):
                fail(f"e2e {engine} {run}: flow_results.csv has {len(rows)} "
                     "rows or a row without 37 columns")
        a, b = lls["cuda"][:, 0], lls["cpu"][:, 0]
        if a.shape != b.shape or not np.allclose(a, b, rtol=RTOL_E2E, atol=0):
            fail(f"e2e {engine} likelihoods differ: cuda {a.tolist()} "
                 f"cpu {b.tolist()}")
        same = {}
        for name in ("final.beta", "final.gamma", "final.other",
                     "likelihood.dat"):
            with open(os.path.join(days["cuda"], name), "rb") as f1, \
                    open(os.path.join(days["cuda_again"], name), "rb") as f2:
                same[name] = f1.read() == f2.read()
        if not all(same.values()):
            fail(f"e2e {engine}: two card runs wrote different bytes: {same}")
        log("e2e " + json.dumps({
            "estep_env": engine, "member": member, "em_iters": len(a),
            "cuda_vs_cpu_max_rel": float(np.max(np.abs(a - b) / np.abs(b))),
            "card_runs_byte_identical": same,
        }))


def pipeline(tmp):
    """The 2M-event day through run_pipeline, its engine from the
    measured crossover; then the same corpus through train_corpus on the
    dense family's full-V path and on the per-batch pallas path (and on
    the sparse engine, where the crossover did not pick it), each
    scored.  Returns the corpus and each family member's kernel counts
    (launched, ran) on its path."""
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
    run = ml_ops.run_pipeline(config, "20160122", "flow", device="cuda",
                              emit=lambda *a, **k: None)
    day_counts = (launch_counts(), executed_counts())
    day = os.path.join(data, "20160122")
    recs = {r["stage"]: r for r in run.records}
    missing = [n for n in ml_ops.ARTIFACTS if not os.path.exists(os.path.join(day, n))]
    if missing:
        fail(f"pipeline artifacts missing: {missing}")
    lda, corpus = recs["lda"], recs["corpus"]
    check_day(day, recs, corpus, lda)
    # The crossover's measurement ran E-steps of both engines inside the
    # pipeline (its warm-up and timed runs): their launches are the
    # path's too.
    e_steps = lda["crossover"].get("e_steps", {}) if lda["crossover"] else {}
    check_launches(lda["member"], lda, day_counts, extra={
        kname: e_steps.get(engine, 0) for engine in ("sparse", "dense")
        for kname in ENGINE_KERNELS[engine]})
    crossover(run.corpus, lda)
    walls = {s: recs[s]["wall_s"] for s in ("pre", "corpus", "lda", "score")}
    log("pipeline " + json.dumps({
        "events": PIPELINE_EVENTS, "docs": corpus["docs"],
        "vocab": corpus["vocab"], "tokens": corpus["tokens"],
        "stage_wall_s": walls, "day_wall_s": sum(walls.values()),
        "flagged": recs["score"]["flagged"], "lda": lda,
    }))
    path_counts = {lda["member"]: day_counts}
    paths = [("dense", {"estep_engine": "dense"}, None, "dense"),
             ("pallas", {}, "pallas", "per_batch:pallas")]
    if "sparse" not in path_counts:
        paths.append(("sparse", {"estep_engine": "sparse"}, None, "sparse"))
    for label, cfg_kw, env, member in paths:
        path_counts[member] = train_path(label, run, config, cfg_kw, env,
                                         member, recs, tmp)
    return run.corpus, path_counts


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
    Returns its kernel counts (launched, ran)."""
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
    score = ml_ops.stage_score(run.features, run.corpus, result, config, out)
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
    log(f"pipeline_{label} " + json.dumps({
        "lda": rec, "score_s": score_s, "flagged": score["flagged"],
        "final_likelihood_day": recs["lda"]["final_likelihood"],
        "dense_corpus_bytes": run.corpus.num_docs * W * 4,
    }))
    return counts


def check_day(day, recs, corpus, lda):
    vocab = formats.read_words_dat(os.path.join(day, "words.dat"))
    docs = formats.read_doc_dat(os.path.join(day, "doc.dat"))
    ptr, widx, cnts = formats.read_model_dat(os.path.join(day, "model.dat"))
    beta = formats.read_beta(os.path.join(day, "final.beta"))
    gamma = formats.read_gamma(os.path.join(day, "final.gamma"))
    other = formats.read_other(os.path.join(day, "final.other"))
    ll = formats.read_likelihood(os.path.join(day, "likelihood.dat"))
    names, theta = formats.read_doc_results(os.path.join(day, "doc_results.csv"))
    words, p = formats.read_word_results(os.path.join(day, "word_results.csv"))
    with open(os.path.join(day, "flow_results.csv"), "rb") as f:
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
        "flow_results": all(len(r) == 37 for r in flagged)
        and len(flagged) == recs["score"]["flagged"],
        "driver": lda["member"] in ENGINE_KERNELS and lda["driver"] == "fused",
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"pipeline checks failed: {bad}")


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
    """Where the EM time goes: 20 warm EM iterations over the day's
    corpus, four ways (the per-batch pallas path's whole fit only); then
    the scatter's timing record.  Each fit's
    set-up (stacking, copies, live-token plans, densifying) is in the
    window but small beside the iterations.  Timed without the profiler, then under torch.profiler
    for device-busy time and the kernels that take it.  The idle share
    is 1 - busy / unprofiled wall."""
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import LDATrainer

    iters = 20
    sparse_batches = list(corpus.bucketed_layout(
        min_len=128, batch_cap=1024,
        pad_multiple=sparse_estep.pad_multiple_for("f32")).batches)
    dense_batches = make_batches(corpus, 1024, 16, pad_multiple=8)
    for label, engine, chunk, batches, env in (
        ("sparse_chunk", "sparse", 128, sparse_batches, None),
        ("sparse_stepwise", "sparse", 1, sparse_batches, None),
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
    repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    dev, host = {}, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            dev[e.key] = dev.get(e.key, 0.0) + dev_us
        elif e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total
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
    iteration, nothing enqueued past the stop); the median of WALL_REPS
    walls, in turns, after a warm-up fit each."""
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import LDATrainer

    trainers = {"chunk": LDATrainer(LDAConfig(), num_terms, device="cuda"),
                "stepwise": LDATrainer(LDAConfig(fused_em_chunk=1),
                                       num_terms, device="cuda")}
    results = {name: t.fit(batches, num_docs) for name, t in trainers.items()}
    fns = {name: (lambda t=t: t.fit(batches, num_docs))
           for name, t in trainers.items()}
    order = ["chunk", "stepwise", "stepwise", "chunk"] * WALL_REPS
    wall, walls = median_walls(fns, order[:2 * WALL_REPS])
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
    # Bytes: the live rows of phi_c, their positions, the word runs, the
    # [V, K] output of each launch; one add per live token and topic.
    nbytes = live_tokens * (K * 4 + 4) + words * 8 + n * (v * K * 4 + 4)
    bound_ms, bound_by = bound(nbytes, float(live_tokens * K))
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

    t0 = time.perf_counter()
    _cuda.build([sparse_estep.KERNEL, dense_estep.KERNEL, pallas_estep.KERNEL])
    log(f"build: {time.perf_counter() - t0:.2f} s (in parallel)")
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
    cases = (("main", 1024, 128, 65, False, 200, 1e-4),
             ("main", 1024, 128, 65, True, 200, 1e-4),
             ("long", 8, 4096, 2049, False, 20, 1e-6),
             ("long", 8, 4096, 2049, True, 20, 1e-6))
    sparse_recs = [
        sparse_parity(f"{lab}{'_warm' if w else ''}", b, l, lo, w, cap, tol)
        for lab, b, l, lo, w, cap, tol in cases
    ]
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
    # B=2 docs of up to 16,384 tokens: a cluster of 8 CTAs per document.
    fixed_cases = cases + (("cluster", 2, 16384, 8193, False, 20, 1e-6),
                           ("cluster", 2, 16384, 8193, True, 20, 1e-6))
    fixed_recs = [
        fixed_point_parity(f"{lab}{'_warm' if w else ''}", b, l, lo, w, cap,
                           tol)
        for lab, b, l, lo, w, cap, tol in fixed_cases
    ]
    if any(r["geometry"]["path"] == "shared memory" for r in dense_recs[4:]):
        fail("dense long documents: no block took the L2-scratch path")
    if fixed_recs[4]["geometry"]["cluster"] <= 2:
        fail("fixed point cluster case: no cluster of more than 2 CTAs")

    tmp = tempfile.mkdtemp(prefix="oni_chip_smoke_")
    # This run's own plan cache: the crossover is measured here, not
    # read from an earlier run's cache.
    os.environ["ONI_ML_TPU_PLAN_CACHE"] = os.path.join(tmp, "plans.jsonl")
    try:
        e2e_small(tmp)
        corpus, path_counts = pipeline(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    scatter_rec = profile_em(corpus)

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
            "max_abs_err": max(errs), "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
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
    # for dense W-major; two torch.bmm per iteration for the fixed point
    # on long documents).
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
