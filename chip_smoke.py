"""Smoke run of the oni_ml_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build     compile the flow day's CUDA kernel from csrc/.
2. parity    each kernel against its plain PyTorch version on the card,
             at the flow day's shapes, fresh and warm starts, with the
             tolerances below; time both (CUDA events) and compute the
             card's bound for the same work.  Each case's cap on
             fixed-point iterations lies above what most blocks need, so
             the per-block stop decision is compared too.
3. e2e       a small synthetic day through the port on the card and on
             the CPU (plain versions): the EM trajectories must agree.
4. pipeline  a 2,000,000-event synthetic flow day through the port's
             entry point on the card; every artifact must exist and
             parse, and every kernel must have launched on this path.
             Then a few EM iterations over that day's corpus under
             torch.profiler (device-busy time and its kernels), and
             the [V, K] scatter over every padded slot against the
             live tokens only.

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

from oni_ml_tpu_torch.io import Corpus, formats  # noqa: E402
from oni_ml_tpu_torch.ops import _cuda, sparse_estep  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) FLOP/s — the kernel's arithmetic is f32 FMA.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

K, V = 20, 5_520
# Parity tolerances: gamma and phi_c rel 1e-4 (rcp.approx + one Newton
# step and another f32 summation order than the plain version), docll
# and ass rel 1e-5, and at most one fixed-point iteration of difference
# per block (the same arithmetic differences can move one stop decision).
RTOL_GAMMA = RTOL_PHIC = 1e-4
RTOL_DOCLL = 1e-5
MAX_ITER_DIFF = 1
PIPELINE_EVENTS = 2_000_000
REPLACES = "oni_ml_tpu/ops/sparse_estep.py:204"  # _sparse_kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def make_case(b, l, min_live, seed, warm):
    """A bucket of the packed layout: b docs of min_live..l live tokens
    (words drawn from V, counts 1..4), zero padding after, the last
    3 docs masked; beta from uniform noise, as the JAX init draws it."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(K, V)) + 1.0 / V
    log_beta = np.log(noise / noise.sum(-1, keepdims=True)).astype(np.float32)
    lens = rng.integers(min_live, l + 1, size=b)
    col = np.arange(l)[None, :]
    live = col < lens[:, None]
    word = np.where(live, rng.integers(0, V, size=(b, l)), 0).astype(np.int32)
    counts = np.where(live, rng.integers(1, 5, size=(b, l)), 0).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-3:] = 0.0
    alpha = np.float32(2.5)
    gamma_prev = None
    if warm:
        mean = alpha + counts.sum(1, keepdims=True) / K
        gamma_prev = (mean * rng.uniform(0.5, 1.5, size=(b, K))).astype(np.float32)
    dev = torch.device("cuda")
    t = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    return {
        "expb": sparse_estep.exp_beta_table(t(log_beta)),
        "alpha": t(alpha), "word": t(word), "counts": t(counts),
        "mask": t(mask), "gamma_prev": None if gamma_prev is None else t(gamma_prev),
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


def parity_case(label, b, l, min_live, warm, var_max_iters, var_tol):
    case = make_case(b, l, min_live, seed=b + l + int(warm), warm=warm)
    block = sparse_estep.pick_block(b)
    kw = dict(block=block, gamma_prev=case["gamma_prev"],
              warm=torch.tensor(1 if warm else 0))
    args = (case["expb"], case["alpha"], case["word"], case["counts"],
            case["mask"], var_max_iters, var_tol)
    got = sparse_estep.fixed_point_blocks(*args, **kw)
    torch.cuda.synchronize()
    ref = sparse_estep.fixed_point_full_reference(*args, **kw)
    errs: list = []
    close("gamma", got[0], ref[0], RTOL_GAMMA, 0.0, errs)
    close("phi_c", got[1], ref[1], RTOL_PHIC, RTOL_PHIC, errs)
    close("docll", got[2], ref[2], RTOL_DOCLL, RTOL_DOCLL, errs)
    close("ass", got[3], ref[3], RTOL_DOCLL, RTOL_DOCLL, errs)
    it_diff = int((got[4].long() - ref[4].long()).abs().max())
    if it_diff > MAX_ITER_DIFF:
        fail(f"{label}: iterations differ by {it_diff} in a block")
    if float(got[4].float().mean()) >= var_max_iters:
        fail(f"{label}: every block ran to the cap of {var_max_iters} "
             "iterations, so no stop decision was compared")
    ms = time_ms(lambda: sparse_estep.fixed_point_blocks(*args, **kw), 20)
    plain_ms = time_ms(
        lambda: sparse_estep.fixed_point_full_reference(*args, **kw), 3)
    # Bound: each input read once, each output written once; operations
    # 4*K per live token per iteration (+1 for the tail), with this
    # run's per-block iteration counts.
    iters = got[4].long().cpu().numpy()
    live = (case["counts"] != 0).sum(1).cpu().numpy()
    per_doc_iters = np.repeat(iters, block)
    flops = float(4 * K * (live * (per_doc_iters + 1)).sum())
    nbytes = (V * K * 4 + b * l * 8 + b * 4 + 4 + (b * K * 4 if warm else 0)
              + b * K * 4 + b * l * K * 4 + b * 8 + (b // block) * 4)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    rec = {
        "case": label, "B": b, "L": l, "K": K, "V": V, "block": block,
        "warm": warm, "var_max_iters": var_max_iters, "var_tol": var_tol,
        "iters_min": int(iters.min()), "iters_max": int(iters.max()),
        "iters_mean": float(iters.mean()), "max_abs_err": max(errs),
        "iter_diff": it_diff, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    log("parity " + json.dumps(rec))
    return rec


def e2e_small(tmp):
    """A 20,000-event day through the port on the card and on the CPU
    (plain versions) from one beta: the first EM iterations' likelihoods
    must agree to rel 1e-4 (f32 sums in another order, atomics in the
    [V, K] scatter)."""
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.synth import write_flow_day

    raw = os.path.join(tmp, "small.csv")
    with open(raw, "w") as f:
        write_flow_day(f, 20_000, n_src=400, n_dst=100, seed=5)
    out = {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(tmp, f"small_{dev}")
        ml_ops.main(["20160122", "flow", "1.1", "--flow-path", raw,
                     "--data-dir", d, "--device", dev, "--em-max-iters", "5",
                     "--dup-factor", "0"])
        day = os.path.join(d, "20160122")
        out[dev] = formats.read_likelihood(os.path.join(day, "likelihood.dat"))
        with open(os.path.join(day, "flow_results.csv"), "rb") as f:
            rows = f.read().splitlines()
        # TOL 1.1 flags every raw event (all scores are below 1).
        if len(rows) != 19_999 or any(len(r.split(b",")) != 37 for r in rows):
            fail(f"e2e {dev}: flow_results.csv has {len(rows)} rows or a "
                 "row without 37 columns")
    a, b = out["cuda"][:, 0], out["cpu"][:, 0]
    if a.shape != b.shape or not np.allclose(a, b, rtol=1e-4, atol=0):
        fail(f"e2e likelihoods differ: cuda {a.tolist()} cpu {b.tolist()}")
    log(f"e2e small day: {len(a)} EM iterations, cuda vs cpu likelihood "
        f"max rel diff {float(np.max(np.abs(a - b) / np.abs(b))):.3e}")


def pipeline(tmp):
    from oni_ml_tpu_torch.runner import ml_ops
    from oni_ml_tpu_torch.synth import write_flow_day

    raw = os.path.join(tmp, "flow_day.csv")
    t0 = time.perf_counter()
    with open(raw, "w") as f:
        write_flow_day(f, PIPELINE_EVENTS, n_src=40_000, n_dst=8_000, seed=11)
    log(f"pipeline: wrote {PIPELINE_EVENTS} events in "
        f"{time.perf_counter() - t0:.1f} s")
    data = os.path.join(tmp, "data")
    sparse_estep.reset_launch_count()
    ml_ops.main(["20160122", "flow", "1e-20", "--flow-path", raw,
                 "--data-dir", data, "--device", "cuda"])
    launches = sparse_estep.launch_count
    day = os.path.join(data, "20160122")
    with open(os.path.join(day, "metrics.json")) as f:
        recs = {r["stage"]: r for r in json.load(f)}
    missing = [n for n in ml_ops.ARTIFACTS if not os.path.exists(os.path.join(day, n))]
    if missing:
        fail(f"pipeline artifacts missing: {missing}")
    lda, corpus = recs["lda"], recs["corpus"]
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
        "launches": launches == lda["batches"] * lda["em_iters"] > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"pipeline checks failed: {bad} (launches {launches}, "
             f"batches {lda['batches']}, em_iters {lda['em_iters']})")
    walls = {s: recs[s]["wall_s"] for s in ("pre", "corpus", "lda", "score")}
    log("pipeline " + json.dumps({
        "events": PIPELINE_EVENTS, "docs": corpus["docs"],
        "vocab": corpus["vocab"], "tokens": corpus["tokens"],
        "batches": lda["batches"], "batch_shapes": lda["batch_shapes"],
        "em_iters": lda["em_iters"], "em_s": lda["em_s"],
        "em_docs_per_s": lda["em_docs_per_s"], "stage_wall_s": walls,
        "day_wall_s": sum(walls.values()), "flagged": recs["score"]["flagged"],
        "launches": launches,
    }))
    profile_em(Corpus(docs, vocab, ptr, widx, cnts))
    return launches


def profile_em(corpus):
    """Where the EM time goes: 20 warm EM iterations over the day's
    corpus (the trainer's set-up, copies and live-token lists, is in
    the window but small beside them), timed without the profiler, then
    again under torch.profiler for device-busy time and the kernels
    that take it.  The idle share is 1 - busy / unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import LDATrainer

    iters = 20
    layout = corpus.bucketed_layout(
        min_len=128, batch_cap=1024,
        pad_multiple=sparse_estep.pad_multiple_for("f32"))
    trainer = LDATrainer(LDAConfig(em_max_iters=iters, em_tol=0.0),
                         corpus.num_terms, device="cuda")
    batches = list(layout.batches)
    trainer.fit(batches, corpus.num_docs)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(batches, corpus.num_docs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(batches, corpus.num_docs)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies): an aten op's row
    # repeats the time of the kernels it launched.
    by_name = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + dev_us
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("profile " + json.dumps({
        "em_iters": iters, "batches": len(batches), "wall_s": wall,
        "profiled_wall_s": profiled_wall, "device_busy_s": busy,
        "device_idle_share": (1.0 - busy / wall) if busy else None,
        "top_device_us": {k[:60]: v for k, v in top},
    }))
    scatter_ab(batches, corpus.num_terms)


def scatter_ab(batches, v):
    """The [V, K] scatter of one EM iteration two ways on the same
    phi_c: index_add_ over every padded slot of each batch (padding
    carries word 0, so its atomics all land on row 0) against the live
    tokens only, as sparse_estep.e_step does.  Timed in turns
    (all, live, live, all); the two sums must agree to rel 1e-4
    (atomics add in another order)."""
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
        items.append((w.reshape(-1).long(), phic.reshape(-1, K),
                      sparse_estep.live_tokens(w, c)))

    def every_slot():
        suff = torch.zeros((v, K), device=dev)
        for w, ph, _ in items:
            suff.index_add_(0, w, ph)
        return suff

    def live_only():
        suff = torch.zeros((v, K), device=dev)
        for _, ph, (pos, words) in items:
            suff.index_add_(0, words, ph.index_select(0, pos))
        return suff

    a, b = every_slot(), live_only()
    errs: list = []
    close("scatter", b, a, 1e-4, 1e-6, errs)
    t = [time_ms(f, 10) for f in (every_slot, live_only, live_only, every_slot)]
    log("scatter " + json.dumps({
        "batches": len(items),
        "slots": sum(int(w.numel()) for w, _, _ in items),
        "live_tokens": sum(int(p.numel()) for _, _, (p, _) in items),
        "every_slot_ms": (t[0] + t[3]) / 2, "live_only_ms": (t[1] + t[2]) / 2,
        "max_abs_err": errs[0],
    }))


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
    _cuda.load(sparse_estep.KERNEL)
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for kname, info in _cuda.BUILD_INFO.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {kname}: {line.strip()}")

    # Caps and tolerances.  At the main shape these random inputs
    # converge slowly (about 13% per iteration), so at var_tol 1e-6 the
    # stop falls where delta is within f32 noise of the stall exit and
    # moves by up to 7 iterations with the summation order alone (the
    # plain version against itself with each doc's tokens permuted).  At
    # var_tol 1e-4 every block of 4 docs stops on its own delta after
    # 39-68 iterations, under a cap of 200, and the same permutation
    # moves no stop by more than one.  The long docs (block 1) stop at
    # 1-20 under the day's cap of 20 and var_tol 1e-6.
    cases = [
        ("main", 1024, 128, 65, False, 200, 1e-4),
        ("main", 1024, 128, 65, True, 200, 1e-4),
        ("long", 8, 4096, 2049, False, 20, 1e-6),
        ("long", 8, 4096, 2049, True, 20, 1e-6),
    ]
    recs = [parity_case(f"{lab}{'_warm' if w else ''}", b, l, lo, w, cap, tol)
            for lab, b, l, lo, w, cap, tol in cases]

    tmp = tempfile.mkdtemp(prefix="oni_chip_smoke_")
    try:
        e2e_small(tmp)
        launches = pipeline(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_rec = recs[0]
    print(json.dumps({"kernels": [{
        "name": sparse_estep.KERNEL, "route": "cuda",
        "source": "oni_ml_tpu_torch/csrc/sparse_estep.cu",
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
