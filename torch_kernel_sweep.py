"""Time the port's E-step kernels under a few launch geometries on one
NVIDIA GPU, at chip_smoke.py's shapes and inputs.

    python3 torch_kernel_sweep.py [--out sweep.jsonl] [--kernels LIST]
                                  [--package DIR] [--defaults]

- sparse: the sparse E-step (csrc/sparse_estep.cu) at chip_smoke.py's
  three sparse shapes (main B 1024, L 128; long B 8, L 4,096; cluster
  B 2, L 16,384), at each TOKENS_PER_WARP, ms per launch;
- scatter: the [V, K] scatter over the batches of chip_smoke.py's
  2,000,000-event flow day (its bucketed layout, phi_c from the sparse
  E-step at a random beta, as chip_smoke.py's scatter phase makes them;
  the batches' word ids and counts are kept in --day-cache for the next
  process; each batch's scatter right after its E-step, so phi_c is
  fresh in L2, as in EM); device time per launch of the scatter
  wrapper's kernels (the scatter and the output's zero fill) from
  torch.profiler (the launches are host-bound);
- fixed: the fixed-point kernel at each TOKENS_PER_WARP;
- dense: the dense kernel at each number of warps per document (its
  launch_geometry otherwise as it picks it).

TOKENS_PER_WARP is ops/pallas_estep.py's, which sets the warps per
document of both kernels (launch_geometry).  Fresh start; E-step times
per launch by CUDA events (chip_smoke.time_ms).
Each variant runs twice, in turns (a, b, ..., b, a), and both times are
printed.  One JSON line per variant, then the card's name and power
limit.

--defaults runs each kernel at its default geometry only.  --package DIR
imports oni_ml_tpu_torch from DIR, another checkout (for instance the
parent commit unpacked with git archive into build/parent), whose
kernels build under DIR; it implies --defaults, since another tree's
modules may lack this one's knobs.  Two trees are compared in one call
in turns, one process each: this, other, other, this.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

FIXED_CASES = (("main", 1024, 128, 65, 200, 1e-4), ("long", 8, 4096, 2049, 20, 1e-6),
               ("cluster", 2, 16384, 8193, 20, 1e-6))
DENSE_CASES = (("main_wmajor", 1024, 128, 65, True, 200, 1e-4),
               ("main_rowmajor", 1024, 128, 65, False, 200, 1e-4),
               ("long_wmajor", 8, 4096, 2049, True, 20, 1e-6))
TOKENS_PER_WARP = (32, 64, 128, 256)
WARPS_PER_DOC = (1, 2, 4, 8)
KERNELS = ("sparse", "scatter", "fixed", "dense")


def load(package):
    """(chip_smoke, dense_estep, pallas_estep, sparse_estep), the package
    from `package` where given (imported before chip_smoke, whose own
    import then finds it loaded)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if package:
        sys.path.insert(0, os.path.abspath(package))
        import oni_ml_tpu_torch  # noqa: F401

        sys.path.pop(0)
    sys.path.insert(0, here)
    import chip_smoke
    from oni_ml_tpu_torch.ops import dense_estep, pallas_estep, sparse_estep

    return chip_smoke, dense_estep, pallas_estep, sparse_estep


def sparse_runs(smoke, pallas, sparse, defaults):
    runs = []
    for label, b, l, lo, cap, tol in FIXED_CASES:
        case = smoke.random_bucket(b, l, lo, seed=b + l, warm=False)
        args = (sparse.exp_beta_table(case["log_beta"]), case["alpha"],
                case["word"], case["counts"], case["mask"], cap, tol)
        for tpw in (None,) if defaults else TOKENS_PER_WARP:
            def fn(args=args, tpw=tpw):
                if tpw:
                    pallas.TOKENS_PER_WARP = tpw
                return sparse.fixed_point_blocks(*args)

            def geom(b=b, l=l, tpw=tpw):
                if not hasattr(sparse, "launch_geometry"):
                    return None
                if tpw:
                    pallas.TOKENS_PER_WARP = tpw
                return sparse.launch_geometry(b, l, smoke.K)

            rec = {"kernel": "sparse_estep", "case": label}
            if tpw:
                rec["tokens_per_warp"] = tpw
            runs.append((rec, fn, geom))
    return runs


def day_batches(smoke, sparse, cache):
    """(a warm E-step that returns the batch's phi_c, its live-token
    plan) for each batch of the 2,000,000-event flow day that
    chip_smoke.py's pipeline phase writes (same seed and sizes), and V."""
    import tempfile

    import torch

    if cache and os.path.exists(cache):
        arrays = np.load(cache)
        n = (len(arrays.files) - 1) // 2
        pairs = [(arrays[f"w{i}"], arrays[f"c{i}"]) for i in range(n)]
        v = int(arrays["v"])
    else:
        from oni_ml_tpu_torch.features import featurize_flow
        from oni_ml_tpu_torch.features.lineio import iter_flow_lines
        from oni_ml_tpu_torch.io import Corpus
        from oni_ml_tpu_torch.synth import write_flow_day

        with tempfile.TemporaryDirectory() as tmp:
            raw = os.path.join(tmp, "flow_day.csv")
            with open(raw, "w") as f:
                write_flow_day(f, smoke.PIPELINE_EVENTS, n_src=40_000, n_dst=8_000,
                               seed=11)
            features = featurize_flow(iter_flow_lines(raw))
        corpus = Corpus.from_word_counts(features.word_counts())
        layout = corpus.bucketed_layout(min_len=128, batch_cap=1024, pad_multiple=8)
        pairs = [(np.asarray(b.word_idx), np.asarray(b.counts)) for b in layout.batches]
        v = corpus.num_terms
        if cache:
            os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
            with open(cache, "wb") as f:
                np.savez(f, v=np.int64(v), **{f"{x}{i}": a for i, p in enumerate(pairs)
                                              for x, a in zip("wc", p)})
    gen = torch.Generator().manual_seed(0)
    noise = torch.rand((smoke.K, v), generator=gen) + 1.0 / v
    log_beta = torch.log(noise / noise.sum(1, keepdim=True)).cuda()
    expb = sparse.exp_beta_table(log_beta)
    alpha = torch.tensor(2.5, device="cuda")
    warm = torch.tensor(1)
    items = []
    for word, counts in pairs:
        w = torch.as_tensor(word, dtype=torch.int32).cuda()
        c = torch.as_tensor(counts, dtype=torch.float32).cuda()
        m = torch.ones((w.shape[0],), device="cuda")
        gamma = sparse.fixed_point_blocks(expb, alpha, w, c, m, 20, 1e-6)[0]
        # Each batch's E-step (warm, so it launches nothing but the
        # kernel), then its scatter: phi_c is fresh in L2, as in EM.
        estep = (lambda w=w, c=c, m=m, g=gamma: sparse.fixed_point_blocks(
            expb, alpha, w, c, m, 20, 1e-6, gamma_prev=g, warm=warm)[1])
        items.append((estep, sparse.live_tokens(w, c)))
    return items, v


def scatter_device_ms(fn, reps):
    """Device time of the scatter wrapper's kernels over `reps` calls of
    fn, from torch.profiler, after a warm-up call: every kernel fn
    launches but the sparse E-step's (the flow-day case's E-steps, warm,
    launch nothing else)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "sparse_estep_kernel" not in e.key:
            us += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    return us / 1e3 / reps


def scatter_runs(smoke, sparse, day_cache):
    items, v = day_batches(smoke, sparse, day_cache)
    seg = np.concatenate([np.diff(live.seg_ptr.cpu().numpy()) for _, live in items])
    stats = {"batches": len(items), "longest_word_run": int(seg.max()),
             "mean_word_run": float(seg.mean())}

    def fn():
        for estep, live in items:
            out = sparse.scatter_live(estep(), live, v)
        return (out,)

    return [({"kernel": "sparse_scatter", "case": "flow_day", **stats}, fn,
             lambda: None)]


def fixed_runs(smoke, pallas, sparse, defaults):
    runs = []
    for label, b, l, lo, cap, tol in FIXED_CASES:
        case = smoke.random_bucket(b, l, lo, seed=b + l + 3, warm=False)
        slab = pallas.gather_slab(sparse.exp_beta_table(case["log_beta"]), case["word"])
        args = (slab, case["alpha"], case["counts"], case["mask"], cap, tol)
        for tpw in (None,) if defaults else TOKENS_PER_WARP:
            def fn(args=args, tpw=tpw):
                if tpw:
                    pallas.TOKENS_PER_WARP = tpw
                return pallas.fixed_point_blocks(*args)

            def geom(b=b, l=l, tpw=tpw):
                if tpw:
                    pallas.TOKENS_PER_WARP = tpw
                return pallas.launch_geometry(b, l, smoke.K)

            rec = {"kernel": "fixed_point_estep", "case": label}
            if tpw:
                rec["tokens_per_warp"] = tpw
            runs.append((rec, fn, geom))
    return runs


def dense_runs(smoke, dense_estep, defaults):
    base = dense_estep.launch_geometry
    runs = []
    for label, b, l, lo, wmajor, cap, tol in DENSE_CASES:
        case = smoke.random_bucket(b, l, lo, seed=b + 7 + (0 if l == 128 else l),
                                   warm=False)
        dense = dense_estep.densify(case["word"], case["counts"], smoke.V)
        c = dense.t().contiguous() if wmajor else dense
        eb = dense_estep.padded_exp_beta(case["log_beta"], smoke.W)
        args = (eb, case["alpha"], c, case["mask"], cap, tol)
        block = dense_estep.pick_block(b, smoke.W, smoke.K)
        for wpd in (None,) if defaults else WARPS_PER_DOC:
            if wpd and 32 * block * wpd > 256:
                continue

            def forced(b_, w_, k_, block_=None, cells=None, wpd=wpd):
                geom = base(b_, w_, k_, block_, cells)
                if wpd:
                    geom = dict(geom, warps_per_doc=wpd, threads=32 * geom["block"] * wpd)
                return geom

            def fn(args=args, forced=forced, wmajor=wmajor, l=l):
                dense_estep.launch_geometry = forced
                try:
                    return dense_estep.fixed_point_blocks(*args, wmajor=wmajor, cells=l)
                finally:
                    dense_estep.launch_geometry = base

            rec = {"kernel": "dense_estep", "case": label}
            if wpd:
                rec["warps_per_doc"] = wpd
            runs.append((rec, fn, lambda b=b, l=l, forced=forced: forced(
                b, smoke.W, smoke.K, None, l)))
    return runs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="comma-separated subset of " + ",".join(KERNELS))
    parser.add_argument("--package", default=None,
                        help="import oni_ml_tpu_torch from this checkout")
    parser.add_argument("--defaults", action="store_true",
                        help="each kernel at its default geometry only")
    parser.add_argument("--day-cache", default="build/sweep_day.npz",
                        help="where the flow day's batches are kept")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the sweep needs one GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke, dense_estep, pallas_estep, sparse_estep = load(args.package)
    defaults = args.defaults or bool(args.package)
    kernels = set(args.kernels.split(","))
    runs = []
    if "sparse" in kernels:
        runs += sparse_runs(smoke, pallas_estep, sparse_estep, defaults)
    if "scatter" in kernels:
        runs += scatter_runs(smoke, sparse_estep, args.day_cache)
    if "fixed" in kernels:
        runs += fixed_runs(smoke, pallas_estep, sparse_estep, defaults)
    if "dense" in kernels:
        runs += dense_runs(smoke, dense_estep, defaults)
    times = [[] for _ in runs]
    for order in (range(len(runs)), reversed(range(len(runs)))):
        for i in order:
            rec, fn, _ = runs[i]
            if rec["kernel"] == "sparse_scatter":
                times[i].append(scatter_device_ms(fn, 5) / rec["batches"])
            else:
                times[i].append(smoke.time_ms(fn, 10))
    tree = os.path.abspath(args.package) if args.package else os.path.dirname(
        os.path.abspath(__file__))
    out = open(args.out, "w") if args.out else None
    for (rec, fn, geom), t in zip(runs, times):
        iters = fn()[-1]
        line = json.dumps(dict(rec, ms=t, tree=tree, geometry=geom(),
                               iters_mean=(float(iters.float().mean())
                                           if iters.dtype == torch.int32 else None)))
        print("sweep " + line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
