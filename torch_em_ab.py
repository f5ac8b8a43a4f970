"""A/B of the oni_ml_tpu_torch port's sparse EM walls between two
checkouts, on one NVIDIA GPU.

    python3 torch_em_ab.py --other DIR [--events N] [--out FILE]

DIR is another checkout of this repo (for example the parent commit,
unpacked with `git archive` into a directory that .gitignore lists).
The script writes a synthetic flow day (oni_ml_tpu_torch.synth, the
smoke run's 2,000,000-event day by default), builds its corpus once with
this checkout's pre and corpus code, and saves it.  Then each checkout,
in a process of its own, in the order other, this, this, other, loads
that corpus, takes its bucketed layout (min_len 128, batch_cap 1024, as
the sparse engine trains) and times 20 EM iterations (em_tol 0) under
the stepwise driver, and where the checkout has the chunk driver, under
it at its default sync (16) and with a host sync after every EM
iteration (host_sync_every 1): the median of 3 walls after a warm-up
fit, then one fit under torch.profiler for the device-busy time.  Each
process prints one JSON line; the script then prints a summary line
(each checkout's ms per EM iteration from each of its two processes)
and writes every line to FILE.  Both checkouts build their own kernels (`build/` under each).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 20
REPS = 3


def make_corpus(path: str, events: int, tmp: str) -> dict:
    """The synthetic day's corpus, saved to `path` (npz)."""
    sys.path.insert(0, HERE)
    import numpy as np

    from oni_ml_tpu_torch.features import featurize_flow
    from oni_ml_tpu_torch.features.lineio import iter_flow_lines
    from oni_ml_tpu_torch.io import Corpus
    from oni_ml_tpu_torch.synth import write_flow_day

    raw = os.path.join(tmp, "flow_day.csv")
    with open(raw, "w") as f:
        write_flow_day(f, events, n_src=40_000, n_dst=8_000, seed=11)
    corpus = Corpus.from_word_counts(
        featurize_flow(iter_flow_lines(raw)).word_counts())
    np.savez(path, doc_names=np.array(corpus.doc_names),
             vocab=np.array(corpus.vocab), doc_ptr=corpus.doc_ptr,
             word_idx=corpus.word_idx, counts=corpus.counts)
    return {"events": events, "docs": corpus.num_docs,
            "vocab": corpus.num_terms, "tokens": corpus.num_tokens}


def device_busy_s(prof) -> float:
    """Device-side time (kernels, copies) of a torch.profiler run."""
    from torch.autograd import DeviceType

    busy = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA:
            busy += us
    return busy / 1e6


def child(root: str, corpus_path: str) -> dict:
    """Time the EM drivers of the checkout at `root` on the saved corpus."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import oni_ml_tpu_torch
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.io import Corpus
    from oni_ml_tpu_torch.models.lda import LDATrainer
    from oni_ml_tpu_torch.ops import sparse_estep

    pkg = os.path.dirname(os.path.abspath(oni_ml_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise SystemExit(f"imported {pkg}, not the checkout at {root}")
    z = np.load(corpus_path)
    corpus = Corpus(z["doc_names"].tolist(), z["vocab"].tolist(),
                    z["doc_ptr"], z["word_idx"], z["counts"])
    batches = list(corpus.bucketed_layout(
        min_len=128, batch_cap=1024,
        pad_multiple=sparse_estep.pad_multiple_for("f32")).batches)
    has_chunk = "fused_em_chunk" in LDAConfig.__dataclass_fields__
    drivers = {"stepwise": {"fused_em_chunk": 1} if has_chunk else {}}
    if has_chunk:
        drivers["chunk"] = {}
        drivers["chunk_sync1"] = {"host_sync_every": 1}
    out = {"root": os.path.abspath(root), "batches": len(batches),
           "em_iters": ITERS, "torch": torch.__version__}
    for name, kw in drivers.items():
        trainer = LDATrainer(LDAConfig(em_max_iters=ITERS, em_tol=0.0, **kw),
                             corpus.num_terms, device="cuda")
        trainer.fit(batches, corpus.num_docs)          # warm-up, kernel build
        walls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(batches, corpus.num_docs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.fit(batches, corpus.num_docs)
            torch.cuda.synchronize()
        wall = float(np.median(walls))
        busy = device_busy_s(prof)
        out[name] = {"walls_s": walls, "wall_s": wall,
                     "ms_per_em_iteration": wall / ITERS * 1e3,
                     "device_busy_s": busy,
                     "device_ms_per_em_iteration": busy / ITERS * 1e3,
                     "device_idle_share": 1.0 - busy / wall}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", help="the other checkout's root")
    p.add_argument("--events", type=int, default=2_000_000)
    p.add_argument("--out", default=None, help="write the JSON lines here")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--corpus", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.corpus)), flush=True)
        return 0
    if not args.other or not os.path.isdir(os.path.join(args.other,
                                                        "oni_ml_tpu_torch")):
        raise SystemExit("--other must be a checkout with oni_ml_tpu_torch/")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the A/B needs one GPU")
    tmp = tempfile.mkdtemp(prefix="oni_em_ab_")
    lines = []
    try:
        corpus_path = os.path.join(tmp, "corpus.npz")
        t0 = time.perf_counter()
        info = make_corpus(corpus_path, args.events, tmp)
        info["corpus_s"] = time.perf_counter() - t0
        lines.append({"corpus": info})
        print(json.dumps(lines[-1]), flush=True)
        runs = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            root = args.other if label == "other" else HERE
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--corpus", corpus_path],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"{label} run failed ({proc.returncode})")
            rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                       label=label)
            runs[label].append(rec)
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {}
    for label, recs in runs.items():
        for driver in ("stepwise", "chunk", "chunk_sync1"):
            ms = [r[driver]["ms_per_em_iteration"] for r in recs if driver in r]
            if ms:
                summary[f"{label}_{driver}_ms_per_em_iteration"] = ms
                summary[f"{label}_{driver}_device_ms_per_em_iteration"] = [
                    r[driver]["device_ms_per_em_iteration"] for r in recs
                    if driver in r]
    lines.append({"summary": summary})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
