"""The flow day on the card (port of oni_ml_tpu/runner/ml_ops.py, flow
only) — replaces ml_ops.sh YYYYMMDD flow TOL:

    python -m oni_ml_tpu_torch.runner.ml_ops 20160122 flow 1e-20 \\
        --flow-path raw.csv --data-dir /data [--device cuda|cpu]

Stages, each writing the JAX runner's artifacts into <data-dir>/<fdate>:

    pre     raw netflow (+ flow_scores.csv feedback) -> word_counts.dat
    corpus  word counts -> words.dat / doc.dat / model.dat
    lda     EM on the device -> final.beta/.gamma/.other, likelihood.dat,
            doc_results.csv, word_results.csv
    score   float64 host scoring -> flow_results.csv

Pre, corpus and score are host work; LDA is the one stage on the
device, its E-step the hand-written CUDA kernel (ops/sparse_estep.py).
Each stage prints one JSON record with its wall time; all records land
in metrics.json.  The whole day runs in one process: the featurized
day and the corpus pass between stages in memory.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import FeedbackConfig, LDAConfig, PipelineConfig, ScoringConfig
from ..device import resolve_device
from ..features import featurize_flow, read_flow_feedback_rows
from ..features.lineio import iter_flow_lines
from ..io import Corpus, formats
from ..models import train_corpus
from ..ops import sparse_estep
from ..scoring import ScoringModel, score_flow_csv

ARTIFACTS = [
    "word_counts.dat", "words.dat", "doc.dat", "model.dat",
    "final.beta", "final.gamma", "final.other", "likelihood.dat",
    "doc_results.csv", "word_results.csv", "flow_results.csv",
]


def run_pipeline(
    config: PipelineConfig,
    fdate: str,
    dsource: str = "flow",
    device=None,
    initial_log_beta: "np.ndarray | None" = None,
    emit=print,
) -> list:
    """Run the flow day; returns the per-stage records (also written to
    metrics.json in the day directory)."""
    if dsource != "flow":
        raise ValueError(f"the port runs the flow day only, got {dsource!r}")
    dev = resolve_device(device)
    day_dir = formats.ensure_dir(config.day_dir(fdate))
    records: list = []

    def path(name):
        return os.path.join(day_dir, name)

    def record(stage, t0, **info):
        rec = {"fdate": fdate, "dsource": dsource, "stage": stage,
               "wall_s": time.perf_counter() - t0, **info}
        records.append(rec)
        emit(json.dumps(rec), flush=True)

    t0 = time.perf_counter()
    fb = config.feedback
    fb_rows = read_flow_feedback_rows(
        os.path.join(config.data_dir, "flow_scores.csv"),
        fb.dup_factor, fb.nonthreatening_severity,
    )
    features = featurize_flow(iter_flow_lines(config.flow_path),
                              feedback_rows=fb_rows)
    triples = features.word_counts()
    formats.write_word_counts(path("word_counts.dat.tmp"), triples)
    os.replace(path("word_counts.dat.tmp"), path("word_counts.dat"))
    record("pre", t0, events=features.num_events,
           word_count_rows=len(triples), feedback_rows=len(fb_rows))

    t0 = time.perf_counter()
    corpus = Corpus.from_word_counts(triples)
    del triples
    corpus.save(day_dir)
    record("corpus", t0, docs=corpus.num_docs, vocab=corpus.num_terms,
           tokens=corpus.num_tokens)

    t0 = time.perf_counter()
    launches0 = sparse_estep.launch_count
    result = train_corpus(corpus, config.lda, out_dir=day_dir,
                          save_final=False, device=dev,
                          initial_log_beta=initial_log_beta)
    em_s = time.perf_counter() - t0
    result.save(day_dir, num_terms=corpus.num_terms, include_likelihood=False)
    formats.write_doc_results(path("doc_results.csv"), corpus.doc_names,
                              result.gamma)
    formats.write_word_results(path("word_results.csv"), corpus.vocab,
                               result.log_beta)
    shapes = corpus.bucket_shapes(config.lda.sparse_min_bucket_len,
                                  config.lda.batch_size,
                                  sparse_estep.pad_multiple_for("f32"))
    lls = [ll for ll, _ in result.likelihoods]
    record("lda", t0, device=str(dev), em_iters=result.em_iters,
           final_likelihood=lls[-1] if lls else None, alpha=result.alpha,
           batches=len(shapes),
           batch_shapes=sorted({(b, l) for b, l, _ in shapes}),
           kernel_launches=sparse_estep.launch_count - launches0,
           em_s=em_s,
           em_docs_per_s=corpus.num_docs * result.em_iters / em_s)

    t0 = time.perf_counter()
    model = ScoringModel.from_lda(corpus.doc_names, result.gamma,
                                  corpus.vocab, result.log_beta,
                                  config.scoring.flow_fallback)
    blob, scores = score_flow_csv(features, model, config.scoring.threshold)
    with open(path("flow_results.csv"), "wb") as f:
        f.write(blob)
    record("score", t0, scored_events=features.num_raw_events,
           flagged=int(len(scores)),
           min_score=float(scores[0]) if len(scores) else None)

    with open(path("metrics.json"), "w") as f:
        json.dump(records, f, indent=1)
    return records


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oni_ml_tpu_torch.runner.ml_ops",
        description="oni_ml_tpu_torch flow day on the GPU "
        "(replaces ml_ops.sh YYYYMMDD flow TOL)",
    )
    p.add_argument("fdate", help="day to analyze, YYYYMMDD")
    p.add_argument("dsource", choices=["flow"])
    p.add_argument("tol", nargs="?", type=float,
                   default=float(os.environ.get("TOL", 1.1)),
                   help="suspicion threshold (ml_ops.sh defaults TOL=1.1)")
    p.add_argument("--data-dir", default=None, help="working dir (LPATH)")
    p.add_argument("--flow-path", default=None,
                   help="netflow CSV input: file, directory, glob, or "
                   "comma-separated list")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the LDA stage (default cuda; a machine "
                   "without one raises unless --device cpu)")
    p.add_argument("--topics", type=int, default=20)
    p.add_argument("--alpha", type=float, default=2.5)
    p.add_argument("--em-max-iters", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dup-factor", type=int, default=None,
                   help="feedback duplication (default: DUPFACTOR env or 1000)")
    p.add_argument("--warm-start", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="seed each EM iteration's fixed point from the "
                   "previous gamma")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.fdate) != 8 or not args.fdate.isdigit():
        raise SystemExit("fdate must be YYYYMMDD")
    env = os.environ
    config = PipelineConfig(
        data_dir=args.data_dir or env.get("LPATH", "."),
        flow_path=args.flow_path or env.get("FLOW_PATH", ""),
        lda=LDAConfig(
            num_topics=args.topics, alpha_init=args.alpha,
            em_max_iters=args.em_max_iters, batch_size=args.batch_size,
            seed=args.seed, warm_start_gamma=args.warm_start,
        ),
        feedback=FeedbackConfig(
            dup_factor=(args.dup_factor if args.dup_factor is not None
                        else int(env.get("DUPFACTOR", 1000)))
        ),
        scoring=ScoringConfig(threshold=args.tol),
    )
    run_pipeline(config, args.fdate, args.dsource, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
