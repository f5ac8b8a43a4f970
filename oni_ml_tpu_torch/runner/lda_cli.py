"""Drop-in CLI for the reference's `lda` binary (oni-lda-c), on the card
(port of oni_ml_tpu/runner/lda_cli.py).

The reference orchestrator invokes its MPI LDA engine as

    mpiexec -n 20 -f machinefile ./lda est 2.5 20 settings.txt 20 \\
        ../FDATE/model.dat random ../FDATE

(ml_ops.sh:80; argument meanings in SURVEY.md §2.8).  This module takes
the same argument vector, so a deployment can swap `mpiexec ... ./lda`
for

    python -m oni_ml_tpu_torch.runner.lda_cli est 2.5 20 settings.txt 20 \\
        ../FDATE/model.dat random ../FDATE [--device cuda|cpu]

and write `final.beta`, `final.gamma`, `final.other` and
`likelihood.dat` into the output directory.

The device is a choice the caller makes, not a fallback: EM runs on the
CUDA card (its E-step a hand-written kernel), and a machine without one
raises.  `--device cpu` after the eight reference arguments runs EM on
the CPU through the kernels' plain versions.

Differences from the reference, by design:
- `<nproc>` is accepted and ignored: the fit runs on one device, not a
  rank count.
- `random` is the only supported init (the reference's only used mode).
- per-rank `<i>.beta`/`<i>.gamma` shard files are not written (an MPI
  artifact); `final.*` and `likelihood.dat` are the contract.

settings.txt uses Blei lda-c's key-value format:

    var max iter 20
    var convergence 1e-6
    em max iter 100
    em convergence 1e-4
    alpha estimate
"""

from __future__ import annotations

import os
import sys

from ..config import LDAConfig

USAGE = ("usage: python -m oni_ml_tpu_torch.runner.lda_cli est <alpha> "
         "<num_topics> <settings.txt> <nproc-ignored> <model.dat> random "
         "<out_dir> [--device cuda|cpu]")


def read_settings(path: str) -> dict:
    """Parse lda-c settings.txt: 'key words value' lines, last token the
    value; `alpha estimate|fixed` is a bare flag."""
    out: dict = {}
    with open(path) as f:
        for raw in f:
            line = raw.strip().lower()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[:2] == ["alpha", "estimate"]:
                out["estimate_alpha"] = True
            elif parts[:2] == ["alpha", "fixed"]:
                out["estimate_alpha"] = False
            elif parts[:3] == ["var", "max", "iter"] and len(parts) > 3:
                n = int(float(parts[3]))
                # lda-c treats -1 as "iterate until converged"; the loop
                # bound is finite, so map it to a cap no real doc reaches.
                out["var_max_iters"] = 10_000 if n == -1 else n
            elif parts[:2] == ["var", "convergence"] and len(parts) > 2:
                out["var_tol"] = float(parts[2])
            elif parts[:3] == ["em", "max", "iter"] and len(parts) > 3:
                out["em_max_iters"] = int(float(parts[3]))
            elif parts[:2] == ["em", "convergence"] and len(parts) > 2:
                out["em_tol"] = float(parts[2])
            # Unknown keys and truncated lines are ignored, like lda-c's
            # fscanf-based reader.
    return out


def config_from_settings(path: str, alpha: float, k: int) -> LDAConfig:
    # warm_start_gamma off: oni-lda-c's E-step starts gamma fresh every
    # EM iteration (warm start reaches the same optimum but moves
    # likelihood.dat in late decimals); alpha_max_iters is lda-c's
    # MAX_ALPHA_ITER=100.  This surface promises the reference's
    # semantics.
    return LDAConfig(num_topics=k, alpha_init=alpha,
                     warm_start_gamma=False, alpha_max_iters=100,
                     **read_settings(path))


def main(argv: "list[str] | None" = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    wants_help = bool(argv) and argv[0] in ("-h", "--help")
    device = "cuda"
    if len(argv) == 10 and argv[8] == "--device" and argv[9] in ("cuda",
                                                                 "cpu"):
        device = argv[9]
        argv = argv[:8]
    if wants_help or len(argv) != 8 or argv[0] != "est":
        print(USAGE, file=sys.stdout if wants_help else sys.stderr)
        return 0 if wants_help else 2
    _, alpha_s, k_s, settings_path, _nproc, corpus_path, init, out_dir = argv
    if init != "random":
        print(f"only 'random' init is supported, got {init!r}",
              file=sys.stderr)
        return 2

    from ..io import Corpus
    from ..models import train_corpus

    cfg = config_from_settings(settings_path, float(alpha_s), int(k_s))
    corpus = Corpus.from_model_dat(corpus_path)
    os.makedirs(out_dir, exist_ok=True)
    result = train_corpus(corpus, cfg, out_dir=out_dir, device=device)
    final_ll = (result.likelihoods[-1][0] if result.likelihoods
                else float("nan"))
    print(f"em iterations: {result.em_iters}  "
          f"final likelihood: {final_ll:.6f}  "
          f"alpha: {result.alpha:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
