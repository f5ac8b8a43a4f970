"""Readers/writers for every file contract at the reference's stage
boundaries (port of oni_ml_tpu/io/formats.py; model.dat is built by the
native emitter, native_emit.model_emit).  Each boundary in the reference
pipeline is a file with a fixed textual format; preserving these formats
keeps the new framework drop-in compatible:

- ``word_counts`` / ``doc_wc.dat``: ``ip,word,count`` lines
  (flow_pre_lda.scala:373, dns_pre_lda.scala:330-334)
- ``words.dat``: ``idx,word`` with 0-based first-seen ids (lda_pre.py:38-41)
- ``doc.dat``: ``idx,ip`` with 1-based first-seen ids (lda_pre.py:66-73)
- ``model.dat``: Blei LDA-C corpus, ``N w1:c1 ... wN:cN`` per doc
  (lda_pre.py:84-94, README.md:115)
- ``final.beta``: K rows x V cols of log p(word|topic) (README.md:116,
  lda_post.py:91 applies np.exp)
- ``final.gamma``: D rows x K cols of unnormalized variational doc-topic
  Dirichlet parameters (README.md:117)
- ``final.other``: num_topics / num_terms / alpha (README.md:118)
- ``likelihood.dat``: one line per EM iteration (README.md:119)
- ``doc_results.csv``: ``ip,g1 g2 ... gK`` L1-normalized gamma
  (lda_post.py:35-64)
- ``word_results.csv``: ``word,p1 ... pK`` exp-normalized transposed beta
  (lda_post.py:87-123)
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Sequence, TextIO

import numpy as np


def contract_open(path: str, mode: str = "r"):
    """Pinned text-mode open for every file contract: UTF-8 with
    surrogateescape, so strings derived from hostile raw wire bytes
    (IPs, DNS-name fragments) round-trip byte-for-byte through the
    stage-boundary files instead of crashing the pipeline, and so
    output bytes never depend on the host locale."""
    return open(path, mode, encoding="utf-8", errors="surrogateescape")


def atomic_write(path: str, write_fn) -> None:
    """Run `write_fn(tmp_path)` then publish tmp -> path atomically, so
    a file under its contract name is always complete: a kill mid-write
    never leaves a partial file that a resumed run's `_stage_done`
    existence checks would trust."""
    tmp = path + ".tmp"
    write_fn(tmp)
    os.replace(tmp, path)


def atomic_write_bytes(path: str, data) -> None:
    def _write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)
    atomic_write(path, _write)


# ---------------------------------------------------------------------------
# word_counts triples ("ip,word,count")
# ---------------------------------------------------------------------------


def write_word_counts(path: str, triples: Iterable[tuple[str, str, int]]) -> None:
    # Join-and-write in blocks: one f.write per line measured ~0.9 s of
    # a 2M-event day's pre stage (1.5M calls) vs ~0.2 s blocked.
    with contract_open(path, "w") as f:
        block: list[str] = []
        for ip, word, count in triples:
            block.append(f"{ip},{word},{count}\n")
            if len(block) >= 65536:
                f.write("".join(block))
                block.clear()
        if block:
            f.write("".join(block))


def read_word_counts(path: str) -> Iterator[tuple[str, str, int]]:
    """word_counts.dat -> (ip, word, count) triples in file order."""
    with contract_open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            # Words hold no commas (bins joined by '_'); split from the
            # right so a comma in the ip column cannot shift fields.
            ip, word, count = line.rsplit(",", 2)
            yield ip, word, int(count)


# ---------------------------------------------------------------------------
# words.dat / doc.dat (vocab + doc id maps)
# ---------------------------------------------------------------------------


def write_words_dat(path: str, vocab: Sequence[str]) -> None:
    """0-based ``idx,word`` lines in id order (lda_pre.py:38-41)."""
    with contract_open(path, "w") as f:
        for i, w in enumerate(vocab):
            f.write(f"{i},{w}\n")


def read_words_dat(path: str) -> list[str]:
    vocab: list[str] = []
    with contract_open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            idx, word = line.split(",", 1)
            if int(idx) != len(vocab):
                raise ValueError(f"non-dense word id {idx} in {path}")
            vocab.append(word)
    return vocab


def write_doc_dat(path: str, doc_names: Sequence[str]) -> None:
    """1-based ``idx,ip`` lines in id order (lda_pre.py:66-73)."""
    with contract_open(path, "w") as f:
        for i, d in enumerate(doc_names):
            f.write(f"{i + 1},{d}\n")


def read_doc_dat(path: str) -> list[str]:
    docs: list[str] = []
    with contract_open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            idx, name = line.split(",", 1)
            if int(idx) != len(docs) + 1:
                raise ValueError(f"non-dense doc id {idx} in {path}")
            docs.append(name)
    return docs


# ---------------------------------------------------------------------------
# model.dat (LDA-C corpus)
# ---------------------------------------------------------------------------


def write_model_dat(
    path: str,
    doc_ptr: np.ndarray,
    word_idx: np.ndarray,
    counts: np.ndarray,
) -> None:
    """CSR corpus -> LDA-C lines ``N w1:c1 ... wN:cN`` (lda_pre.py:84-94).
    The whole buffer is built in C++ (native_emit.model_emit); under
    ONI_ML_TPU_NO_NATIVE=1 the JAX package's pure-Python branch writes
    the same bytes, over Python ints (`tolist`)."""
    from ..native_build import enabled

    if enabled():
        from ..native_emit import model_emit

        with open(path, "wb") as f:
            f.write(model_emit(doc_ptr, word_idx, counts))
        return
    ptr = np.asarray(doc_ptr).tolist()
    pairs = [
        f"{w}:{c}" for w, c in zip(np.asarray(word_idx).tolist(),
                                   np.asarray(counts).tolist())
    ]
    with contract_open(path, "w") as f:
        for d in range(len(ptr) - 1):
            lo, hi = ptr[d], ptr[d + 1]
            f.write(" ".join([str(hi - lo)] + pairs[lo:hi]) + "\n")


def read_model_dat(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LDA-C corpus -> CSR (doc_ptr [D+1], word_idx [NNZ], counts [NNZ])."""
    ptr = [0]
    widx: list[int] = []
    cnts: list[int] = []
    with contract_open(path) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            n = int(fields[0])
            if len(fields) != n + 1:
                raise ValueError(f"bad model.dat line: {line!r}")
            for tok in fields[1:]:
                w, c = tok.split(":")
                widx.append(int(w))
                cnts.append(int(c))
            ptr.append(len(widx))
    return (
        np.asarray(ptr, dtype=np.int64),
        np.asarray(widx, dtype=np.int32),
        np.asarray(cnts, dtype=np.int32),
    )


# ---------------------------------------------------------------------------
# final.beta / final.gamma / final.other / likelihood.dat (engine outputs)
# ---------------------------------------------------------------------------

# lda-c writes matrices as " %5.10f" per value; np.loadtxt (used by
# lda_post.py:70) is whitespace-tolerant, so we keep the visual format.
_FLOAT_FMT = "%5.10f"


def write_beta(path: str, log_beta: np.ndarray) -> None:
    """K x V matrix of log p(word|topic), one topic per row."""
    np.savetxt(path, np.asarray(log_beta, dtype=np.float64), fmt=_FLOAT_FMT)


def read_beta(path: str) -> np.ndarray:
    # ndmin=2 keeps single-row/single-column matrices in their written
    # orientation (atleast_2d would turn a K=1 column into a row).
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def write_gamma(path: str, gamma: np.ndarray) -> None:
    """D x K matrix of unnormalized doc-topic Dirichlet parameters."""
    np.savetxt(path, np.asarray(gamma, dtype=np.float64), fmt=_FLOAT_FMT)


def read_gamma(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def write_other(path: str, num_topics: int, num_terms: int, alpha: float) -> None:
    with contract_open(path, "w") as f:
        f.write(f"num_topics {num_topics}\n")
        f.write(f"num_terms {num_terms}\n")
        f.write(f"alpha {alpha:5.10f}\n")


def read_other(path: str) -> dict:
    out: dict = {}
    with contract_open(path) as f:
        for line in f:
            key, val = line.split()
            out[key] = float(val) if key == "alpha" else int(val)
    return out


def append_likelihood(f: TextIO, likelihood: float, convergence: float) -> None:
    """One EM iteration record, lda-c style ``%10.10f\\t%5.5e``."""
    f.write(f"{likelihood:10.10f}\t{convergence:5.5e}\n")


def read_likelihood(path: str) -> np.ndarray:
    """-> array of shape [iters, 2] (likelihood, convergence)."""
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


# ---------------------------------------------------------------------------
# doc_results.csv / word_results.csv (lda_post.py contracts)
# ---------------------------------------------------------------------------


def write_doc_results(path: str, doc_names: Sequence[str], gamma: np.ndarray) -> None:
    """L1-normalize each gamma row; all-zero rows emit the literal zero
    string the reference writes (lda_post.py:48-56)."""
    gamma = np.asarray(gamma, dtype=np.float64)
    k = gamma.shape[1]
    zero_str = " ".join(["0.0"] * k)
    with contract_open(path, "w") as f:
        for name, row in zip(doc_names, gamma):
            total = row.sum()
            if total > 0:
                norm = " ".join(str(v) for v in row / total)
            else:
                norm = zero_str
            f.write(f"{name},{norm}\n")


def _read_keyed_matrix(path: str) -> tuple[list[str], np.ndarray]:
    """Shared reader for `key,v1 v2 ... vK` CSVs (doc_results /
    word_results): one float64 parse over the whole file instead of an
    np.array call per row — the per-row version was ~1 s of the score
    stage at 48k model rows.  Raises on ragged rows (the per-row
    version silently produced an object array)."""
    names: list[str] = []
    flat: list[str] = []
    k = -1
    with contract_open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, vals = line.split(",", 1)
            pieces = vals.replace('"', "").split()
            if k < 0:
                k = len(pieces)
            elif len(pieces) != k:
                raise ValueError(
                    f"ragged value row for {name!r} in {path}: "
                    f"{len(pieces)} fields, expected {k}"
                )
            names.append(name)
            flat.extend(pieces)
    if not names:
        return names, np.zeros((0, 0), np.float64)
    return names, np.array(flat, dtype=np.float64).reshape(len(names), k)


def read_doc_results(path: str) -> tuple[list[str], np.ndarray]:
    return _read_keyed_matrix(path)


def write_word_results(path: str, vocab: Sequence[str], log_beta: np.ndarray) -> None:
    """Per topic-row exponentiate + normalize, transpose to V x K, one word
    per line (lda_post.py:87-123)."""
    log_beta = np.asarray(log_beta, dtype=np.float64)
    # exp+normalize in a numerically safe way: subtract the row max first.
    shifted = np.exp(log_beta - log_beta.max(axis=1, keepdims=True))
    p_wgz = (shifted / shifted.sum(axis=1, keepdims=True)).T  # V x K
    with contract_open(path, "w") as f:
        for word, row in zip(vocab, p_wgz):
            f.write(f"{word}," + " ".join(str(v) for v in row) + "\n")


def read_word_results(path: str) -> tuple[list[str], np.ndarray]:
    return _read_keyed_matrix(path)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
