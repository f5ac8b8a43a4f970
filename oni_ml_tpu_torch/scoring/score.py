"""Suspicious-connects scoring of the flow and DNS days (port of the
host path of oni_ml_tpu/scoring/score.py; flow_post_lda.scala:227-248,
dns_post_lda.scala:312-331).

p(event) = sum_k p(topic k | event's IP) * p(event's word | topic k);
events scoring below the threshold are emitted ascending (most
suspicious first).  The model is two dense float64 matrices — theta
[D+1, K] and p [V+1, K], each with its fallback vector as the extra
final row (0.05 per topic for flow, 0.1 for dns: the reference's
fallbacks) — and scoring is two row gathers and a dot on the host in
float64, the JAX package's golden-bytes path: the same arithmetic in
the same order, so the scored CSV is byte-identical for the same model.
The device scorer (the JAX package's engine="device") is not ported:
asking for it raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..features.dns import DNS_COLUMNS, DnsFeatures
from ..features.flow import FLOW_COLUMNS, FlowFeatures
from ..io import formats


@dataclass
class ScoringModel:
    """theta/p matrices plus key->row maps, fallback row appended last."""

    ip_index: dict
    theta: np.ndarray            # [D+1, K], row D = fallback
    word_index: dict
    p: np.ndarray                # [V+1, K], row V = fallback

    @property
    def num_topics(self) -> int:
        return self.theta.shape[1]

    @classmethod
    def from_results(cls, doc_names, doc_topic, vocab, word_topic,
                     fallback: float) -> "ScoringModel":
        k = doc_topic.shape[1] if doc_topic.size else word_topic.shape[1]
        theta = np.concatenate(
            [np.asarray(doc_topic, np.float64), np.full((1, k), fallback)]
        )
        p = np.concatenate(
            [np.asarray(word_topic, np.float64), np.full((1, k), fallback)]
        )
        return cls(
            ip_index={ip: i for i, ip in enumerate(doc_names)},
            theta=theta,
            word_index={w: i for i, w in enumerate(vocab)},
            p=p,
        )

    @classmethod
    def from_files(cls, doc_results_path: str, word_results_path: str,
                   fallback: float) -> "ScoringModel":
        """Load doc_results.csv / word_results.csv."""
        doc_names, doc_topic = formats.read_doc_results(doc_results_path)
        vocab, word_topic = formats.read_word_results(word_results_path)
        return cls.from_results(doc_names, doc_topic, vocab, word_topic, fallback)

    @classmethod
    def from_lda(cls, doc_names, gamma, vocab, log_beta,
                 fallback: float) -> "ScoringModel":
        """In-memory model from a trained LDA result, equal to the double
        to writing doc_results.csv / word_results.csv and reading them
        back (the writers print shortest-repr doubles, and this repeats
        their normalization arithmetic)."""
        gamma = np.asarray(gamma, dtype=np.float64)
        doc_topic = np.zeros_like(gamma)
        totals = gamma.sum(axis=1)
        nz = totals > 0
        doc_topic[nz] = gamma[nz] / totals[nz][:, None]
        log_beta = np.asarray(log_beta, dtype=np.float64)
        shifted = np.exp(log_beta - log_beta.max(axis=1, keepdims=True))
        word_topic = (shifted / shifted.sum(axis=1, keepdims=True)).T
        return cls.from_results(doc_names, doc_topic, vocab, word_topic,
                                fallback)


def _index_rows(index: dict, queries, fallback_row: int) -> np.ndarray:
    """Row per query; misses get the fallback row."""
    get = index.get
    return np.fromiter(
        (get(s, fallback_row) for s in queries), np.int32, len(queries)
    )


def _check_index_range(model: ScoringModel, ip_idx, word_idx) -> None:
    ip_arr = np.asarray(ip_idx)
    w_arr = np.asarray(word_idx)
    if len(ip_arr) and (
        int(ip_arr.min()) < 0 or int(ip_arr.max()) >= model.theta.shape[0]
        or int(w_arr.min()) < 0 or int(w_arr.max()) >= model.p.shape[0]
    ):
        raise IndexError("model-row index out of range")


def _batched_scores(model: ScoringModel, ip_idx, word_idx,
                    batch: int = 1 << 20) -> np.ndarray:
    """score[i] = <theta[ip_idx[i]], p[word_idx[i]]> in float64, in
    fixed-size chunks.  Sequential k-order accumulation: the
    reference's per-event fold (flow_post_lda.scala:231), and the JAX
    package's bytes (np.einsum's SIMD partial sums would move the last
    ulp of str(score))."""
    _check_index_range(model, ip_idx, word_idx)
    n = len(ip_idx)
    theta = np.asarray(model.theta, np.float64)
    p = np.asarray(model.p, np.float64)
    out = np.empty(n, dtype=np.float64)
    k = theta.shape[1]
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        a = theta[np.asarray(ip_idx[lo:hi], np.int32)]
        b = p[np.asarray(word_idx[lo:hi], np.int32)]
        acc = a[:, 0] * b[:, 0]
        for j in range(1, k):
            acc = acc + a[:, j] * b[:, j]
        out[lo:hi] = acc
    return out


def _keep_order(scores: np.ndarray, threshold: float) -> np.ndarray:
    """Event indices under threshold, ascending by score, stable on
    ties (the reference's `filter < TOL` + `sortByKey()`)."""
    keep = np.where(scores < threshold)[0]
    return keep[np.argsort(scores[keep], kind="stable")]


def _host_only(engine: "str | None") -> None:
    """The port scores on the host only: an explicit engine="device"
    raises until the device scorer is ported."""
    if engine == "device":
        raise NotImplementedError(
            "the device scorer is not ported yet; use engine='host' (the "
            "float64 host scorer)")
    if engine not in (None, "host"):
        raise ValueError(
            f"scoring engine must be 'host' or 'device', got {engine!r}")


def flow_event_indices(features: FlowFeatures, ip_index: dict,
                       word_index: dict):
    """Model-row index arrays (sip, src word, dip, dest word) for every
    raw flow event; misses get the fallback row `len(index)`."""
    n = features.num_raw_events
    s_col, d_col = FLOW_COLUMNS["sip"], FLOW_COLUMNS["dip"]
    rows = features.rows[:n]
    fb_ip, fb_w = len(ip_index), len(word_index)
    return (
        _index_rows(ip_index, [r[s_col] for r in rows], fb_ip),
        _index_rows(word_index, features.src_word[:n], fb_w),
        _index_rows(ip_index, [r[d_col] for r in rows], fb_ip),
        _index_rows(word_index, features.dest_word[:n], fb_w),
    )


def _flow_scored(features: FlowFeatures, model: ScoringModel,
                 threshold: float):
    """-> (csv rows under threshold, their min scores ascending).  Each
    row is the 35 featurized columns + src_score + dest_score; only raw
    events are scored (feedback duplicates train but are never
    emitted)."""
    sip_idx, sw_idx, dip_idx, dw_idx = flow_event_indices(
        features, model.ip_index, model.word_index
    )
    src_scores = _batched_scores(model, sip_idx, sw_idx)
    dest_scores = _batched_scores(model, dip_idx, dw_idx)
    min_scores = np.minimum(src_scores, dest_scores)
    order = _keep_order(min_scores, threshold)
    rows = [
        ",".join(
            features.featurized_row(i)
            + [str(src_scores[i]), str(dest_scores[i])]
        )
        for i in order
    ]
    return rows, min_scores[order]


def _csv_blob(rows) -> bytes:
    return "".join(r + "\n" for r in rows).encode("utf-8", "surrogateescape")


def score_flow_csv(features: FlowFeatures, model: ScoringModel,
                   threshold: float, engine: "str | None" = None,
                   ) -> "tuple[bytes, np.ndarray]":
    """Flow scoring with the output as one CSV buffer (newline-terminated
    rows) for flow_results.csv."""
    _host_only(engine)
    rows, scores = _flow_scored(features, model, threshold)
    return _csv_blob(rows), scores


def _dns_client_strings(features: DnsFeatures, n: int) -> list:
    """The client IP (ip_dst, the document) of the first n events."""
    ip_col = DNS_COLUMNS["ip_dst"]
    return [r[ip_col] for r in features.rows[:n]]


def dns_event_indices(features: DnsFeatures, ip_index: dict,
                      word_index: dict):
    """Model-row index arrays (ip, word) for every raw DNS event; misses
    get the fallback row `len(index)`."""
    n = features.num_raw_events
    return (
        _index_rows(ip_index, _dns_client_strings(features, n),
                    len(ip_index)),
        _index_rows(word_index, features.word[:n], len(word_index)),
    )


def _dns_scored(features: DnsFeatures, model: ScoringModel,
                threshold: float):
    """-> (csv rows under threshold, their scores ascending).  Each row is
    the 15 featurized columns + score; only raw events are scored."""
    ip_idx, word_idx = dns_event_indices(features, model.ip_index,
                                         model.word_index)
    scores = _batched_scores(model, ip_idx, word_idx)
    order = _keep_order(scores, threshold)
    rows = [",".join(features.featurized_row(i) + [str(scores[i])])
            for i in order]
    return rows, scores[order]


def score_dns_csv(features: DnsFeatures, model: ScoringModel,
                  threshold: float, engine: "str | None" = None,
                  ) -> "tuple[bytes, np.ndarray]":
    """DNS scoring as one CSV buffer for dns_results.csv."""
    _host_only(engine)
    rows, scores = _dns_scored(features, model, threshold)
    return _csv_blob(rows), scores


def score_dns(features: DnsFeatures, model: ScoringModel, threshold: float,
              engine: "str | None" = None) -> "tuple[list, np.ndarray]":
    """DNS scoring: one <theta_ip_dst, p_word> per event
    (dns_post_lda.scala:312-331); (csv rows under threshold ascending,
    their scores)."""
    _host_only(engine)
    return _dns_scored(features, model, threshold)
