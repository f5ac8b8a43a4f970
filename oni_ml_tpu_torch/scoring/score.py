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
The gather-dot runs in the port's C++ library (native_emit.score_dot;
under ONI_ML_TPU_NO_NATIVE=1 a numpy loop of the same bits).  The index
arrays and the results CSV come from the feature container
(`event_indices`, `results_csv`): a native container resolves once per
unique IP and word and assembles its CSV in C++, a Python one loops; the
bytes are the same.

Engines: that host float64 path is the default and the golden-bytes
oracle; scoring/pipeline.py is the DEVICE engine, the gather-dot-filter
over fixed-size chunks on the card with double-buffered dispatch and
survivors-only readback (opt in per call via engine="device", per run
via ScoringConfig.engine, or process-wide via ONI_ML_TPU_SCORE=device).
An engine name other than host or device raises.

Serving scores small batches (micro-batches of up to a few thousand
events), where the card's fixed per-dispatch cost can lose to the host:
`batched_scores` picks the engine per batch through `use_device_path`,
whose auto mode prices the choice from `dispatch_calibration`, this
process's measured break-even on its device (or the plan entry an
earlier process measured, or the ONI_ML_TPU_SCORE_BREAK_EVEN pin).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..features.container import index_rows as _index_rows
from ..features.dns import DnsFeatures
from ..features.flow import FlowFeatures
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

    def ip_rows(self, ips) -> np.ndarray:
        """theta row per IP, int32; an unseen IP gets the fallback row."""
        return _index_rows(self.ip_index, ips, len(self.ip_index))

    def word_rows(self, words) -> np.ndarray:
        """p row per word, int32; an unseen word gets the fallback row."""
        return _index_rows(self.word_index, words, len(self.word_index))


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
    """score[i] = <theta[ip_idx[i]], p[word_idx[i]]> in float64:
    native_emit.score_dot, the fused C gather-dot (no [N, K] gather
    temporaries), or under ONI_ML_TPU_NO_NATIVE=1 numpy in fixed-size
    chunks.  Both sum in k order: the reference's per-event fold
    (flow_post_lda.scala:231) and the JAX package's bytes (np.einsum's
    SIMD partial sums would move the last ulp of str(score)).  Both
    raise IndexError on an index outside the model's rows."""
    from ..native_build import enabled

    theta = np.asarray(model.theta, np.float64)
    p = np.asarray(model.p, np.float64)
    if enabled():
        from ..native_emit import score_dot

        return score_dot(theta, p, ip_idx, word_idx)
    _check_index_range(model, ip_idx, word_idx)
    n = len(ip_idx)
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
    ties (the reference's `filter < TOL` + `sortByKey()`).  The device
    pipeline's compaction (scoring/pipeline.py) keeps this exact order,
    stable threshold-boundary ties included."""
    keep = np.where(scores < threshold)[0]
    return keep[np.argsort(scores[keep], kind="stable")]


def _device_model(model: ScoringModel, device, stats=None):
    """float32 copies of theta/p on `device`, cached on the model per
    device, so a long-running scorer transfers each model once, not once
    per chunk: half the H2D bytes of the float64 host matrices, and at
    K=20 the float32 gather and accumulate agrees with the float64 host
    oracle to ~1e-6 relative.

    A model marked `_device_dtype = "bfloat16"` (the fleet's stacked
    snapshots under ServingConfig.stack_precision "bf16") is stored in
    bfloat16: half the bytes again.  The gather-dot
    (pipeline.score_dot_rows) casts the gathered rows to float32 before
    it accumulates, so only the storage is bf16; scores stay within
    2^-7 relative of the float32 stack's.  `stats`
    (pipeline.DispatchStats) records the one transfer."""
    cache = model.__dict__.setdefault("_device_cache", {})
    key = str(torch.device(device))
    cached = cache.get(key)
    if cached is None:
        dtype = (torch.bfloat16
                 if model.__dict__.get("_device_dtype") == "bfloat16"
                 else torch.float32)
        # float32 on the link, the storage dtype cast on the device.
        cached = cache[key] = (
            torch.as_tensor(model.theta, dtype=torch.float32).to(device)
            .to(dtype),
            torch.as_tensor(model.p, dtype=torch.float32).to(device)
            .to(dtype),
        )
        if stats is not None:
            stats.weight_h2d_bytes += cached[0].element_size() * (
                model.theta.size + model.p.size)
    return cached


def device_scores(model: ScoringModel, ip_idx, word_idx, *,
                  chunk: "int | None" = None, stats=None,
                  device=None) -> np.ndarray:
    """score[i] = <theta[ip_idx[i]], p[word_idx[i]]> on the device,
    through the chunked pipeline (scoring/pipeline.py chunked_scores): an
    input of at most one chunk pads to the next power of two and runs as
    one dispatch.  Results come back float64 for drop-in use where
    _batched_scores is used.

    Accuracy: float32 gather and accumulate over K terms, ~1e-6 relative
    to the float64 host path at K=20.  The score stage's golden bytes
    stay on _batched_scores."""
    from . import pipeline

    return pipeline.chunked_scores(
        model, ip_idx, word_idx,
        chunk=pipeline.DEFAULT_CHUNK if chunk is None else chunk,
        stats=stats, device=device)


# device_score_min's auto mode: pick the engine from the measured
# dispatch calibration instead of a size threshold.
AUTO_DEVICE_MIN = 0

# This process's calibration per device ("cuda", "cpu"): measured once,
# or read from the plan or the env pin.
_CALIBRATION: "dict[str, dict]" = {}


def _best_of(fn, reps: int = 3) -> float:
    t = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t = min(t, time.perf_counter() - t0)
    return t


def dispatch_calibration(force: bool = False, device=None) -> dict:
    """The measured break-even batch size of the host-or-device choice
    for scoring on `device` (None: the card).

    -> {"dispatch_s", "host_event_s", "device_event_s", "break_even",
    "source"}.  dispatch_s is device_scores' time for one event (the
    fixed cost of a dispatch: index staging, the gather-dot, the read
    back), device_event_s its marginal cost per event over a 4,096-event
    batch, host_event_s _batched_scores' cost per event over the same
    batch; the break-even is dispatch_s / (host_event_s -
    device_event_s), and None where the device's marginal cost does not
    beat the host's, so the device path can never win and auto dispatch
    pins the host.

    Sources, in order: ONI_ML_TPU_SCORE_BREAK_EVEN pins the break-even
    ("env"; <= 0 means never the device); the plan entry an earlier
    process on this backend recorded ("plan"); else a measurement
    ("measured") over a synthetic K=20 model on `device`, recorded to
    the plan cache for the next process.  `force=True` measures again.
    A failure of the device raises: the calibration never pins the host
    to hide one."""
    from ..device import resolve_device

    dev = resolve_device(device)
    key = str(dev)
    cached = _CALIBRATION.get(key)
    if cached is not None and not force:
        return cached
    env = os.environ.get("ONI_ML_TPU_SCORE_BREAK_EVEN")
    if env is not None:
        be = int(env)
        cal = _CALIBRATION[key] = {
            "dispatch_s": None, "host_event_s": None,
            "device_event_s": None,
            "break_even": be if be > 0 else None, "source": "env",
        }
        return cal
    if not force:
        from ..plans import lookup_value

        planned = lookup_value("dispatch_calibration", device=dev)
        if planned is not None:
            be = planned.get("break_even")
            cal = _CALIBRATION[key] = {
                "dispatch_s": planned.get("dispatch_s"),
                "host_event_s": planned.get("host_event_s"),
                "device_event_s": planned.get("device_event_s"),
                "break_even": int(be) if be is not None else None,
                "source": "plan",
            }
            return cal
    rng = np.random.default_rng(0)
    k, d, v, n = 20, 1024, 1024, 4096
    model = ScoringModel(ip_index={}, theta=rng.random((d + 1, k)),
                         word_index={}, p=rng.random((v + 1, k)))
    ia = rng.integers(0, d, n).astype(np.int32)
    ib = rng.integers(0, v, n).astype(np.int32)
    host_event_s = _best_of(lambda: _batched_scores(model, ia, ib)) / n
    # Warm both sizes before timing (the model's upload, the first
    # launches and the pinned buffers' allocation).
    device_scores(model, ia[:1], ib[:1], device=dev)
    device_scores(model, ia, ib, device=dev)
    dispatch_s = _best_of(
        lambda: device_scores(model, ia[:1], ib[:1], device=dev))
    t_n = _best_of(lambda: device_scores(model, ia, ib, device=dev))
    device_event_s = max(0.0, (t_n - dispatch_s) / (n - 1))
    if device_event_s >= host_event_s:
        break_even = None            # the device can never win here
    else:
        break_even = int(np.ceil(dispatch_s / (host_event_s
                                               - device_event_s)))
    cal = _CALIBRATION[key] = {
        "dispatch_s": dispatch_s, "host_event_s": host_event_s,
        "device_event_s": device_event_s, "break_even": break_even,
        "source": "measured",
    }
    from ..plans import note_sweep, record_value

    note_sweep("dispatch_calibration")
    record_value("dispatch_calibration",
                 {k2: v2 for k2, v2 in cal.items() if k2 != "source"},
                 source="autotune", device=dev)
    return cal


def use_device_path(n: int, device_min, device=None) -> bool:
    """The one host-or-device decision, shared by batched_scores and the
    serving records' `scorer` label so the two cannot drift: None pins
    the host, AUTO_DEVICE_MIN (0) or "auto" consults
    dispatch_calibration(device=device), a positive int is a hard
    threshold."""
    if device_min is None or n == 0:
        return False
    if device_min == "auto" or device_min == AUTO_DEVICE_MIN:
        break_even = dispatch_calibration(device=device)["break_even"]
        return break_even is not None and n >= break_even
    return n >= device_min


def batched_scores(model: ScoringModel, ip_idx, word_idx,
                   device_min=None, device=None) -> np.ndarray:
    """The serving scorer, float64 out: device_scores on `device` where
    use_device_path says so, else the host's float64 _batched_scores
    (device_min None, the default, pins the host)."""
    if use_device_path(len(ip_idx), device_min, device):
        return device_scores(model, ip_idx, word_idx, device=device)
    return _batched_scores(model, ip_idx, word_idx)


def _score_engine(engine: "str | None") -> str:
    """The score stage's engine: "host" (the default) is the float64
    oracle whose results-CSV bytes are pinned; "device" runs the
    gather-dot-filter pipeline with float32 arithmetic on the card.  An
    unset engine follows ONI_ML_TPU_SCORE; any other name raises."""
    if not engine:
        engine = os.environ.get("ONI_ML_TPU_SCORE") or "host"
    if engine not in ("host", "device"):
        raise ValueError(
            f"scoring engine must be 'host' or 'device', got {engine!r}")
    return engine


def scored_events(model: ScoringModel, pairs, threshold: float,
                  engine: "str | None" = None, chunk: "int | None" = None,
                  stats=None, device=None, mesh=None):
    """Score every event of one or two (ip rows, word rows) index pairs
    (DNS and table sources one, flow two: src and dest) and keep those
    under the threshold, by the resolved engine (`_score_engine`).
    -> (order: kept event indices ascending by score with stable ties,
    one full-length float64 score array per pair, the kept scores
    ascending: the pair's score, or for two pairs their min).

    On the device engine only the survivors come back
    (scoring/pipeline.py); their scores are scattered into full-length
    arrays whose other entries are never read (only survivors are
    formatted).  The host engine is the float64 path.  `mesh` runs the
    device pipeline over a mesh's data slots (scoring/pipeline.py)."""
    n = len(pairs[0][0])
    if _score_engine(engine) == "device":
        from . import pipeline

        kw = dict(chunk=chunk or pipeline.DEFAULT_CHUNK, stats=stats,
                  device=device, mesh=mesh)
        if len(pairs) == 1:
            order, kept = pipeline.filtered_scores(model, *pairs[0],
                                                   threshold, **kw)
            cols = [kept]
        else:
            order, src_k, dest_k, kept = pipeline.filtered_flow_scores(
                model, *pairs[0], *pairs[1], threshold, **kw)
            cols = [src_k, dest_k]
        full = []
        for col in cols:
            a = np.zeros(n, np.float64)
            a[order] = col
            full.append(a)
        return order, full, kept
    full = [_batched_scores(model, ip, w) for ip, w in pairs]
    key = full[0] if len(full) == 1 else np.minimum(full[0], full[1])
    order = _keep_order(key, threshold)
    return order, full, key[order]


def prep_indices(prep, features, model: ScoringModel, dsource: str):
    """The event index arrays: a dataplane ScoringPrep's when one is
    given (checked against this day and this model's index spaces: a
    mismatch is a bug and raises), else the container's
    `event_indices` resolved here (features/container.py: a native one
    once per unique IP and word, then a gather by event id)."""
    if prep is None:
        return features.event_indices(model.ip_index, model.word_index)
    if prep.dsource != dsource:
        raise ValueError(f"scoring prep is for dsource {prep.dsource!r}, "
                         f"scoring {dsource!r}")
    if prep.num_raw_events != features.num_raw_events:
        raise ValueError(
            f"scoring prep covers {prep.num_raw_events} raw events, "
            f"features carry {features.num_raw_events}")
    prep.check_model(model)
    return prep.indices


def score_flow_csv(features: FlowFeatures, model: ScoringModel,
                   threshold: float, engine: "str | None" = None,
                   chunk: "int | None" = None, stats=None, device=None,
                   prep=None, mesh=None) -> "tuple[bytes, np.ndarray]":
    """Flow scoring -> (flow_results.csv's bytes, the kept events' min
    scores ascending).  Each row is the 35 featurized columns +
    src_score + dest_score; only raw events are scored (feedback
    duplicates train but are never emitted).  engine/chunk/stats/device/
    mesh select and instrument the device pipeline (scored_events);
    `prep` is the dataplane's ScoringPrep (prep_indices)."""
    sip_idx, sw_idx, dip_idx, dw_idx = prep_indices(prep, features, model,
                                                    "flow")
    order, (src_scores, dest_scores), kept = scored_events(
        model, [(sip_idx, sw_idx), (dip_idx, dw_idx)], threshold, engine,
        chunk, stats, device, mesh)
    return features.results_csv(src_scores, dest_scores, order), kept


def _dns_scored(features: DnsFeatures, model: ScoringModel,
                threshold: float, engine=None, chunk=None, stats=None,
                device=None, prep=None, mesh=None):
    """-> (order: the raw events under threshold, ascending; their score
    array; their scores ascending)."""
    ip_idx, word_idx = prep_indices(prep, features, model, "dns")
    return scored_events(model, [(ip_idx, word_idx)], threshold, engine,
                         chunk, stats, device, mesh)


def score_dns_csv(features: DnsFeatures, model: ScoringModel,
                  threshold: float, engine: "str | None" = None,
                  chunk: "int | None" = None, stats=None, device=None,
                  prep=None, mesh=None) -> "tuple[bytes, np.ndarray]":
    """DNS scoring as one CSV buffer for dns_results.csv: each row the
    15 featurized columns + score (see score_flow_csv)."""
    order, (scores,), kept = _dns_scored(features, model, threshold, engine,
                                         chunk, stats, device, prep, mesh)
    return features.results_csv(scores, order), kept


def score_dns(features: DnsFeatures, model: ScoringModel, threshold: float,
              engine: "str | None" = None, device=None,
              ) -> "tuple[list, np.ndarray]":
    """DNS scoring: one <theta_ip_dst, p_word> per event
    (dns_post_lda.scala:312-331); (csv rows under threshold ascending,
    their scores)."""
    order, (scores,), kept = _dns_scored(features, model, threshold, engine,
                                         device=device)
    return features.results_rows(scores, order), kept
