"""The port's device scoring engine (oni_ml_tpu_torch/scoring/pipeline.py,
score.py's device parts) against the JAX package's, both on the CPU
(device="cpu"), on the same numpy inputs from a seed.  Mirrors every
non-mesh case of tests/test_scoring_pipeline.py:

- survivor sets and order exact, at thresholds in a measured gap (and
  on float32-exact models at any threshold);
- scores within rel 1e-6 of the JAX device engine (both float32
  gathers and accumulation over K terms, summed in another order), and
  within the JAX test's stated rel 1e-6 of the float64 host path;
- port against port: chunked scores bitwise equal to one-shot;
- DispatchStats.as_record() equal to the JAX package's field by field;
- the host engine's CSV bytes unchanged with ONI_ML_TPU_SCORE unset;
- the runner's score stage under ONI_ML_TPU_SCORE=device: the same
  survivors as the JAX runner's on the golden flow and DNS days and a
  synthetic proxy day, from the same model files."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from oni_ml_tpu import sources as jsources
from oni_ml_tpu.config import (
    DataplaneConfig,
    PipelineConfig as JPipelineConfig,
    ScoringConfig as JScoringConfig,
    TelemetryConfig as JTelemetryConfig,
)
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu.scoring import DispatchStats as JDispatchStats
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.scoring import filtered_flow_scores as j_filtered_flow
from oni_ml_tpu.scoring import filtered_scores as j_filtered
from oni_ml_tpu.scoring import chunked_scores as j_chunked
from oni_ml_tpu_torch.config import LDAConfig, PipelineConfig, ScoringConfig
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.scoring import (
    DispatchStats,
    ScoringModel,
    chunked_scores,
    device_scores,
    filtered_flow_scores,
    filtered_scores,
    score_dns,
    score_dns_csv,
)
from oni_ml_tpu_torch.scoring import pipeline
from oni_ml_tpu_torch.scoring import score as score_mod
from oni_ml_tpu_torch.scoring.score import _batched_scores, _keep_order
from oni_ml_tpu_torch.telemetry import Recorder, roofline, use_recorder

CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FDATE = "20160122"


def _model(k=20, d=300, v=200, seed=0):
    rng = np.random.default_rng(seed)
    theta, p = rng.random((d + 1, k)), rng.random((v + 1, k))
    return (ScoringModel(ip_index={}, theta=theta, word_index={}, p=p),
            JScoringModel(ip_index={}, theta=theta, word_index={}, p=p))


def _idx(model, n, seed=1):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, model.theta.shape[0], n).astype(np.int32),
        rng.integers(0, model.p.shape[0], n).astype(np.int32),
    )


def _gap_threshold(scores):
    """A threshold no score sits within float32 epsilon of (the JAX
    test's rule): the geometric midpoint of the widest relative gap
    between adjacent distinct scores near the median."""
    s = np.sort(np.unique(scores))
    mid = len(s) // 2
    i0, i1 = max(1, mid - 64), min(len(s), mid + 64)
    ratios = s[i0:i1] / s[i0 - 1: i1 - 1]
    j = int(np.argmax(ratios)) + i0
    assert s[j] / s[j - 1] > 1 + 1e-5, "no f32-safe gap in the sample"
    return float(np.sqrt(s[j] * s[j - 1]))


def _exact_model(k=4, d=32, v=16):
    """Scores exact in float32 and float64 (one-hot power-of-two theta
    rows, constant power-of-two p rows): ordering, stable ties included,
    must match exactly."""
    theta = np.zeros((d + 1, k))
    p = np.zeros((v + 1, k))
    for i in range(d + 1):
        theta[i, i % k] = 2.0 ** -(i % 5)
    for j in range(v + 1):
        p[j] = 2.0 ** -(j % 3)
    return (ScoringModel(ip_index={}, theta=theta, word_index={}, p=p),
            JScoringModel(ip_index={}, theta=theta, word_index={}, p=p))


# ---------------------------------------------------------------------------
# threshold compaction parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [7, 64, 1 << 16])
def test_filtered_matches_keep_order_exact(chunk):
    """Exact ordering on float32-exact scores, across chunk sizes that
    split the day mid-stream, at a mid threshold, one sitting exactly on
    a score value (strict <), all-kept and none-kept: the host
    `_keep_order` oracle and the JAX device engine alike."""
    model, jmodel = _exact_model()
    ia, ib = _idx(model, 500, seed=3)
    host = _batched_scores(model, ia, ib)
    assert len(np.unique(host)) < 16          # dense tie structure
    for threshold in (2.0 ** -4, 2.0 ** -3, np.inf, 0.0):
        want = _keep_order(host, threshold)
        got_order, got_scores = filtered_scores(
            model, ia, ib, threshold, chunk=chunk, device=CPU)
        np.testing.assert_array_equal(got_order, want)
        np.testing.assert_array_equal(got_scores, host[want])
        j_order, j_scores = j_filtered(jmodel, ia, ib, threshold, chunk=chunk)
        np.testing.assert_array_equal(got_order, j_order)
        np.testing.assert_array_equal(got_scores, j_scores)


def test_filtered_empty_input():
    model, _ = _exact_model()
    order, scores = filtered_scores(
        model, np.zeros(0, np.int32), np.zeros(0, np.int32), 1.0, device=CPU)
    assert order.shape == (0,) and scores.shape == (0,)
    out = filtered_flow_scores(
        model, *(np.zeros(0, np.int32) for _ in range(4)), 1.0, device=CPU)
    assert len(out) == 4 and all(a.shape == (0,) for a in out)
    assert chunked_scores(model, np.zeros(0, np.int32),
                          np.zeros(0, np.int32), device=CPU).shape == (0,)


def test_filtered_random_parity_k20():
    """Random K=20 model, a threshold in a measured gap: the same
    survivors in the same order as the JAX device engine, scores within
    rel 1e-6 of it and of the float64 host path."""
    model, jmodel = _model(k=20)
    ia, ib = _idx(model, 20_000)
    host = _batched_scores(model, ia, ib)
    threshold = _gap_threshold(host)
    want = _keep_order(host, threshold)
    got_order, got_scores = filtered_scores(model, ia, ib, threshold,
                                            chunk=4096, device=CPU)
    j_order, j_scores = j_filtered(jmodel, ia, ib, threshold, chunk=4096)
    assert set(got_order.tolist()) == set(want.tolist())
    np.testing.assert_array_equal(got_order, j_order)
    np.testing.assert_allclose(got_scores, j_scores, rtol=1e-6)
    np.testing.assert_allclose(got_scores, host[got_order], rtol=1e-6)
    assert np.all(np.diff(got_scores) >= 0)


def test_flow_filtered_parity():
    model, jmodel = _model(k=20, seed=5)
    sa, sw = _idx(model, 10_000, seed=6)
    da, dw = _idx(model, 10_000, seed=7)
    src = _batched_scores(model, sa, sw)
    dest = _batched_scores(model, da, dw)
    mn = np.minimum(src, dest)
    threshold = _gap_threshold(mn)
    want = _keep_order(mn, threshold)
    order, src_k, dest_k, mn_k = filtered_flow_scores(
        model, sa, sw, da, dw, threshold, chunk=2048, device=CPU)
    jout = j_filtered_flow(jmodel, sa, sw, da, dw, threshold, chunk=2048)
    assert set(order.tolist()) == set(want.tolist())
    np.testing.assert_array_equal(order, jout[0])
    for got, ref, host_col in zip((src_k, dest_k, mn_k), jout[1:],
                                  (src, dest, mn)):
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        np.testing.assert_allclose(got, host_col[order], rtol=1e-6)
    assert np.all(np.diff(mn_k) >= 0)


def test_flow_filtered_exact_order():
    model, jmodel = _exact_model()
    sa, sw = _idx(model, 400, seed=8)
    da, dw = _idx(model, 400, seed=9)
    mn = np.minimum(
        _batched_scores(model, sa, sw), _batched_scores(model, da, dw))
    for threshold in (2.0 ** -3, np.inf, 0.0):
        want = _keep_order(mn, threshold)
        order, _, _, mn_k = filtered_flow_scores(
            model, sa, sw, da, dw, threshold, chunk=128, device=CPU)
        np.testing.assert_array_equal(order, want)
        np.testing.assert_array_equal(mn_k, mn[want])
        jout = j_filtered_flow(jmodel, sa, sw, da, dw, threshold, chunk=128)
        np.testing.assert_array_equal(order, jout[0])


# ---------------------------------------------------------------------------
# float32 transfer, bitwise chunking
# ---------------------------------------------------------------------------


def test_f32_transfer_tolerance():
    """theta/p go to the device as float32, cached on the model: scores
    within rel 1e-6 of the float64 host oracle and of the JAX engine."""
    model, jmodel = _model(k=20, seed=11)
    ia, ib = _idx(model, 8192, seed=12)
    host = _batched_scores(model, ia, ib)
    dev = chunked_scores(model, ia, ib, chunk=1024, device=CPU)
    np.testing.assert_allclose(dev, host, rtol=1e-6)
    np.testing.assert_allclose(dev, j_chunked(jmodel, ia, ib, chunk=1024),
                               rtol=1e-6)
    theta_dev, p_dev = score_mod._device_model(model, CPU)
    assert theta_dev.dtype == p_dev.dtype == torch.float32
    assert score_mod._device_model(model, CPU)[0] is theta_dev


@pytest.mark.parametrize("chunk", [256, 1000])
def test_chunked_scores_bitwise_equals_single_dispatch(chunk):
    """Chunking changes no score bit: each event's dot is its own, in a
    fixed k order, so the chunked pipeline and the one-shot padded
    dispatch agree exactly (and the flow filter's survivors carry the
    same bits at two chunk sizes)."""
    model, _ = _model(seed=13)
    ia, ib = _idx(model, 3000, seed=14)
    one = device_scores(model, ia, ib, device=CPU)      # one padded dispatch
    many = chunked_scores(model, ia, ib, chunk=chunk, device=CPU)
    np.testing.assert_array_equal(one, many)
    da, dw = _idx(model, 3000, seed=15)
    a = filtered_flow_scores(model, ia, ib, da, dw, np.inf, chunk=chunk,
                             device=CPU)
    b = filtered_flow_scores(model, ia, ib, da, dw, np.inf, chunk=1 << 12,
                             device=CPU)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# dispatch-count / transfer-bytes contract
# ---------------------------------------------------------------------------


def test_dispatch_count_and_transfer_bytes_400k_day():
    """A 400k-event day at the default chunk: ceil(N/chunk) index-only
    H2D dispatches, survivors-only D2H, and a DispatchStats record equal
    to the JAX package's field by field."""
    n, chunk = 400_000, 1 << 16
    model, jmodel = _model(k=20, seed=15)
    ia, ib = _idx(model, n, seed=16)
    host = _batched_scores(model, ia, ib)
    threshold = float(np.quantile(host, 0.003))
    stats, jstats = DispatchStats(), JDispatchStats()
    order, scores = filtered_scores(model, ia, ib, threshold, chunk=chunk,
                                    stats=stats, device=CPU)
    j_order, _ = j_filtered(jmodel, ia, ib, threshold, chunk=chunk,
                            stats=jstats)
    n_chunks = -(-n // chunk)                     # 7
    assert stats.dispatches == stats.chunks == n_chunks
    assert stats.h2d_bytes == n_chunks * chunk * 4 * 2
    assert stats.survivors == len(order)
    assert stats.d2h_bytes < 0.02 * 8 * n
    assert stats.weight_h2d_bytes == 4 * (model.theta.size + model.p.size)
    np.testing.assert_array_equal(np.sort(order), np.sort(j_order))
    assert stats.as_record() == jstats.as_record()


def test_model_weights_transfer_once_per_swap():
    model, jmodel = _model(seed=17)
    ia, ib = _idx(model, 2000, seed=18)
    stats, jstats = DispatchStats(), JDispatchStats()
    for _ in range(2):
        filtered_scores(model, ia, ib, 1.0, chunk=512, stats=stats,
                        device=CPU)
        j_filtered(jmodel, ia, ib, 1.0, chunk=512, stats=jstats)
    chunked_scores(model, ia, ib, chunk=512, stats=stats, device=CPU)
    j_chunked(jmodel, ia, ib, chunk=512, stats=jstats)
    assert stats.weight_h2d_bytes == 4 * (model.theta.size + model.p.size)
    assert stats.events == 3 * 2000 and stats.chunks == 3 * 4
    assert stats.as_record() == jstats.as_record()


def test_small_input_shrinks_chunk():
    model, jmodel = _model(seed=19)
    ia, ib = _idx(model, 100, seed=20)
    stats, jstats = DispatchStats(), JDispatchStats()
    filtered_scores(model, ia, ib, np.inf, stats=stats, device=CPU)
    j_filtered(jmodel, ia, ib, np.inf, stats=jstats)
    assert stats.chunk == 128 and stats.h2d_bytes == 128 * 4 * 2
    assert stats.as_record() == jstats.as_record()


def test_index_out_of_range_raises():
    model, _ = _model(seed=29)
    ia, ib = _idx(model, 10, seed=30)
    ia[3] = model.theta.shape[0]
    with pytest.raises(IndexError):
        filtered_scores(model, ia, ib, 1.0, device=CPU)


# ---------------------------------------------------------------------------
# the chunk loop's analytic cost (roofline)
# ---------------------------------------------------------------------------


def _loop_record(entry, model, arrays, chunk):
    """Run one pipeline entry under a Recorder; -> its roofline record."""
    n0 = roofline.emit_count()
    with use_recorder(Recorder()):
        if entry == "full":
            chunked_scores(model, *arrays, chunk=chunk, device=CPU)
        elif entry == "filtered":
            filtered_scores(model, *arrays, np.inf, chunk=chunk, device=CPU)
        else:
            filtered_flow_scores(model, *arrays, np.inf, chunk=chunk,
                                 device=CPU)
    (rec,) = roofline.emitted_records(since=n0)
    return rec


@pytest.mark.parametrize("entry", ["full", "filtered", "flow"])
def test_chunk_loop_cost_counts_each_input_once(entry):
    """The chunk loop's count is the work its inputs need, whatever the
    chunking: two indices in and a K-term multiply-add per event and
    dot, theta and p read once over the loop (not once per event), the
    scores (or the counts and every survivor) out."""
    model, _ = _model(seed=23)
    n, k = 3000, model.theta.shape[1]
    dots = 2 if entry == "flow" else 1
    arrays = [a for i in range(dots) for a in _idx(model, n, seed=24 + i)]
    rows = model.theta.shape[0] + model.p.shape[0]
    for chunk in (256, 1000):
        rec = _loop_record(entry, model, arrays, chunk)
        nchunks = -(-n // chunk)
        out = (4.0 * n if entry == "full"
               else 4.0 * nchunks + (8 if dots == 1 else 16) * n)
        assert rec["count"] == "needed" and rec["dispatches"] == nchunks
        assert rec["flops"] == pytest.approx(dots * 2 * k * n, rel=1e-12)
        assert rec["bytes"] == pytest.approx(
            dots * 8 * n + 4 * k * rows + out, rel=1e-12)
        assert (rec["flops"], rec["bytes"]) == pytest.approx(
            pipeline.loop_cost(n, k, dots, rows, out), rel=1e-12)


def test_device_scores_is_one_dispatch_up_to_a_chunk():
    """device_scores runs the chunked pipeline: an input of at most one
    chunk is one dispatch padded to the next power of two, a larger one
    is chunked."""
    model, _ = _model(seed=25)
    ia, ib = _idx(model, 3000, seed=26)
    stats = DispatchStats()
    one = device_scores(model, ia, ib, stats=stats, device=CPU)
    assert (stats.dispatches, stats.chunk, stats.events) == (1, 4096, 3000)
    assert stats.h2d_bytes == 2 * 4 * 4096 and stats.d2h_bytes == 4 * 3000
    stats = DispatchStats()
    many = device_scores(model, ia, ib, chunk=1024, stats=stats, device=CPU)
    assert (stats.dispatches, stats.chunk) == (3, 1024)
    np.testing.assert_array_equal(one, many)


# ---------------------------------------------------------------------------
# the device engine through the public score_* wrappers
# ---------------------------------------------------------------------------


def _dns_day(n=300):
    from test_features import dns_row

    from oni_ml_tpu.features import featurize_dns as j_featurize_dns
    from oni_ml_tpu_torch.features import featurize_dns

    rng = np.random.default_rng(31)
    rows = [dns_row(ip=f"10.0.0.{int(rng.integers(0, 40))}")
            for _ in range(n)]
    feats = featurize_dns([list(r) for r in rows])
    jfeats = j_featurize_dns([list(r) for r in rows])
    uniq_ips = sorted({jfeats.client_ip(i) for i in range(n)})
    vocab = sorted(set(jfeats.word))
    k = 4
    theta = np.zeros((len(uniq_ips), k))
    for i in range(len(uniq_ips)):
        theta[i, i % k] = 2.0 ** -(i % 5)
    p = np.zeros((len(vocab), k))
    for j in range(len(vocab)):
        p[j] = 2.0 ** -(j % 3)
    return (feats, ScoringModel.from_results(uniq_ips, theta, vocab, p, 0.1),
            jfeats, JScoringModel.from_results(uniq_ips, theta, vocab, p,
                                               0.1))


def test_score_dns_device_engine_matches_host():
    """Power-of-two model: the device engine's rows equal the host
    engine's (exact scores in float32), and the JAX device engine's."""
    from oni_ml_tpu.scoring import score_dns as j_score_dns

    feats, model, jfeats, jmodel = _dns_day()
    host_rows, host_scores = score_dns(feats, model, threshold=np.inf)
    dev_rows, dev_scores = score_dns(feats, model, threshold=np.inf,
                                     engine="device", device=CPU)
    j_rows, j_scores = j_score_dns(jfeats, jmodel, threshold=np.inf,
                                   engine="device")
    assert dev_rows == host_rows == j_rows
    np.testing.assert_array_equal(dev_scores, host_scores)
    np.testing.assert_array_equal(dev_scores, j_scores)


def test_score_engine_rejects_unknown(monkeypatch):
    feats, model, _, _ = _dns_day(10)
    with pytest.raises(ValueError, match="engine"):
        score_dns(feats, model, threshold=1.0, engine="gpu")
    monkeypatch.setenv("ONI_ML_TPU_SCORE", "tpu")
    with pytest.raises(ValueError, match="engine"):
        score_dns(feats, model, threshold=1.0)


def test_default_engine_bytes_unchanged(monkeypatch):
    """With ONI_ML_TPU_SCORE unset the host float64 path runs: the CSV
    bytes equal engine="host"'s and the JAX host engine's.  With it set
    to device, the same call runs the pipeline (no card here: it
    raises rather than give way to the host engine)."""
    from oni_ml_tpu.scoring import score_dns_csv as j_score_dns_csv

    monkeypatch.delenv("ONI_ML_TPU_SCORE", raising=False)
    feats, model, jfeats, jmodel = _dns_day(50)
    blob_default, _ = score_dns_csv(feats, model, threshold=np.inf)
    blob_host, _ = score_dns_csv(feats, model, threshold=np.inf,
                                 engine="host")
    j_blob, _ = j_score_dns_csv(jfeats, jmodel, threshold=np.inf,
                                engine="host")
    assert blob_default == blob_host == j_blob
    monkeypatch.setenv("ONI_ML_TPU_SCORE", "device")
    stats = DispatchStats()
    blob_env, _ = score_dns_csv(feats, model, threshold=np.inf, stats=stats,
                                device=CPU)
    assert stats.dispatches == 1 and blob_env == blob_host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_dns_csv(feats, model, threshold=np.inf)


# ---------------------------------------------------------------------------
# the runner's score stage under ONI_ML_TPU_SCORE=device
# ---------------------------------------------------------------------------

RUNNER_DAYS = ("flow_golden", "dns_golden", "proxy")


def _day_inputs(day, root):
    if day == "flow_golden":
        return "flow", dict(flow_path=os.path.join(GOLDEN, "inputs",
                                                   "flow.csv"))
    if day == "dns_golden":
        return "dns", dict(
            dns_path=os.path.join(GOLDEN, "inputs", "dns.csv"),
            top_domains_path=os.path.join(GOLDEN, "inputs", "top1m.csv"))
    spec = jsources.get("proxy")
    path = root / "proxy.csv"
    path.write_text(",".join(spec.columns) + "\n"
                    + "\n".join(spec.synth_benign(2000, seed=9)) + "\n")
    return "proxy", dict(proxy_path=str(path))


def _rows(path):
    return path.read_text().splitlines()


@pytest.mark.parametrize("day", RUNNER_DAYS)
def test_runner_score_stage_device_engine(day, tmp_path, monkeypatch):
    """The port trains the day (CPU, 5 EM iterations); both runners then
    score it from the same doc_results.csv / word_results.csv with
    ONI_ML_TPU_SCORE=device, each from its own pre stage: the same
    events in the same order, featurized columns byte-equal, scores
    within rel 1e-6; the port's record names the engine and the
    DispatchStats, and a second port run with the
    variable unset writes the host engine's bytes."""
    dsource, paths = _day_inputs(day, tmp_path)
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "p.jsonl"))
    monkeypatch.delenv("ONI_ML_TPU_SCORE", raising=False)
    quiet = dict(emit=lambda *a, **k: None)
    ncols = 2 if dsource == "flow" else 1
    # Above every score: the host run keeps the whole day.
    cfg = PipelineConfig(data_dir=str(tmp_path / "port"),
                         lda=LDAConfig(num_topics=20, em_max_iters=5),
                         scoring=ScoringConfig(threshold=1.1), **paths)
    ml_ops.run_pipeline(cfg, FDATE, dsource, device=CPU, **quiet)
    port = tmp_path / "port" / FDATE
    host_rows = _rows(port / f"{dsource}_results.csv")
    jcfg = JPipelineConfig(
        data_dir=str(tmp_path / "jax"),
        telemetry=JTelemetryConfig(journal=False),
        dataplane=DataplaneConfig(enabled=False), **paths)
    jml_ops.run_pipeline(jcfg, FDATE, dsource, stages=[jml_ops.Stage.PRE])
    jday = tmp_path / "jax" / FDATE
    for name in ("doc_results.csv", "word_results.csv"):
        shutil.copy(port / name, jday / name)
    # The threshold: in the widest float32-safe gap near the median
    # score (min of the two for flow), so about half the day survives.
    tol = _gap_threshold(np.array(
        [min(float(x) for x in r.rsplit(",", ncols)[1:])
         for r in host_rows]))
    monkeypatch.setenv("ONI_ML_TPU_SCORE", "device")
    jml_ops.run_pipeline(
        dataclasses.replace(jcfg, scoring=JScoringConfig(threshold=tol)),
        FDATE, dsource, stages=[jml_ops.Stage.SCORE], force=True)
    out = ml_ops.run_pipeline(
        dataclasses.replace(cfg, scoring=ScoringConfig(threshold=tol)),
        FDATE, dsource, device=CPU, stages=[ml_ops.Stage.SCORE],
        force=True, **quiet)
    got = _rows(port / f"{dsource}_results.csv")
    want = _rows(jday / f"{dsource}_results.csv")
    assert 0 < len(got) == len(want) < len(host_rows)
    for g, w in zip(got, want):
        gc, wc = g.rsplit(",", ncols), w.rsplit(",", ncols)
        assert gc[0] == wc[0]
        np.testing.assert_allclose([float(x) for x in gc[1:]],
                                   [float(x) for x in wc[1:]], rtol=1e-6)
    recs = {r["stage"]: r for r in out.records}
    rec = recs["score"]
    assert rec["engine"] == "device"
    assert rec["score_dispatch"]["chunk"] == pipeline._effective_chunk(
        rec["scored_events"], pipeline.DEFAULT_CHUNK)
    assert rec["score_dispatch"]["events"] == rec["scored_events"]
    assert rec["score_dispatch"]["survivors"] == rec["flagged"] == len(got)
    # The chunk loop's roofline record: its analytic cost, no peaks on
    # the CPU.
    loop = [r for r in recs["roofline"]["records"]
            if r["phase"].startswith("score.device.")]
    assert len(loop) == 1 and loop[0]["cost_source"] == "analytic"
    assert loop[0]["count"] == "needed"
    assert loop[0]["utilization"] is None and loop[0]["bytes"] > 0
    monkeypatch.delenv("ONI_ML_TPU_SCORE")
    again = ml_ops.run_pipeline(
        cfg, FDATE, dsource, device=CPU, stages=[ml_ops.Stage.SCORE],
        force=True, **quiet)
    assert _rows(port / f"{dsource}_results.csv") == host_rows
    rec = {r["stage"]: r for r in again.records}["score"]
    assert rec["engine"] == "host" and "score_dispatch" not in rec
