"""The port's streaming dataplane (oni_ml_tpu_torch/dataplane/) against
the JAX package's, on the CPU: channel, column, builder, sink, task and
prep semantics; the streamed corpus equal to the batch one (and to the
JAX package's streamed corpus); and the contract the package keeps —
the port's dataplane day byte-identical to its --no-dataplane day and,
in the pre and corpus files, to the JAX package's default
(dataplane-on) day; --no-checkpoints products only, resume refused; a
failed background write fails the run.  Byte equality throughout: the
dataplane moves writes in time, never their bytes."""

import os
import pickle
import threading
import time

import numpy as np
import pytest

from oni_ml_tpu.config import (LDAConfig as JLDAConfig,
                               PipelineConfig as JPipelineConfig,
                               ScoringConfig as JScoringConfig,
                               TelemetryConfig as JTelemetryConfig)
from oni_ml_tpu.dataplane import (StreamingCorpusBuilder as
                                  JStreamingCorpusBuilder,
                                  intern_word_counts as jintern,
                                  word_count_columns as jword_count_columns)
from oni_ml_tpu.features.native_flow import (
    featurize_flow_file as jfeaturize_flow_file)
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu_torch import sources
from oni_ml_tpu_torch.config import (DataplaneConfig, FeedbackConfig,
                                     LDAConfig, PipelineConfig, ScoringConfig)
from oni_ml_tpu_torch.dataplane import (
    Channel, ChannelClosed, ChannelError, CheckpointSinks, Column, ColumnSet,
    Dataplane, StreamingCorpusBuilder, Task, atomic_write, atomic_write_bytes,
    build_scoring_prep, consume_corpus, intern_word_counts,
    stream_word_counts, word_count_columns)
from oni_ml_tpu_torch.features.flow import featurize_flow
from oni_ml_tpu_torch.features.native_flow import featurize_flow_file
from oni_ml_tpu_torch.io import Corpus, formats
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.runner.ml_ops import (MissingArtifactError, Stage,
                                            run_pipeline)
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.synth import write_dns_day
from oni_ml_tpu_torch.telemetry import Journal

from test_features import flow_row

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "inputs")
FDATE = "20160122"
QUIET = {"emit": lambda *a, **k: None}


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------


def test_channel_fifo_and_close():
    ch = Channel("t", capacity=8)
    for i in range(5):
        ch.put(i)
    ch.close()
    assert list(ch) == [0, 1, 2, 3, 4]
    with pytest.raises(ChannelClosed):
        ch.get()
    with pytest.raises(ValueError):
        ch.put(99)  # put after close is a producer bug


def test_channel_bounded_backpressure():
    """A producer runs at most `capacity` items ahead; its blocked put()
    is priced as a stall."""
    ch = Channel("t", capacity=2)
    done = threading.Event()

    def producer():
        for i in range(6):
            ch.put(i)
        ch.close()
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    assert not done.is_set()
    assert list(ch) == list(range(6))
    t.join()
    st = ch.stats()
    assert st["puts"] == 6 and st["gets"] == 6
    assert st["max_depth"] <= 2
    assert st["put_stall_s"] > 0


@pytest.mark.parametrize("side", ["producer", "consumer"])
def test_channel_failure_poisons_the_peer(side):
    """A producer's failure reaches the consumer after the buffered
    items; a consumer's failure unblocks a producer waiting in put()."""
    if side == "producer":
        ch = Channel("t", capacity=4)
        ch.put(1)
        ch.fail(RuntimeError("boom"))
        assert ch.get() == 1
        with pytest.raises(ChannelError, match="producer failed") as ei:
            ch.get()
        assert isinstance(ei.value.__cause__, RuntimeError)
        return
    ch = Channel("t", capacity=1)
    ch.put(0)
    errs = []

    def producer():
        try:
            ch.put(1)
        except ChannelError as e:
            errs.append(e)

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    ch.fail(RuntimeError("consumer died"))
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert len(errs) == 1 and "consumer failed" in str(errs[0])


def test_channel_many_producers_and_consumers_lose_nothing():
    """Stress: 16 producers and 4 consumers on a 3-deep channel, the
    interpreter switching threads every microsecond: every item arrives
    exactly once and the counts balance."""
    import sys

    ch = Channel("t", capacity=3)
    got, lock = [], threading.Lock()

    def producer(p):
        for i in range(500):
            ch.put((p, i))

    def consumer():
        for item in ch:
            with lock:
                got.append(item)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producers = [threading.Thread(target=producer, args=(p,))
                     for p in range(16)]
        consumers = [threading.Thread(target=consumer) for _ in range(4)]
        for t in producers + consumers:
            t.start()
        for t in producers:
            t.join(timeout=60)
        ch.close()
        for t in consumers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in producers + consumers)
    assert sorted(got) == [(p, i) for p in range(16) for i in range(500)]
    st = ch.stats()
    assert st["puts"] == st["gets"] == 8000 and st["max_depth"] <= 3


def test_channel_journals_depth_records(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    with Journal(jpath) as j:
        ch = Channel("pre.wc->corpus", capacity=4, journal=j)
        ch.put("a")
        ch.put("b")
        ch.get()
        ch.close()
    recs = [r for r in Journal.replay(jpath) if r["kind"] == "dataplane"]
    assert [(r["event"], r["side"], r["depth"]) for r in recs] == [
        ("depth", "put", 1), ("depth", "put", 2), ("depth", "get", 1)]
    assert all(r["edge"] == "pre.wc->corpus" for r in recs)


# ---------------------------------------------------------------------------
# Columns and streamed corpus assembly
# ---------------------------------------------------------------------------


def test_column_dtype_kind_and_columnset_validation():
    with pytest.raises(TypeError, match="declared dtype kind"):
        Column("doc_id", np.zeros(3, np.float64), "i")
    with pytest.raises(TypeError, match="1-D numpy array"):
        Column("doc_id", np.zeros((3, 2), np.int32), "i")
    with pytest.raises(ValueError, match="rows"):
        ColumnSet([Column("a", np.zeros(3, np.int32)),
                   Column("b", np.zeros(4, np.int32))])
    with pytest.raises(ValueError, match="duplicate"):
        ColumnSet([Column("a", np.zeros(3, np.int32)),
                   Column("a", np.zeros(3, np.int32))])
    cs = ColumnSet([Column("a", np.arange(10, dtype=np.int32))])
    chunks = list(cs.chunks(4))
    assert [c.num_rows for c in chunks] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate([c["a"] for c in chunks]),
                                  cs["a"])
    assert chunks[0]["a"].base is not None   # views, not copies
    with pytest.raises(ValueError, match="ragged"):
        StreamingCorpusBuilder().add_arrays(
            np.zeros(3, np.int32), np.zeros(2, np.int32),
            np.zeros(3, np.int64))


def _flow_csv(tmp_path, n=80, seed=11):
    rng = np.random.default_rng(seed)
    lines = ["dummy,header"]
    for _ in range(n):
        lines.append(flow_row(
            hour=int(rng.integers(0, 24)), minute=int(rng.integers(0, 60)),
            second=int(rng.integers(0, 60)),
            sip=f"10.0.0.{rng.integers(1, 12)}",
            dip=f"172.16.0.{rng.integers(1, 12)}",
            col10=str(rng.choice([80, 443, 55000, 0])),
            col11=str(rng.choice([80, 6000, 70000])),
            ipkt=str(rng.integers(1, 100)),
            ibyt=str(rng.integers(40, 10000)),
        ))
    raw = tmp_path / "flow.csv"
    raw.write_text("\n".join(lines) + "\n")
    return str(raw)


def _corpora_equal(a, b):
    assert a.doc_names == b.doc_names
    assert a.vocab == b.vocab
    np.testing.assert_array_equal(a.doc_ptr, b.doc_ptr)
    np.testing.assert_array_equal(a.word_idx, b.word_idx)
    np.testing.assert_array_equal(a.counts, b.counts)


def test_intern_word_counts_matches_jax_and_from_word_counts():
    triples = [("10.0.0.2", "w_b", 3), ("10.0.0.1", "w_a", 1),
               ("10.0.0.2", "w_a", 2), ("10.0.0.3", "w_c", 5),
               ("10.0.0.1", "w_b", 4)]
    wc, jwc = intern_word_counts(triples), jintern(triples)
    assert (wc.ip_table, wc.word_table) == (jwc.ip_table, jwc.word_table)
    for name in ("doc_id", "word_id", "count"):
        np.testing.assert_array_equal(wc.ids[name], jwc.ids[name])
    built = StreamingCorpusBuilder()
    built.add_arrays(wc.ids["doc_id"], wc.ids["word_id"], wc.ids["count"])
    _corpora_equal(built.finish(wc.ip_table, wc.word_table),
                   Corpus.from_word_counts(triples))


@pytest.mark.parametrize("chunk_rows", [1, 7, 64, 1 << 18])
def test_streamed_corpus_identical_to_batch_and_to_jax(tmp_path, chunk_rows):
    """First-seen order over a sequentially consumed chunk stream is
    first-seen order over the concatenation: the streamed corpus equals
    the container's to_corpus() and the JAX package's streamed corpus,
    whatever the chunking."""
    raw = _flow_csv(tmp_path)
    features = featurize_flow_file(raw)
    wc = word_count_columns(features)
    ch = Channel("e", capacity=2)
    t = threading.Thread(target=stream_word_counts, args=(wc, ch, chunk_rows))
    t.start()
    got, builder = consume_corpus(ch, wc.ip_table, wc.word_table)
    t.join()
    _corpora_equal(got, features.to_corpus())
    assert builder.rows == wc.ids.num_rows
    assert builder.chunks == -(-wc.ids.num_rows // chunk_rows)
    jwc = jword_count_columns(jfeaturize_flow_file(raw))
    jb = JStreamingCorpusBuilder()
    for chunk in jwc.ids.chunks(chunk_rows):
        jb.add(chunk)
    _corpora_equal(got, jb.finish(jwc.ip_table, jwc.word_table))


def test_streamed_corpus_matches_word_counts_file(tmp_path):
    features = featurize_flow_file(_flow_csv(tmp_path))
    path = str(tmp_path / "wc.dat")
    features.write_word_counts(path)
    wc = word_count_columns(features)
    builder = StreamingCorpusBuilder()
    for chunk in wc.ids.chunks(13):
        builder.add(chunk)
    _corpora_equal(builder.finish(wc.ip_table, wc.word_table),
                   Corpus.from_word_counts_file(path))


@pytest.mark.parametrize("kind", ["flow", "proxy"])
def test_python_container_columns(tmp_path, kind):
    """The Python containers (flow here; the proxy source's
    GenericFeatures) intern their word_counts() triples: the columnar
    hand-off builds their to_corpus()."""
    if kind == "flow":
        native = featurize_flow_file(_flow_csv(tmp_path))
        lines = ["h"] + [",".join(native.row(i))
                         for i in range(native.num_events)]
        features = featurize_flow(lines)
    else:
        spec = sources.get("proxy")
        features = spec.featurize(spec.synth_benign(400, seed=3))
    wc = word_count_columns(features)
    assert wc.ids.num_rows == len(features.word_counts())
    builder = StreamingCorpusBuilder()
    builder.add_arrays(wc.ids["doc_id"], wc.ids["word_id"], wc.ids["count"])
    _corpora_equal(builder.finish(wc.ip_table, wc.word_table),
                   Corpus.from_word_counts(features.word_counts()))


def test_consume_corpus_failure_poisons_channel(monkeypatch):
    """A consumer-side failure poisons the channel, so a producer blocked
    in put() unblocks with it instead of deadlocking the plane's drain."""
    ch = Channel("e", capacity=1)
    errs = []

    def producer():
        try:
            for _ in range(10):
                ch.put(ColumnSet([
                    Column("doc_id", np.zeros(2, np.int32)),
                    Column("word_id", np.zeros(2, np.int32)),
                    Column("count", np.ones(2, np.int64)),
                ]))
            ch.close()
        except ChannelError as e:
            errs.append(e)

    t = threading.Thread(target=producer)
    t.start()

    class Boom(Exception):
        pass

    def add(self, chunk):
        raise Boom("consumer died")

    monkeypatch.setattr(StreamingCorpusBuilder, "add", add)
    with pytest.raises(Boom):
        consume_corpus(ch, [], [])
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert errs and "consumer failed" in str(errs[0])


def test_corpus_save_atomic_and_select_match_jax(tmp_path):
    """Corpus.save (published by tmp+rename) writes the JAX package's
    save_atomic bytes, leaving no .tmp; Corpus.select is the JAX
    package's sub-corpus."""
    raw = _flow_csv(tmp_path)
    corpus = featurize_flow_file(raw).to_corpus()
    jcorpus = JCorpus.from_features(jfeaturize_flow_file(raw))
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    corpus.save(str(a))
    jcorpus.save_atomic(str(b))
    for name in ("words.dat", "doc.dat", "model.dat"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
        assert not (a / (name + ".tmp")).exists()
    pick = np.random.default_rng(2).permutation(corpus.num_docs)[:7]
    _corpora_equal(corpus.select(pick), jcorpus.select(pick))


# ---------------------------------------------------------------------------
# Scoring prep
# ---------------------------------------------------------------------------


def _scored_day(tmp_path, dsource):
    """(features, corpus, ScoringModel) of a small day: a random model
    over the corpus (the prep does not read the model's numbers)."""
    if dsource == "flow":
        features = featurize_flow_file(_flow_csv(tmp_path))
    elif dsource == "dns":
        path = tmp_path / "dns.csv"
        with open(path, "w") as f:
            write_dns_day(f, 500, n_clients=20, n_doms=30, seed=3)
        spec = sources.get("dns")
        features = spec.featurize(spec.read_input(str(path)))
    else:
        spec = sources.get("proxy")
        features = spec.featurize(spec.synth_benign(400, seed=3))
    corpus = features.to_corpus()
    rng = np.random.default_rng(4)
    gamma = rng.uniform(0.5, 3.0, size=(corpus.num_docs, 3))
    log_beta = np.log(rng.dirichlet(np.ones(corpus.num_terms), size=3))
    model = ScoringModel.from_lda(corpus.doc_names, gamma, corpus.vocab,
                                  log_beta, 0.05)
    return features, corpus, model


@pytest.mark.parametrize("dsource", ["flow", "dns", "proxy"])
def test_scoring_with_prep_is_the_inline_scoring(tmp_path, dsource):
    """The prep resolves the container's event_indices against the
    corpus orderings: the same index arrays as the inline resolution and
    the same results CSV bytes."""
    features, corpus, model = _scored_day(tmp_path, dsource)
    prep = build_scoring_prep(features, corpus.doc_names, corpus.vocab,
                              dsource)
    inline = features.event_indices(model.ip_index, model.word_index)
    assert prep.num_raw_events == features.num_raw_events
    assert len(prep.indices) == len(inline)
    for got, want in zip(prep.indices, inline):
        np.testing.assert_array_equal(got, want)
    spec = sources.get(dsource)
    blob, kept = spec.score_csv(features, model, 1.1, prep=prep)
    want_blob, want_kept = spec.score_csv(features, model, 1.1)
    assert blob == want_blob and len(blob) > 0
    np.testing.assert_array_equal(kept, want_kept)


def test_scoring_prep_mismatch_fails_loudly(tmp_path):
    features, corpus, model = _scored_day(tmp_path, "flow")
    spec = sources.get("flow")
    prep = build_scoring_prep(features, corpus.doc_names[:-1], corpus.vocab,
                              "flow")
    with pytest.raises(ValueError, match="different corpora"):
        spec.score_csv(features, model, 1.1, prep=prep)
    prep = build_scoring_prep(features, corpus.doc_names, corpus.vocab,
                              "flow")
    prep.dsource = "dns"
    with pytest.raises(ValueError, match="dsource"):
        spec.score_csv(features, model, 1.1, prep=prep)


# ---------------------------------------------------------------------------
# Sinks and tasks
# ---------------------------------------------------------------------------


def test_atomic_write_and_clear_stale(tmp_path):
    """atomic_write publishes only a complete file: a write that fails
    leaves the previous file under the name (clear_stale is gone: the
    runner removes a stage's stale outputs before the stage runs)."""
    p = str(tmp_path / "art.bin")
    atomic_write_bytes(p, b"hello")
    assert open(p, "rb").read() == b"hello"
    assert not os.path.exists(p + ".tmp")

    def broken(tmp):
        with open(tmp, "wb") as f:
            f.write(b"par")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        atomic_write(p, broken)
    assert open(p, "rb").read() == b"hello"


def test_checkpoint_sinks_report_errors(tmp_path):
    sinks = CheckpointSinks(workers=2)
    ok_path = str(tmp_path / "ok.bin")
    sinks.submit("good", lambda: atomic_write_bytes(ok_path, b"x"),
                 stage="pre")

    def bad():
        raise OSError("disk gone")

    sinks.submit("bad", bad, stage="lda")
    rows, errors = sinks.drain()
    sinks.close()
    assert rows["good"]["ok"] and rows["good"]["stage"] == "pre"
    assert not rows["bad"]["ok"] and "disk gone" in rows["bad"]["error"]
    assert len(errors) == 1 and errors[0][0] == "bad"
    assert os.path.exists(ok_path)


def test_task_result_reraises_and_stall_is_not_work():
    t = Task("boom", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(RuntimeError):
        t.result()
    assert t.consumed   # drain must not report it again
    ok = Task("fine", lambda: 42)
    assert ok.result() == 42 and ok.completion.ok
    plane = Dataplane(DataplaneConfig())
    plane.spawn("producer", lambda: time.sleep(0.2), stall=lambda: 0.15)
    rec = plane.drain()
    row = rec["tasks"]["producer"]
    assert row["stall_s"] == pytest.approx(0.15) and row["wall_s"] >= 0.2
    assert rec["background_wall_s"] == pytest.approx(row["wall_s"] - 0.15,
                                                     abs=0.02)
    assert plane.errors == []


def test_plane_without_checkpoints_writes_products_only(tmp_path):
    plane = Dataplane(DataplaneConfig(checkpoints=False))
    assert plane.checkpoint("c", lambda: atomic_write_bytes(
        str(tmp_path / "c"), b"c")) is None
    plane.output("o", lambda: atomic_write_bytes(str(tmp_path / "o"), b"o"))
    rec = plane.drain()
    assert rec["checkpoints"] is False and set(rec["tasks"]) == {"o"}
    assert sorted(os.listdir(tmp_path)) == ["o"]


# ---------------------------------------------------------------------------
# The day: byte identity, checkpoints off, fail-fast, resume refusal
# ---------------------------------------------------------------------------

ARTIFACTS = ["word_counts.dat", "words.dat", "doc.dat", "model.dat",
             "final.beta", "final.gamma", "final.other", "likelihood.dat",
             "doc_results.csv", "word_results.csv"]


def _day_cfg(root, dsource="flow", **dp):
    """A small day of `dsource` under `root`, K 4, 6 EM iterations."""
    if dsource == "flow":
        rng = np.random.default_rng(7)
        lines = ["dummy,header"] + [flow_row(
            hour=int(rng.integers(0, 24)), minute=int(rng.integers(0, 60)),
            second=int(rng.integers(0, 60)),
            sip=f"10.0.0.{rng.integers(1, 9)}",
            dip=f"172.16.0.{rng.integers(1, 9)}",
            col10=str(rng.choice([80, 443, 55000, 0])),
            col11=str(rng.choice([80, 6000, 70000])),
            ipkt=str(rng.integers(1, 100)),
            ibyt=str(rng.integers(40, 10000))) for _ in range(60)]
        raw = os.path.join(str(root), "flow.csv")
        with open(raw, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths = {"flow_path": raw}
    elif dsource == "dns":
        paths = {"dns_path": os.path.join(GOLDEN, "dns.csv"),
                 "top_domains_path": os.path.join(GOLDEN, "top1m.csv")}
    else:
        spec = sources.get("proxy")
        raw = os.path.join(str(root), "proxy.csv")
        with open(raw, "w") as f:
            f.write(",".join(spec.columns) + "\n"
                    + "\n".join(spec.synth_benign(600, seed=9)) + "\n")
        paths = {"proxy_path": raw}
    return PipelineConfig(
        data_dir=str(root),
        lda=LDAConfig(num_topics=4, em_max_iters=6, batch_size=32,
                      min_bucket_len=16, seed=3),
        feedback=FeedbackConfig(dup_factor=5),
        scoring=ScoringConfig(threshold=1.1),
        dataplane=DataplaneConfig(**dp), **paths)


@pytest.mark.parametrize("dsource", ["flow", "dns", "proxy"])
def test_dataplane_day_byte_identical_to_serial(tmp_path, dsource):
    """Dataplane on (the default) against --no-dataplane: every artifact
    the same bytes (features.pkl names its day's spill, so it is compared
    by content); the dataplane day handed everything off in memory and
    its record names every background write and task."""
    plane_root, serial_root = tmp_path / "plane", tmp_path / "serial"
    plane_root.mkdir(), serial_root.mkdir()
    plane = run_pipeline(_day_cfg(plane_root, dsource), FDATE, dsource,
                         device="cpu", **QUIET)
    serial = run_pipeline(_day_cfg(serial_root, dsource, enabled=False),
                          FDATE, dsource, device="cpu", **QUIET)
    p_day, s_day = plane_root / FDATE, serial_root / FDATE
    for name in ARTIFACTS + [f"{dsource}_results.csv"]:
        assert (p_day / name).read_bytes() == (s_day / name).read_bytes(), \
            name
    assert not [n for n in os.listdir(p_day) if n.endswith(".tmp")]
    pf = ml_ops._PortUnpickler(open(p_day / "features.pkl", "rb")).load()
    sf = ml_ops._PortUnpickler(open(s_day / "features.pkl", "rb")).load()
    assert pf.word_counts() == sf.word_counts()
    by = {r["stage"]: r for r in plane.records}
    assert by["score"]["features"] == by["score"]["model"] == "handoff"
    assert by["score"]["prep"] == "overlapped"
    assert by["lda"]["corpus"] == "handoff"
    assert by["corpus"]["stream"]["chunks"] >= 1
    assert by["pre"]["pickle"] == by["pre"]["wc_write"] == "background"
    s_by = {r["stage"]: r for r in serial.records}
    assert s_by["score"]["prep"] == "inline" and "dataplane" not in s_by
    assert set(by["dataplane"]["tasks"]) == {
        "features_pkl", "word_counts", "corpus_dat", "final_model",
        "doc_results", "word_results", "results_csv", "wc_stream",
        "score_prep"}
    assert all(t["ok"] for t in by["dataplane"]["tasks"].values())
    assert "pre.wc->corpus" in by["dataplane"]["edges"]


def test_golden_flow_day_matches_jax_dataplane_day(tmp_path, monkeypatch):
    """The port's default day against the JAX package's default
    (dataplane-on) day over the golden flow input: the pre and corpus
    files byte for byte."""
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "p.jsonl"))
    flow = os.path.join(GOLDEN, "flow.csv")
    jml_ops.run_pipeline(JPipelineConfig(
        data_dir=str(tmp_path / "jax"), flow_path=flow,
        lda=JLDAConfig(num_topics=4, em_max_iters=3),
        scoring=JScoringConfig(threshold=1.1),
        telemetry=JTelemetryConfig(journal=False)), FDATE, "flow")
    run_pipeline(PipelineConfig(
        data_dir=str(tmp_path / "port"), flow_path=flow,
        lda=LDAConfig(num_topics=4, em_max_iters=3),
        scoring=ScoringConfig(threshold=1.1)), FDATE, "flow", device="cpu",
        **QUIET)
    for name in ("word_counts.dat", "words.dat", "doc.dat", "model.dat"):
        assert (tmp_path / "port" / FDATE / name).read_bytes() == \
            (tmp_path / "jax" / FDATE / name).read_bytes(), name


def test_no_checkpoints_products_only_and_resume_refused(tmp_path):
    """--no-checkpoints: only the products land (results CSV,
    metrics.json, run_journal.jsonl; the native spill is removed at the
    end), the results are the serial day's bytes; a later resume is
    refused naming the file and the provenance, and leaves the day as it
    was."""
    cfg = _day_cfg(tmp_path, checkpoints=False)
    run_pipeline(cfg, FDATE, "flow", device="cpu", **QUIET)
    day = tmp_path / FDATE
    assert sorted(os.listdir(day)) == ["flow_results.csv", "metrics.json",
                                       "run_journal.jsonl"]
    serial = tmp_path / "serial"
    serial.mkdir()
    run_pipeline(_day_cfg(serial, enabled=False), FDATE, "flow",
                 device="cpu", **QUIET)
    results = (day / "flow_results.csv").read_bytes()
    assert results == (serial / FDATE / "flow_results.csv").read_bytes()
    recs = Journal.replay(str(day / "run_journal.jsonl"))
    assert recs[0]["kind"] == "run_start" and recs[0]["checkpoints"] is False
    resume = PipelineConfig(data_dir=cfg.data_dir, flow_path=cfg.flow_path,
                            lda=cfg.lda, feedback=cfg.feedback,
                            scoring=cfg.scoring)
    for stages, name in (([Stage.LDA], "model.dat"),
                         ([Stage.SCORE], "features.pkl")):
        with pytest.raises(MissingArtifactError) as ei:
            run_pipeline(resume, FDATE, "flow", device="cpu", stages=stages,
                         force=True, **QUIET)
        msg = str(ei.value)
        assert name in msg and "--no-checkpoints" in msg and "refused" in msg
        assert (day / "flow_results.csv").read_bytes() == results


@pytest.mark.parametrize("case", ["no_dataplane", "stages", "online",
                                  "holdout", "online_holdout",
                                  "quality_holdout"])
def test_mode_refusals_match_jax(tmp_path, case):
    """The combinations the JAX runner refuses, with its messages."""
    dp = {"checkpoints": case in ("online_holdout", "quality_holdout")}
    if case == "no_dataplane":
        dp["enabled"] = False
    kw = {"stages": [Stage.PRE]} if case == "stages" else {}
    kw.update({"online": case in ("online", "online_holdout"),
               "eval_holdout": 0.2 if "holdout" in case else 0.0,
               "eval_quality": case == "quality_holdout"})
    jdp = jml_ops.DataplaneConfig(**dp)
    with pytest.raises(ValueError) as want:
        jml_ops.run_pipeline(JPipelineConfig(data_dir=str(tmp_path / "j"),
                                             dataplane=jdp), FDATE, "flow",
                             **kw)
    with pytest.raises(ValueError) as got:
        run_pipeline(PipelineConfig(data_dir=str(tmp_path / "p"),
                                    dataplane=DataplaneConfig(**dp)),
                     FDATE, "flow", device="cpu", **kw, **QUIET)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stage,artifact", [
    (Stage.CORPUS, "word_counts.dat"),
    (Stage.LDA, "model.dat"),
    (Stage.SCORE, "features.pkl"),
])
def test_stages_fail_fast_naming_the_missing_file(tmp_path, stage, artifact):
    with pytest.raises(MissingArtifactError) as ei:
        run_pipeline(_day_cfg(tmp_path), FDATE, "flow", device="cpu",
                     stages=[stage], **QUIET)
    msg = str(ei.value)
    assert artifact in msg and "--stages" in msg and "--force" in msg
    assert "--no-checkpoints" not in msg


def test_split_run_over_the_dataplane_day_files(tmp_path):
    """A --stages run reads the files the dataplane wrote in the
    background: the same bytes as the one-shot day."""
    full, staged = tmp_path / "full", tmp_path / "staged"
    full.mkdir(), staged.mkdir()
    run_pipeline(_day_cfg(full), FDATE, "flow", device="cpu", **QUIET)
    cfg = _day_cfg(staged)
    for stage in STAGES:
        recs = {r["stage"]: r for r in run_pipeline(
            cfg, FDATE, "flow", device="cpu", stages=[stage], **QUIET).records}
    assert recs["score"]["features"] == recs["score"]["model"] == "file"
    assert recs["score"]["prep"] == "inline"
    for name in ARTIFACTS + ["flow_results.csv"]:
        assert (staged / FDATE / name).read_bytes() == \
            (full / FDATE / name).read_bytes(), name


STAGES = [Stage.PRE, Stage.CORPUS, Stage.LDA, Stage.SCORE]


@pytest.mark.parametrize("sink", ["word_counts", "final_model"])
def test_failed_background_write_fails_the_run(tmp_path, monkeypatch, sink):
    """A background checkpoint write that fails fails the run
    (RuntimeError naming the sink) after the other writes joined, and
    the journal's run_end says so."""
    def boom(*a, **k):
        raise OSError("disk full")

    if sink == "word_counts":
        from oni_ml_tpu_torch.features.native_flow import InternedCounts

        monkeypatch.setattr(InternedCounts, "write_word_counts", boom)
    else:
        monkeypatch.setattr(formats, "write_gamma", boom)
    with pytest.raises(RuntimeError, match=sink) as ei:
        run_pipeline(_day_cfg(tmp_path), FDATE, "flow", device="cpu", **QUIET)
    assert isinstance(ei.value.__cause__, OSError)
    day = tmp_path / FDATE
    assert (day / "flow_results.csv").exists()   # the other writes landed
    ends = [r for r in Journal.replay(str(day / "run_journal.jsonl"))
            if r["kind"] == "run_end"]
    assert len(ends) == 1 and not ends[0]["ok"] and "disk full" in \
        ends[0]["error"]


def test_journal_carries_the_dataplane_records(tmp_path):
    run_pipeline(_day_cfg(tmp_path), FDATE, "flow", device="cpu", **QUIET)
    records = Journal.replay(str(tmp_path / FDATE / "run_journal.jsonl"))
    dp = [r for r in records if r.get("kind") == "dataplane"]
    assert {r["event"] for r in dp} == {"depth", "task", "edge"}
    assert {"wc_stream", "score_prep", "features_pkl", "corpus_dat",
            "results_csv"} <= {r["name"] for r in dp if r["event"] == "task"}
    edges = [r for r in dp if r["event"] == "edge"]
    assert len(edges) == 1 and edges[0]["edge"] == "pre.wc->corpus"
    spans = {r["name"] for r in records if r.get("kind") == "span"}
    assert {"dataplane.task.score_prep", "dataplane.task.wc_stream",
            "dataplane.checkpoint.features_pkl",
            "dataplane.prep_join"} <= spans


def test_features_pickle_round_trips_from_the_background_sink(tmp_path):
    """features.pkl written by the background sink loads through the
    port's unpickler into the day's container."""
    run = run_pipeline(_day_cfg(tmp_path), FDATE, "flow", device="cpu",
                       **QUIET)
    with open(tmp_path / FDATE / "features.pkl", "rb") as f:
        loaded = ml_ops._PortUnpickler(f).load()
    assert pickle.dumps(loaded.word_counts()) == \
        pickle.dumps(run.features.word_counts())
