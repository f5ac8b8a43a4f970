"""The port's native host path (oni_ml_tpu_torch/native_src, built by
native_build.py) against the JAX package's native path and against the
port's own pure-Python path, on the golden days and on seeded fuzz days:
every id array, table and cut equal, every emitted file byte-identical.
Then the emitters and the ingest alone, the qtiles file, the runner's
days native against ONI_ML_TPU_NO_NATIVE=1, a resumed score stage over
raw_lines.bin, and a failed build, which raises."""

import json
import os
import shutil

import numpy as np
import pytest

from oni_ml_tpu import native_emit as jemit
from oni_ml_tpu.features import native_dns as jnative_dns
from oni_ml_tpu.features import native_flow as jnative_flow
from oni_ml_tpu.features import qtiles as jqtiles
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.io import native as jnative_io
from oni_ml_tpu.scoring import score as jscore
from oni_ml_tpu_torch import native_build, native_emit
from oni_ml_tpu_torch.features import dns as pydns
from oni_ml_tpu_torch.features import flow as pyflow
from oni_ml_tpu_torch.features import native_dns, native_flow, qtiles
from oni_ml_tpu_torch.features.blob import MmapBlob
from oni_ml_tpu_torch.features.container import csv_blob
from oni_ml_tpu_torch.features.dns import load_top_domains
from oni_ml_tpu_torch.io import Corpus, formats
from oni_ml_tpu_torch.io import native as native_io
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.scoring import score

from test_native_fuzz import _write_fuzz_dns_csv, _write_fuzz_flow_csv

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the native host path needs g++")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inputs")
TOP = os.path.join(GOLDEN, "top1m.csv")
FDATE = "20160122"
FLOW_ARRAYS = ("line_off", "sip_id", "dip_id", "wp_id", "sw_id", "dw_id",
               "num_time", "ibyt_bin", "ipkt_bin", "time_bin", "wc_ip",
               "wc_word", "wc_count", "time_cuts", "ibyt_cuts", "ipkt_cuts")
DNS_ARRAYS = ("row_off", "ip_id", "dom_id", "sub_id", "word_id",
              "subdomain_length", "num_periods", "subdomain_entropy",
              "top_domain", "wc_ip", "wc_word", "wc_count", "time_cuts",
              "frame_length_cuts", "subdomain_length_cuts", "entropy_cuts",
              "numperiods_cuts")
FLOW_TABLES = ("ip_table", "word_table")
DNS_TABLES = ("ip_table", "domain_table", "subdomain_table", "word_table")


def _flow_day(tmp_path, kind: str, seed: int = 0) -> str:
    if kind == "golden":
        return os.path.join(GOLDEN, "flow.csv")
    path = tmp_path / f"flow_{seed}.csv"
    _write_fuzz_flow_csv(np.random.default_rng(seed), path)
    return str(path)


def _dns_day(tmp_path, kind: str, seed: int = 0) -> str:
    if kind == "golden":
        return os.path.join(GOLDEN, "dns.csv")
    path = tmp_path / f"dns_{seed}.csv"
    _write_fuzz_dns_csv(np.random.default_rng(seed), path)
    return str(path)


def _assert_same_container(port, ref, arrays, tables, blob):
    for name in arrays:
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in tables:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.num_raw_events == ref.num_raw_events
    assert bytes(getattr(port, blob)[:]) == bytes(getattr(ref, blob)[:])


DAYS = [("golden", 0), ("fuzz", 11), ("fuzz", 12), ("fuzz", 13)]
FEEDBACK = [",".join([f"fb{i}"] + ["2"] * 26) for i in range(3)] * 2


# ---------------------------------------------------------------------------
# Port native against JAX native
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed", DAYS)
@pytest.mark.parametrize("workers", [1, 3])
def test_flow_native_matches_jax_native(tmp_path, kind, seed, workers):
    path = _flow_day(tmp_path, kind, seed)
    timings = {}
    port = native_flow.featurize_flow_file(
        path, feedback_rows=FEEDBACK, workers=workers, timings=timings,
        spill_path=str(tmp_path / "port.bin"))
    ref = jnative_flow.featurize_flow_file(
        path, feedback_rows=FEEDBACK, workers=workers,
        spill_path=str(tmp_path / "ref.bin"))
    assert isinstance(port, native_flow.NativeFlowFeatures)
    assert isinstance(ref, jnative_flow.NativeFlowFeatures)
    assert timings["pre_engine"] == "native"
    assert {"parse_s", "cuts_s", "word_build_s", "merge_s"} <= set(timings)
    _assert_same_container(port, ref, FLOW_ARRAYS, FLOW_TABLES, "lines_blob")
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    assert native_emit.word_counts_emit(port) == jemit.word_counts_emit(ref)


@pytest.mark.parametrize("kind,seed", DAYS)
@pytest.mark.parametrize("workers", [1, 3])
def test_dns_native_matches_jax_native(tmp_path, kind, seed, workers):
    path = _dns_day(tmp_path, kind, seed)
    top = load_top_domains(TOP)
    fb = [["t", "1454058786", "120", "10.9.9.9", "www.evil.com", "1", "1",
           "0"]] * 3
    timings = {}
    port = native_dns.featurize_dns_sources(
        [path], top_domains=top, feedback_rows=fb, workers=workers,
        timings=timings, spill_path=str(tmp_path / "port.bin"))
    ref = jnative_dns.featurize_dns_sources(
        [path], top_domains=top, feedback_rows=fb, workers=workers,
        spill_path=str(tmp_path / "ref.bin"))
    assert isinstance(port, native_dns.NativeDnsFeatures)
    assert isinstance(ref, jnative_dns.NativeDnsFeatures)
    assert timings["pre_engine"] == "native"
    _assert_same_container(port, ref, DNS_ARRAYS, DNS_TABLES, "rows_blob")
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    assert native_emit.word_counts_emit(port) == jemit.word_counts_emit(ref)


# ---------------------------------------------------------------------------
# Port native against port Python
# ---------------------------------------------------------------------------


def _assert_flow_like(nat, py):
    assert nat.num_events == py.num_events
    assert nat.num_raw_events == py.num_raw_events
    for name in ("num_time", "ibyt_bin", "ipkt_bin", "time_bin",
                 "time_cuts", "ibyt_cuts", "ipkt_cuts"):
        np.testing.assert_array_equal(getattr(nat, name), getattr(py, name),
                                      err_msg=name)
    for name in ("rows", "word_port", "ip_pair", "src_word", "dest_word"):
        assert getattr(nat, name) == getattr(py, name), name
    assert nat.word_counts() == py.word_counts()
    assert [nat.featurized_row(i) for i in range(nat.num_events)] == \
        [py.featurized_row(i) for i in range(py.num_events)]


def _assert_dns_like(nat, py):
    assert nat.num_events == py.num_events
    assert nat.num_raw_events == py.num_raw_events
    for name in ("subdomain_length", "num_periods", "subdomain_entropy",
                 "top_domain", "time_cuts", "frame_length_cuts",
                 "subdomain_length_cuts", "entropy_cuts", "numperiods_cuts"):
        np.testing.assert_array_equal(getattr(nat, name), getattr(py, name),
                                      err_msg=name)
    for name in ("rows", "domain", "subdomain", "word"):
        assert getattr(nat, name) == getattr(py, name), name
    assert nat.word_counts() == py.word_counts()
    assert [nat.featurized_row(i) for i in range(nat.num_events)] == \
        [py.featurized_row(i) for i in range(py.num_events)]


@pytest.mark.parametrize("kind,seed", DAYS)
def test_flow_native_matches_port_python(tmp_path, monkeypatch, kind, seed):
    path = _flow_day(tmp_path, kind, seed)
    nat = native_flow.featurize_flow_file(path, feedback_rows=FEEDBACK)
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    timings = {}
    py = native_flow.featurize_flow_file(path, feedback_rows=FEEDBACK,
                                         timings=timings)
    assert isinstance(py, pyflow.FlowFeatures)
    assert timings["pre_engine"] == "python"
    _assert_flow_like(nat, py)
    monkeypatch.delenv("ONI_ML_TPU_NO_NATIVE")
    wc = tmp_path / "wc.dat"
    formats.write_word_counts(str(wc), py.word_counts())
    assert native_emit.word_counts_emit(nat) == wc.read_bytes()


@pytest.mark.parametrize("kind,seed", DAYS)
def test_dns_native_matches_port_python(tmp_path, monkeypatch, kind, seed):
    path = _dns_day(tmp_path, kind, seed)
    top = load_top_domains(TOP)
    nat = native_dns.featurize_dns_sources([path], top_domains=top)
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    py = native_dns.featurize_dns_sources([path], top_domains=top)
    assert isinstance(py, pydns.DnsFeatures)
    _assert_dns_like(nat, py)
    monkeypatch.delenv("ONI_ML_TPU_NO_NATIVE")
    wc = tmp_path / "wc.dat"
    formats.write_word_counts(str(wc), py.word_counts())
    assert native_emit.word_counts_emit(nat) == wc.read_bytes()


@pytest.mark.parametrize("case", ["csv_separator", "row_newline",
                                  "row_surrogate"])
def test_dns_transport_bytes_take_python_with_a_reason(tmp_path, case):
    """A day whose fields embed a transport byte runs the Python path with
    the library present, says why, removes the native pass's partial
    spill, and gives the JAX package's output."""
    golden = [line.split(",") for line in
              open(os.path.join(GOLDEN, "dns.csv")).read().splitlines()]
    if case == "csv_separator":
        path = tmp_path / "sep.csv"
        lines = [",".join(r) for r in golden]
        lines[0] = lines[0].replace(".com", "\x1f.com", 1)
        assert "\x1f" in lines[0]
        path.write_text("\n".join(lines) + "\n")
        sources = [str(path)]
    else:
        rows = [list(r) for r in golden]
        rows[2][4] = ("a\nb.example.com" if case == "row_newline"
                      else "a\udcffb.example.com")
        sources = [rows]
    timings = {}
    spill = tmp_path / "spill.bin"
    port = native_dns.featurize_dns_sources(sources, timings=timings,
                                            spill_path=str(spill))
    ref = jnative_dns.featurize_dns_sources(sources)
    assert not spill.exists()   # the native pass's partial spill is gone
    assert timings["pre_engine"] == "python"
    assert timings["python_reason"] == (
        native_dns.CSV_UNSAFE if case == "csv_separator"
        else native_dns.ROWS_UNSAFE)
    assert isinstance(port, pydns.DnsFeatures)
    assert port.rows == ref.rows and port.word == ref.word
    assert port.word_counts() == ref.word_counts()


# ---------------------------------------------------------------------------
# Emitters and ingest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flow_pair(tmp_path_factory):
    """(port native, JAX native) featurized fuzz flow day, no spill."""
    tmp = tmp_path_factory.mktemp("flow_pair")
    path = _flow_day(tmp, "fuzz", 21)
    return (native_flow.featurize_flow_file(path),
            jnative_flow.featurize_flow_file(path))


@pytest.fixture(scope="module")
def dns_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dns_pair")
    path = _dns_day(tmp, "fuzz", 22)
    top = load_top_domains(TOP)
    return (native_dns.featurize_dns_sources([path], top_domains=top),
            jnative_dns.featurize_dns_sources([path], top_domains=top))


def _random_scores(n, seed):
    rng = np.random.default_rng(seed)
    scores = rng.random(n) * np.exp(rng.uniform(-40, 0, n))
    return scores


def test_flow_emit_matches_jax_and_python(flow_pair, tmp_path, monkeypatch):
    """native_emit.flow_emit (the native container's results_csv) against
    the JAX package's and against the Python container's results_csv on
    the same day."""
    port, ref = flow_pair
    n = port.num_raw_events
    src, dest = _random_scores(n, 1), _random_scores(n, 2)
    order = np.argsort(np.minimum(src, dest), kind="stable")[: n // 2]
    got = native_emit.flow_emit(port, src, dest, order)
    assert got == jemit.flow_emit(ref, src, dest, order)
    assert got == port.results_csv(src, dest, order)
    rows = [",".join(port.featurized_row(i) + [str(src[i]), str(dest[i])])
            for i in order]
    assert got == csv_blob(rows)
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    py = native_flow.featurize_flow_file(_flow_day(tmp_path, "fuzz", 21))
    assert isinstance(py, pyflow.FlowFeatures)
    assert py.results_csv(src, dest, order) == got


def test_dns_emit_matches_jax_and_python(dns_pair, tmp_path, monkeypatch):
    port, ref = dns_pair
    n = port.num_raw_events
    scores = _random_scores(n, 3)
    order = np.argsort(scores, kind="stable")[: n // 2]
    got = native_emit.dns_emit(port, scores, order)
    assert got == jemit.dns_emit(ref, scores, order)
    assert got == port.results_csv(scores, order)
    rows = [",".join(port.featurized_row(i) + [str(scores[i])])
            for i in order]
    assert got == csv_blob(rows)
    assert port.results_rows(scores, order) == rows
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    py = native_dns.featurize_dns_sources([_dns_day(tmp_path, "fuzz", 22)],
                                          top_domains=load_top_domains(TOP))
    assert isinstance(py, pydns.DnsFeatures)
    assert py.results_csv(scores, order) == got
    assert py.results_rows(scores, order) == rows


@pytest.mark.parametrize("seed", [0, 1])
def test_model_emit_matches_jax_and_python(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, 40)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    widx = rng.integers(0, 3000, int(ptr[-1])).astype(np.int32)
    cnts = rng.integers(1, 10**6, int(ptr[-1])).astype(np.int32)
    got = native_emit.model_emit(ptr, widx, cnts)
    assert got == jemit.model_emit(ptr, widx, cnts)
    formats.write_model_dat(str(tmp_path / "native.dat"), ptr, widx, cnts)
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    formats.write_model_dat(str(tmp_path / "python.dat"), ptr, widx, cnts)
    assert (tmp_path / "native.dat").read_bytes() == got == \
        (tmp_path / "python.dat").read_bytes()
    monkeypatch.delenv("ONI_ML_TPU_NO_NATIVE")
    assert native_emit.model_emit(np.zeros(1, np.int64), widx[:0],
                                  cnts[:0]) == b""
    with pytest.raises(ValueError, match="inconsistent"):
        native_emit.model_emit(np.array([0, 5, 3]), widx[:5], cnts[:5])


def test_word_counts_emit_matches_python(flow_pair, dns_pair, tmp_path):
    """word_counts_emit (the native container's write_word_counts)
    against the Python writer over its triples and the JAX package's."""
    for port, ref in (flow_pair, dns_pair):
        wc, emitted = tmp_path / "wc.dat", tmp_path / "emitted.dat"
        formats.write_word_counts(str(wc), port.word_counts())
        assert port.write_word_counts(str(emitted)) == len(port.wc_ip)
        assert native_emit.word_counts_emit(port) == wc.read_bytes() == \
            emitted.read_bytes() == jemit.word_counts_emit(ref)


@pytest.mark.parametrize("k", [1, 7, 20])
def test_score_dot_matches_jax_and_numpy(monkeypatch, k):
    rng = np.random.default_rng(k)
    theta, p = rng.random((50, k)), rng.random((300, k))
    ip = rng.integers(0, 50, 5000)
    w = rng.integers(0, 300, 5000).astype(np.int32)
    got = native_emit.score_dot(theta, p, ip, w)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jemit.score_dot(theta, p, ip, w))
    model = score.ScoringModel({}, theta, {}, p)
    np.testing.assert_array_equal(score._batched_scores(model, ip, w), got)
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    np.testing.assert_array_equal(score._batched_scores(model, ip, w), got)
    np.testing.assert_array_equal(
        got, jscore._batched_scores(jscore.ScoringModel({}, theta, {}, p),
                                    ip, w))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("bad", ["neg_ip", "big_ip", "neg_word", "big_word",
                                 "wrap_2_32"])
def test_score_dot_range_errors(monkeypatch, native, bad):
    """The host engine raises IndexError on an index outside the model's
    rows with either path, as the JAX package's does."""
    if not native:
        monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    theta, p = np.ones((4, 3)), np.ones((6, 3))
    ip, w = np.array([0, 1, 2], np.int64), np.array([0, 1, 5], np.int64)
    if bad == "neg_ip":
        ip[1] = -1
    elif bad == "big_ip":
        ip[1] = 4
    elif bad == "neg_word":
        w[2] = -1
    elif bad == "big_word":
        w[2] = 6
    else:
        ip[0] = 2**32
    model = score.ScoringModel({}, theta, {}, p)
    with pytest.raises(IndexError, match="out of range"):
        score._batched_scores(model, ip, w)
    with pytest.raises(IndexError, match="out of range"):
        jscore._batched_scores(jscore.ScoringModel({}, theta, {}, p), ip, w)
    if native:
        with pytest.raises(ValueError, match="length mismatch"):
            native_emit.score_dot(theta, p, ip[:2], w)
        with pytest.raises(ValueError, match="K mismatch"):
            native_emit.score_dot(theta, p[:, :2], ip, w)


@pytest.mark.parametrize("kind", ["flow", "dns", "hostile"])
def test_load_corpus_matches_jax_and_python(tmp_path, monkeypatch, kind,
                                            flow_pair, dns_pair):
    """io/native.load_corpus (Corpus.from_word_counts_file) against the
    JAX package's native ingest and the port's Python reader; several
    files concatenate."""
    if kind == "hostile":
        paths = [tmp_path / "a.dat", tmp_path / "b.dat"]
        paths[0].write_bytes(b"10.0.0.1,w1,3\n\n10.0.0\xff,w\xfe2,1\n")
        paths[1].write_bytes(b"10.0.0.1,w1,7\r\n10.0.0.2,w3,2")
        paths = [str(p) for p in paths]
    else:
        feats = (flow_pair if kind == "flow" else dns_pair)[0]
        paths = [str(tmp_path / "wc.dat")]
        with open(paths[0], "wb") as f:
            f.write(native_emit.word_counts_emit(feats))
    got = native_io.load_corpus(paths)
    ref = jnative_io.load_corpus(paths)
    triples = [t for p in paths for t in formats.read_word_counts(p)]
    py = Corpus.from_word_counts(triples)
    for other in (ref, py):
        assert got.doc_names == other.doc_names
        assert got.vocab == other.vocab
        for name in ("doc_ptr", "word_idx", "counts"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(other, name))
            assert getattr(got, name).dtype == getattr(other, name).dtype
    if kind != "hostile":
        direct = Corpus.from_features(feats)
        np.testing.assert_array_equal(direct.word_idx, got.word_idx)
        assert direct.vocab == got.vocab and direct.doc_names == got.doc_names
        monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
        viapy = Corpus.from_word_counts_file(paths[0])
        np.testing.assert_array_equal(viapy.counts, got.counts)
        assert viapy.vocab == got.vocab


def test_load_corpus_malformed_raises(tmp_path):
    bad = tmp_path / "bad.dat"
    bad.write_bytes(b"10.0.0.1,w1,notanumber\n")
    with pytest.raises(ValueError, match="bad.dat"):
        native_io.load_corpus(str(bad))


def test_from_features_equals_jax(flow_pair, dns_pair):
    for port, ref in (flow_pair, dns_pair):
        got, want = Corpus.from_features(port), JCorpus.from_features(ref)
        assert got.doc_names == want.doc_names and got.vocab == want.vocab
        for name in ("doc_ptr", "word_idx", "counts"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


# ---------------------------------------------------------------------------
# Scoring: index resolution and the results CSVs
# ---------------------------------------------------------------------------


def _model_for(features, seed, k=5):
    corpus = Corpus.from_features(features)
    rng = np.random.default_rng(seed)
    docs, vocab = corpus.doc_names, corpus.vocab
    # Leave some IPs and words out: their events take the fallback row.
    docs, vocab = docs[: max(1, len(docs) - 3)], vocab[: max(1, len(vocab) - 5)]
    dt = rng.random((len(docs), k))
    wt = rng.random((len(vocab), k)) * 1e-3
    return (score.ScoringModel.from_results(docs, dt / dt.sum(1)[:, None],
                                            vocab, wt, 0.05),
            jscore.ScoringModel.from_results(docs, dt / dt.sum(1)[:, None],
                                             vocab, wt, 0.05))


def test_event_indices_native_match_jax_and_python(tmp_path, monkeypatch,
                                                   flow_pair, dns_pair):
    """Per-unique resolution over the interned ids gives the JAX package's
    index arrays (int32, the device engine's operand type) and the port's
    Python containers' arrays."""
    path_f = _flow_day(tmp_path, "fuzz", 21)
    path_d = _dns_day(tmp_path, "fuzz", 22)
    top = load_top_domains(TOP)
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    py_f = native_flow.featurize_flow_file(path_f)
    py_d = native_dns.featurize_dns_sources([path_d], top_domains=top)
    monkeypatch.delenv("ONI_ML_TPU_NO_NATIVE")
    for (port, ref), py, jfn in (
            (flow_pair, py_f, jscore.flow_event_indices),
            (dns_pair, py_d, jscore.dns_event_indices)):
        model, jmodel = _model_for(port, 5)
        got = port.event_indices(model.ip_index, model.word_index)
        want = jfn(ref, jmodel.ip_index, jmodel.word_index)
        from_py = py.event_indices(model.ip_index, model.word_index)
        assert len(got) == len(want) == len(from_py)
        for a, b, c in zip(got, want, from_py):
            assert a.dtype == np.int32 and c.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        # The IPs and words left out of the model take the fallback rows.
        assert any((a == len(model.ip_index)).any() for a in got[0::2])
        assert any((a == len(model.word_index)).any() for a in got[1::2])


@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_results_csv_native_matches_jax_and_python(tmp_path, monkeypatch,
                                                   flow_pair, dns_pair,
                                                   dsource):
    if dsource == "flow":
        (port, ref), fn, jfn = (flow_pair, score.score_flow_csv,
                                jscore.score_flow_csv)
        path = _flow_day(tmp_path, "fuzz", 21)
    else:
        (port, ref), fn, jfn = (dns_pair, score.score_dns_csv,
                                jscore.score_dns_csv)
        path = _dns_day(tmp_path, "fuzz", 22)
    model, jmodel = _model_for(port, 9)
    blob, scores = fn(port, model, 1e-4)
    jblob, jscores = jfn(ref, jmodel, 1e-4)
    assert blob and blob == jblob
    np.testing.assert_array_equal(scores, jscores)
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    py = (native_flow.featurize_flow_file(path) if dsource == "flow" else
          native_dns.featurize_dns_sources([path],
                                           top_domains=load_top_domains(TOP)))
    pblob, pscores = fn(py, model, 1e-4)
    assert pblob == blob
    np.testing.assert_array_equal(pscores, scores)


# ---------------------------------------------------------------------------
# qtiles
# ---------------------------------------------------------------------------


def test_qtiles_round_trip_and_jax_cuts(tmp_path, capsys):
    path = os.path.join(GOLDEN, "flow.csv")
    out = tmp_path / "flow_qtiles"
    assert qtiles.main([path, str(out)]) == 0
    jout = tmp_path / "jax_qtiles"
    assert jqtiles.main([path, str(jout)]) == 0
    assert out.read_bytes() == jout.read_bytes()
    cuts = qtiles.read_flow_qtiles(str(out))
    for a, b in zip(cuts, jqtiles.read_flow_qtiles(str(jout))):
        np.testing.assert_array_equal(a, b)
    again = tmp_path / "again"
    qtiles.write_flow_qtiles(str(again), *cuts)
    assert again.read_bytes() == out.read_bytes()
    feats = native_flow.featurize_flow_file(path)
    for a, b in zip(cuts, (feats.time_cuts, feats.ibyt_cuts,
                           feats.ipkt_cuts)):
        np.testing.assert_array_equal(a, b)
    assert qtiles.main([]) == 2
    assert qtiles.main(["--help"]) == 0
    bad = tmp_path / "bad"
    bad.write_text("1 2,3\n")
    with pytest.raises(ValueError, match="3 comma-separated"):
        qtiles.read_flow_qtiles(str(bad))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_qtiles_flag_pins_the_cuts(tmp_path, capsys, monkeypatch, native):
    """--qtiles: the day is cut at the file's cuts (here another day's),
    the JAX package's featurizer at the same cuts gives the same word
    counts, and native and Python agree."""
    other = tmp_path / "other.csv"
    _write_fuzz_flow_csv(np.random.default_rng(3), other)
    qfile = tmp_path / "q"
    qtiles.main([str(other), str(qfile)])
    capsys.readouterr()
    if not native:
        monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    path = os.path.join(GOLDEN, "flow.csv")
    rc = ml_ops.main([FDATE, "flow", "1.1", "--flow-path", path,
                      "--data-dir", str(tmp_path / "d"), "--device", "cpu",
                      "--em-max-iters", "2", "--qtiles", str(qfile),
                      "--stages", "pre"])
    assert rc == 0
    day = tmp_path / "d" / FDATE
    cuts = jqtiles.read_flow_qtiles(str(qfile))
    ref = jnative_flow.featurize_flow_file(path, precomputed_cuts=cuts)
    wc = tmp_path / "ref_wc.dat"
    formats.write_word_counts(str(wc), ref.word_counts())
    assert (day / "word_counts.dat").read_bytes() == wc.read_bytes()
    unpinned = jnative_flow.featurize_flow_file(path)
    assert unpinned.word_counts() != ref.word_counts()


# ---------------------------------------------------------------------------
# The runner: native against ONI_ML_TPU_NO_NATIVE=1
# ---------------------------------------------------------------------------


def _day_argv(dsource, data, *extra):
    paths = {"flow": ["--flow-path", os.path.join(GOLDEN, "flow.csv")],
             "dns": ["--dns-path", os.path.join(GOLDEN, "dns.csv"),
                     "--top-domains", TOP]}[dsource]
    return [FDATE, dsource, "1.1", "--data-dir", str(data), "--device",
            "cpu", "--em-max-iters", "4", *paths, *extra]


def _run(argv, capsys):
    rc = ml_ops.main(argv)
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    return rc, {r["stage"]: r for r in out if "stage" in r}, out


NOT_PINNED = ("features.pkl", "metrics.json", "run_journal.jsonl",
              ml_ops.SPILL)


@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_runner_native_matches_python(tmp_path, capsys, monkeypatch,
                                      dsource):
    rc, recs, _ = _run(_day_argv(dsource, tmp_path / "nat"), capsys)
    assert rc == 0
    pre = recs["pre"]
    assert pre["pre_engine"] == "native"
    assert pre["pre_workers_source"] == "default"
    assert pre["pre_workers"] == max(1, os.cpu_count() or 1)
    for key in ("parse_s", "cuts_s", "word_build_s", "merge_s"):
        assert pre[key] >= 0, key
    # The dataplane (the default) writes both pre files in the background.
    assert pre["pickle"] == pre["wc_write"] == "background"
    assert recs["corpus"]["handoff"] == "direct"
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    rc, precs, _ = _run(_day_argv(dsource, tmp_path / "py",
                                  "--no-dataplane"), capsys)
    assert rc == 0
    assert precs["pre"]["pre_engine"] == "python"
    for key in ("wc_emit_s", "pickle_s"):
        assert precs["pre"][key] >= 0, key
    nat, py = tmp_path / "nat" / FDATE, tmp_path / "py" / FDATE
    assert (nat / ml_ops.SPILL).exists() and not (py / ml_ops.SPILL).exists()
    names = sorted(n for n in os.listdir(nat) if n not in NOT_PINNED)
    assert names == sorted(set(ml_ops.artifacts(dsource)) - {"features.pkl"})
    for name in names:
        assert (nat / name).read_bytes() == (py / name).read_bytes(), name


@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_resumed_score_reads_the_spill(tmp_path, capsys, dsource):
    """--stages score in a new process: features.pkl names raw_lines.bin
    (MmapBlob, loaded through the port's unpickler) and the results are
    the one-shot run's bytes, in place and after the day directory
    moved; a missing or resized spill fails fast naming the file and
    `--stages pre --force`."""
    rc, _, _ = _run(_day_argv(dsource, tmp_path / "a"), capsys)
    assert rc == 0
    results = f"{dsource}_results.csv"
    one = (tmp_path / "a" / FDATE / results).read_bytes()
    feats = ml_ops._PortUnpickler(
        open(tmp_path / "a" / FDATE / "features.pkl", "rb")).load()
    blob = feats.lines_blob if dsource == "flow" else feats.rows_blob
    assert isinstance(blob, MmapBlob)
    assert blob.path == str(tmp_path / "a" / FDATE / ml_ops.SPILL)
    rc, recs, _ = _run(_day_argv(dsource, tmp_path / "a", "--stages",
                                 "score", "--force"), capsys)
    assert rc == 0 and recs["score"]["features"] == "file"
    assert (tmp_path / "a" / FDATE / results).read_bytes() == one
    os.rename(tmp_path / "a", tmp_path / "b")
    rc, _, _ = _run(_day_argv(dsource, tmp_path / "b", "--stages", "score",
                              "--force"), capsys)
    assert rc == 0
    assert (tmp_path / "b" / FDATE / results).read_bytes() == one
    spill = tmp_path / "b" / FDATE / ml_ops.SPILL
    with open(spill, "ab") as f:
        f.write(b"stale")
    rc, _, out = _run(_day_argv(dsource, tmp_path / "b", "--stages",
                                "score", "--force"), capsys)
    assert rc == 2 and out[-1]["error"] == "missing_artifact"
    assert "spill of another run" in out[-1]["detail"]
    spill.unlink()
    rc, _, out = _run(_day_argv(dsource, tmp_path / "b", "--stages",
                                "score", "--force"), capsys)
    assert rc == 2
    assert f"needs {ml_ops.SPILL}" in out[-1]["detail"]
    assert f"`ml_ops {FDATE} {dsource} --stages pre --force`" in \
        out[-1]["detail"]


@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_copied_day_reads_its_own_spill(tmp_path, capsys, dsource):
    """A day directory copied while the original still exists scores
    against the copy's raw_lines.bin, not the path features.pkl recorded:
    the original's spill may be rewritten (here: the same size, other
    bytes) and the copy's results stay the one-shot run's."""
    rc, _, _ = _run(_day_argv(dsource, tmp_path / "a"), capsys)
    assert rc == 0
    results = f"{dsource}_results.csv"
    one = (tmp_path / "a" / FDATE / results).read_bytes()
    shutil.copytree(tmp_path / "a", tmp_path / "c")
    orig = tmp_path / "a" / FDATE / ml_ops.SPILL
    orig.write_bytes(b"x" * orig.stat().st_size)
    rc, recs, _ = _run(_day_argv(dsource, tmp_path / "c", "--stages",
                                 "score", "--force"), capsys)
    assert rc == 0 and recs["score"]["features"] == "file"
    assert (tmp_path / "c" / FDATE / results).read_bytes() == one
    # With no spill of its own, the copy falls back to the recorded path.
    (tmp_path / "c" / FDATE / ml_ops.SPILL).unlink()
    rc, _, _ = _run(_day_argv(dsource, tmp_path / "c", "--stages",
                              "score", "--force"), capsys)
    assert rc == 0
    assert (tmp_path / "c" / FDATE / results).read_bytes() != one


def test_pre_rerun_replaces_the_spill(tmp_path, capsys, monkeypatch):
    """A run of pre removes the old raw_lines.bin first: a Python-path
    rerun leaves none behind for a later resume to misread."""
    assert _run(_day_argv("flow", tmp_path, "--stages", "pre"), capsys)[0] == 0
    assert (tmp_path / FDATE / ml_ops.SPILL).exists()
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    assert _run(_day_argv("flow", tmp_path, "--stages", "pre", "--force"),
                capsys)[0] == 0
    assert not (tmp_path / FDATE / ml_ops.SPILL).exists()


# ---------------------------------------------------------------------------
# No silent fallback
# ---------------------------------------------------------------------------


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(native_build.SRC_DIR, src)
    with open(src / "flow_featurize.cpp", "a") as f:
        f.write("\nthis is not C++ at all;\n")
    monkeypatch.setattr(native_build, "SRC_DIR", str(src))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_flow, "_LIB",
                        native_build.NativeLib("flow", native_flow._configure))
    with pytest.raises(RuntimeError) as err:
        native_flow.featurize_flow_file(os.path.join(GOLDEN, "flow.csv"))
    msg = str(err.value)
    assert "g++ failed for native_src/flow_featurize.cpp" in msg
    assert "libonitorch_flow-" in msg and "error" in msg
    assert not any(p.endswith(".so") for p in os.listdir(tmp_path / "build"))


def test_missing_symbol_raises(monkeypatch):
    def configure(lib):
        native_flow._configure(lib)
        lib.no_such_symbol.restype = None

    lib = native_build.NativeLib("flow", configure)
    with pytest.raises(RuntimeError, match="failed to load or configure"):
        lib.load()


def test_no_native_switch_builds_nothing(tmp_path, monkeypatch):
    """Under ONI_ML_TPU_NO_NATIVE=1 the featurizers, the model.dat writer,
    the word-count reader and the gather-dot all take their Python
    branches: no library is built or loaded."""
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    for mod in (native_flow, native_dns, native_emit, native_io):
        monkeypatch.setattr(mod, "_LIB",
                            native_build.NativeLib(mod._LIB.name,
                                                   mod._LIB._configure))
    lib = native_build.NativeLib("emit", native_emit._configure)
    assert lib.load_enabled() is None
    assert not native_build.enabled()
    feats = native_flow.featurize_flow_file(os.path.join(GOLDEN, "flow.csv"))
    assert isinstance(feats, pyflow.FlowFeatures)
    feats.write_word_counts(str(tmp_path / "wc.dat"))
    corpus = Corpus.from_word_counts_file(str(tmp_path / "wc.dat"))
    formats.write_model_dat(str(tmp_path / "model.dat"), corpus.doc_ptr,
                            corpus.word_idx, corpus.counts)
    model = score.ScoringModel({}, np.ones((2, 3)), {}, np.ones((2, 3)))
    score._batched_scores(model, np.zeros(4, np.int32), np.ones(4, np.int32))
    assert not (tmp_path / "build").exists()
    for mod in (native_flow, native_dns, native_emit, native_io):
        assert mod._LIB._lib is None


def test_mmap_blob_round_trips(tmp_path):
    """spill_bytes -> MmapBlob: slices and length as the bytes', a pickle
    of the path and size only, an empty file, and the JAX package's
    bytes for the same spill."""
    import pickle

    from oni_ml_tpu.features.blob import spill_bytes as jspill
    from oni_ml_tpu_torch.features.blob import spill_bytes

    data = bytes(range(256)) * 3
    blob = spill_bytes(data, str(tmp_path / "b.bin"))
    jspill(data, str(tmp_path / "j.bin"))
    assert (tmp_path / "b.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert len(blob) == len(data) and blob[5:300] == data[5:300]
    state = pickle.dumps(blob)
    assert data not in state and len(state) < 200
    again = pickle.loads(state)
    assert again.size == len(data) and again[:] == data
    empty = spill_bytes(b"", str(tmp_path / "e.bin"))
    assert len(empty) == 0 and empty.as_c_char_p() == b""


def test_bytes_at_and_narrow_counts():
    buf = __import__("ctypes").create_string_buffer(b"abc\x00def", 7)
    assert native_build.bytes_at(__import__("ctypes").addressof(buf), 7) == \
        b"abc\x00def"
    assert native_build.bytes_at(None, 0) == b""
    with pytest.raises(MemoryError):
        native_build.bytes_at(None, 3)
    ok = native_build.narrow_counts_i32(np.array([1, 2**31 - 1], np.int64))
    assert ok.dtype == np.int32
    with pytest.raises(OverflowError):
        native_build.narrow_counts_i32(np.array([2**31], np.int64))
