"""The port's sharded pre stage: the worker count resolution (config,
the host's cores), and workers 1, 2 and 4 writing the same bytes on the
native featurizers (which shard each file) and on the Python ones (which
read sequentially at any count), on hostile inputs (CRLF ends across
shard boundaries, header copies inside shards, feedback after the merge,
the spill file, several files), through the runner too; and the corpus
hand-off of each kind of container."""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from oni_ml_tpu_torch.features import native_dns, native_flow
from oni_ml_tpu_torch.features.shards import resolve_pre_workers
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.runner import ml_ops

from test_native_fuzz import _write_fuzz_dns_csv, _write_fuzz_flow_csv

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the native featurizers need g++")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inputs")
FDATE = "20160122"
WORKERS = (2, 4)


def _wc_bytes(features, tmp_path, tag):
    """word_counts.dat's bytes as the pre stage writes them."""
    p = tmp_path / f"wc_{tag}.dat"
    features.write_word_counts(str(p))
    return p.read_bytes()


def _assert_flow_identical(a, b, tmp_path):
    assert type(a) is type(b)
    assert a.num_events == b.num_events
    assert a.num_raw_events == b.num_raw_events
    for name in ("num_time", "ibyt_bin", "ipkt_bin", "time_bin",
                 "time_cuts", "ibyt_cuts", "ipkt_cuts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if isinstance(a, native_flow.NativeFlowFeatures):
        for name in ("line_off", "sip_id", "dip_id", "wp_id", "sw_id",
                     "dw_id", "wc_ip", "wc_word", "wc_count"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.ip_table == b.ip_table and a.word_table == b.word_table
    assert a.src_word == b.src_word and a.dest_word == b.dest_word
    assert a.rows == b.rows
    assert _wc_bytes(a, tmp_path, "a") == _wc_bytes(b, tmp_path, "b")


def _assert_dns_identical(a, b, tmp_path):
    assert type(a) is type(b)
    assert a.num_events == b.num_events
    for name in ("subdomain_entropy", "subdomain_length", "num_periods",
                 "top_domain", "time_cuts", "entropy_cuts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if isinstance(a, native_dns.NativeDnsFeatures):
        for name in ("row_off", "ip_id", "dom_id", "sub_id", "word_id",
                     "wc_ip", "wc_word", "wc_count"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.word_table == b.word_table
    assert a.rows == b.rows and a.word == b.word
    assert _wc_bytes(a, tmp_path, "a") == _wc_bytes(b, tmp_path, "b")


# ---------------------------------------------------------------------------
# Worker count
# ---------------------------------------------------------------------------


def test_resolve_pre_workers():
    """0 = auto: one worker per host core; N = N from config; negative
    raises."""
    cores = max(1, os.cpu_count() or 1)
    assert resolve_pre_workers(1) == 1
    assert resolve_pre_workers(5, with_source=True) == (5, "config")
    assert resolve_pre_workers(0, with_source=True) == (cores, "default")
    assert resolve_pre_workers(0) == cores
    with pytest.raises(ValueError):
        resolve_pre_workers(-1)


# ---------------------------------------------------------------------------
# Workers 1, 2, 4: the same bytes
# ---------------------------------------------------------------------------


def _crlf_day(path):
    rows = ["header,row"]
    for i in range(101):
        rows.append(",".join([f"f{i}_{j}" * (1 + (i + j) % 3)
                              for j in range(5)] + ["x"] * 22))
    path.write_bytes(("\r\n".join(rows) + "\r\n").encode())


def _header_day(path):
    header = ",".join(f"h{j}" for j in range(27))
    lines = [header]
    for i in range(60):
        lines.append(",".join([f"r{i}"] + ["1"] * 26))
        if i % 7 == 0:
            lines.append(header)
    path.write_text("\n".join(lines) + "\n")


FLOW_CASES = ["golden", "fuzz", "crlf", "header_mid_shard", "multi_file"]


def _flow_spec(tmp_path, case):
    if case == "golden":
        return os.path.join(GOLDEN, "flow.csv")
    if case == "crlf":
        _crlf_day(tmp_path / "crlf.csv")
        return str(tmp_path / "crlf.csv")
    if case == "header_mid_shard":
        _header_day(tmp_path / "hdr.csv")
        return str(tmp_path / "hdr.csv")
    rng = np.random.default_rng(900 if case == "fuzz" else 55)
    paths = []
    for d in range(1 if case == "fuzz" else 3):
        p = tmp_path / f"day{d}.csv"
        _write_fuzz_flow_csv(rng, p)
        paths.append(str(p))
    return ",".join(paths)


@needs_gxx
@pytest.mark.parametrize("case", FLOW_CASES)
def test_flow_native_workers_same_bytes(tmp_path, case):
    spec = _flow_spec(tmp_path, case)
    fb = [",".join([f"fb{i}"] + ["2"] * 26) for i in range(4)] * 3
    seq = native_flow.featurize_flow_file(
        spec, feedback_rows=fb, workers=1, spill_path=str(tmp_path / "1.bin"))
    assert isinstance(seq, native_flow.NativeFlowFeatures)
    if case == "header_mid_shard":
        assert seq.num_raw_events == 60   # every header copy dropped
    assert seq.num_events == seq.num_raw_events + len(fb)
    for w in WORKERS:
        par = native_flow.featurize_flow_file(
            spec, feedback_rows=fb, workers=w,
            spill_path=str(tmp_path / f"{w}.bin"))
        _assert_flow_identical(par, seq, tmp_path)
        assert (tmp_path / f"{w}.bin").read_bytes() == \
            (tmp_path / "1.bin").read_bytes()


@needs_gxx
@pytest.mark.parametrize("case", ["golden", "fuzz", "crlf"])
def test_dns_native_workers_same_bytes(tmp_path, case):
    if case == "golden":
        path = os.path.join(GOLDEN, "dns.csv")
    else:
        path = str(tmp_path / "dns.csv")
        _write_fuzz_dns_csv(np.random.default_rng(950), tmp_path / "dns.csv")
        if case == "crlf":
            data = (tmp_path / "dns.csv").read_bytes()
            (tmp_path / "dns.csv").write_bytes(data.replace(b"\n", b"\r\n"))
    seq = native_dns.featurize_dns_sources(
        [path], workers=1, spill_path=str(tmp_path / "1.bin"))
    assert isinstance(seq, native_dns.NativeDnsFeatures)
    for w in WORKERS:
        par = native_dns.featurize_dns_sources(
            [path], workers=w, spill_path=str(tmp_path / f"{w}.bin"))
        _assert_dns_identical(par, seq, tmp_path)
        assert (tmp_path / f"{w}.bin").read_bytes() == \
            (tmp_path / "1.bin").read_bytes()


@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_python_path_workers_same_bytes(tmp_path, monkeypatch, dsource):
    """ONI_ML_TPU_NO_NATIVE=1: the Python featurizers read each file in
    one sequential pass at any worker count, so workers never change a
    byte."""
    monkeypatch.setenv("ONI_ML_TPU_NO_NATIVE", "1")
    rng = np.random.default_rng(400)
    path = tmp_path / f"{dsource}.csv"
    if dsource == "flow":
        _write_fuzz_flow_csv(rng, path)
        runs = {w: native_flow.featurize_flow_file(str(path), workers=w)
                for w in (1, *WORKERS)}
        check = _assert_flow_identical
    else:
        _write_fuzz_dns_csv(rng, path)
        runs = {w: native_dns.featurize_dns_sources([str(path)], workers=w)
                for w in (1, *WORKERS)}
        check = _assert_dns_identical
    assert not isinstance(runs[1], (native_flow.NativeFlowFeatures,
                                    native_dns.NativeDnsFeatures))
    for w in WORKERS:
        check(runs[w], runs[1], tmp_path)


# ---------------------------------------------------------------------------
# The corpus hand-off
# ---------------------------------------------------------------------------


@needs_gxx
@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_from_features_equals_file_parse(tmp_path, dsource):
    rng = np.random.default_rng(600)
    path = tmp_path / "d.csv"
    if dsource == "flow":
        _write_fuzz_flow_csv(rng, path)
        feats = native_flow.featurize_flow_file(str(path), workers=2)
    else:
        _write_fuzz_dns_csv(rng, path)
        feats = native_dns.featurize_dns_sources([str(path)], workers=2)
    wc = tmp_path / "wc.dat"
    assert feats.write_word_counts(str(wc)) == len(feats.wc_ip)
    via_file = Corpus.from_word_counts_file(str(wc))
    direct = Corpus.from_features(feats)
    assert direct.doc_names == via_file.doc_names
    assert direct.vocab == via_file.vocab
    for name in ("doc_ptr", "word_idx", "counts"):
        np.testing.assert_array_equal(getattr(direct, name),
                                      getattr(via_file, name))


def test_from_features_python_container_and_empty(tmp_path):
    """A Python container's corpus is that of its triples, whether or not
    write_word_counts ran first (its triples are kept for that one
    to_corpus call and never pickled); the interned CSR of no counts is
    the empty corpus."""
    from oni_ml_tpu_torch.features.flow import featurize_flow

    lines = ["h"] + [
        ",".join([f"r{i}", "1", "1", str(i % 24), "0", "0"] + ["1"] * 21)
        for i in range(20)]
    feats = featurize_flow(iter(lines))
    ref = Corpus.from_word_counts(feats.word_counts())
    cold = Corpus.from_features(feats)
    assert feats.write_word_counts(str(tmp_path / "wc.dat")) == \
        len(feats.word_counts())
    assert pickle.loads(pickle.dumps(feats)).__dict__.keys() == \
        {k for k in feats.__dict__ if k != "_word_count_triples"}
    direct = Corpus.from_features(feats)
    assert "_word_count_triples" not in feats.__dict__
    for got in (cold, direct):
        assert got.doc_names == ref.doc_names and got.vocab == ref.vocab
        np.testing.assert_array_equal(got.word_idx, ref.word_idx)
        np.testing.assert_array_equal(got.counts, ref.counts)

    empty = np.zeros(0, np.int32)
    c = Corpus.from_interned([], [], empty, empty, empty)
    assert c.num_docs == 0 and c.num_terms == 0 and c.num_tokens == 0


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dsource", ["flow", "dns"])
def test_runner_pre_workers_same_bytes(tmp_path, capsys, dsource):
    """--pre-workers 1 and 4 write every artifact byte for byte alike;
    the pre record names the count and its source."""
    raw = {"flow": ["--flow-path", os.path.join(GOLDEN, "flow.csv")],
           "dns": ["--dns-path", os.path.join(GOLDEN, "dns.csv")]}[dsource]
    recs = {}
    for w in (1, 4):
        rc = ml_ops.main([FDATE, dsource, "1.1", "--data-dir",
                          str(tmp_path / str(w)), "--device", "cpu",
                          "--em-max-iters", "3", "--pre-workers", str(w),
                          *raw])
        assert rc == 0
        out = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
        recs[w] = {r["stage"]: r for r in out}["pre"]
        assert recs[w]["pre_workers"] == w
        assert recs[w]["pre_workers_source"] == "config"
    a, b = tmp_path / "1" / FDATE, tmp_path / "4" / FDATE
    for name in [*ml_ops.artifacts(dsource), ml_ops.SPILL]:
        if name == "features.pkl" or not (a / name).exists():
            continue
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
