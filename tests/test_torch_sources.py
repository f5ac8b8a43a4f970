"""The port's source registry against the JAX package's, on the CPU:
the registered names and their order, duplicate registration refused,
each spec's synthetic benign day and features identical to the JAX
spec's (the proxy TableSourceSpec's words, bins, cuts and word counts
included), each container resolved to its spec, the pre-stage hook and
the proxy scorer byte-identical, the declaration round trip, and the
parquet input's error without pyarrow."""

import os
import sys

import numpy as np
import pytest
import torch

from oni_ml_tpu import sources as jsources
from oni_ml_tpu.config import FeedbackConfig as JFeedbackConfig
from oni_ml_tpu.config import PipelineConfig as JPipelineConfig
from oni_ml_tpu.config import ScoringConfig as JScoringConfig
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.sources import builtin as jbuiltin
from oni_ml_tpu_torch import sources
from oni_ml_tpu_torch.config import (FeedbackConfig, PipelineConfig,
                                     ScoringConfig)
from oni_ml_tpu_torch.scoring import ScoringModel
from oni_ml_tpu_torch.sources import builtin

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NAMES = ("flow", "dns", "proxy")


def test_registry_names_and_lookup():
    assert sources.names() == NAMES
    for name in NAMES:
        spec = sources.get(name)
        ref = jsources.get(name)
        assert (spec.name, spec.num_columns, spec.header_probe_col) == (
            ref.name, ref.num_columns, ref.header_probe_col)
        assert spec.fallback(ScoringConfig()) == ref.fallback(
            JScoringConfig())
    with pytest.raises(ValueError, match="unknown source 'netflow'"):
        sources.get("netflow")


def test_registry_rejects_duplicate_and_unnamed():
    with pytest.raises(ValueError, match="already registered"):
        sources.register(sources.DnsSource())
    with pytest.raises(ValueError, match="no name"):
        sources.register(sources.SourceSpec())
    assert sources.names() == NAMES
    # replace=True swaps the spec in place, keeping the order.
    spec = sources.get("dns")
    assert sources.register(sources.DnsSource(), replace=True).name == "dns"
    sources.register(spec, replace=True)
    assert sources.names() == NAMES and sources.get("dns") is spec


def _features(name, n=60, seed=1):
    lines = jsources.get(name).synth_benign(n, seed=seed)
    port = sources.get(name).featurize(lines)
    ref = jsources.get(name).featurize(lines)
    return port, ref


@pytest.mark.parametrize("name", NAMES)
def test_synth_benign_days_match_reference(name):
    assert sources.get(name).synth_benign(80, seed=3) == \
        jsources.get(name).synth_benign(80, seed=3)


@pytest.mark.parametrize("name", NAMES)
def test_featurize_matches_reference(name):
    """The spec's featurizer on its benign day (the proxy's is
    tests/test_sources.py's input): the same words and word counts as
    the JAX spec's."""
    port, ref = _features(name)
    assert port.num_raw_events == ref.num_raw_events
    assert port.word_counts() == ref.word_counts()
    for i in range(port.num_events):
        assert port.featurized_row(i) == ref.featurized_row(i)


def test_proxy_featurize_matches_reference():
    """ProxySource on synth_benign rows: words, per-field bins, cuts and
    rows identical to the JAX spec's; a header line and rows of the
    wrong width dropped, feedback rows trained but not raw."""
    spec, ref = sources.get("proxy"), jsources.get("proxy")
    lines = ref.synth_benign(120, seed=7)
    header = ",".join(spec.columns)
    feedback = [lines[0], "too,few,columns"]
    events = [header] + lines + ["short,row"]
    port = spec.featurize(events, skip_header=True, feedback_rows=feedback)
    jref = ref.featurize(events, skip_header=True, feedback_rows=feedback)
    assert port.num_raw_events == jref.num_raw_events == 120
    assert port.num_events == jref.num_events == 121
    assert port.word == jref.word and port.rows == jref.rows
    assert sorted(port.bins) == sorted(jref.bins)
    for name in port.bins:
        np.testing.assert_array_equal(port.bins[name], jref.bins[name])
    assert len(port.cuts) == len(jref.cuts) == 3
    for a, b in zip(port.cuts, jref.cuts):
        np.testing.assert_array_equal(a, b)
    again = spec.featurize(lines[:10], precomputed_cuts=port.cuts)
    assert again.word == port.word[:10]


def test_proxy_declaration_round_trip():
    spec = sources.get("proxy")
    assert spec.to_dict() == jsources.get("proxy").to_dict()
    clone = sources.TableSourceSpec.from_dict(spec.to_dict())
    lines = spec.synth_benign(40, seed=2)
    assert clone.featurize(lines).word == spec.featurize(lines).word
    bad = dict(spec.to_dict(), doc_column="nope")
    with pytest.raises(ValueError, match="doc_column"):
        sources.TableSourceSpec.from_dict(bad)
    with pytest.raises(ValueError, match="kind must be one of"):
        sources.FieldDef("x", "host", "color")
    with pytest.raises(ValueError, match="strategy must be one of"):
        sources.CutDef("x", "tercile")


def test_spec_for_features_resolves_each_container():
    for name in NAMES:
        port, _ = _features(name, n=40)
        assert sources.spec_for_features(port).name == name
        for other in NAMES:
            assert sources.get(other).matches_features(port) == (
                other == name)
    with pytest.raises(TypeError, match="matches no registered source"):
        sources.spec_for_features(object())


def test_proxy_score_csv_matches_reference(monkeypatch):
    """The proxy spec's scorer with one model: the same bytes and scores
    as the JAX spec's host engine (unseen docs and words take the 0.1
    fallback row); its device engine (on the CPU) the same events in the
    same order as the JAX spec's device engine, the featurized columns
    byte-equal and the scores within rel 1e-6; without a card the device
    engine raises."""
    spec, ref = sources.get("proxy"), jsources.get("proxy")
    port, jfeat = _features("proxy", n=200, seed=5)
    triples = port.word_counts()
    docs = list(dict.fromkeys(ip for ip, _, _ in triples))[:-2]
    vocab = list(dict.fromkeys(w for _, w, _ in triples))[:-1]
    rng = np.random.default_rng(0)
    theta = rng.dirichlet(np.ones(4), size=len(docs))
    p = rng.dirichlet(np.ones(len(vocab)), size=4).T
    model = ScoringModel.from_results(docs, theta, vocab, p, 0.1)
    jmodel = JScoringModel.from_results(docs, theta, vocab, p, 0.1)
    for tol in (1.1, float(np.median(theta @ p.T))):
        blob, scores = spec.score_csv(port, model, tol)
        jblob, jscores = ref.score_csv(jfeat, jmodel, tol, engine="host")
        assert blob == jblob and len(blob)
        np.testing.assert_array_equal(scores, jscores)
        dblob, dscores = spec.score_csv(port, model, tol, engine="device",
                                        device="cpu")
        jdblob, jdscores = ref.score_csv(jfeat, jmodel, tol, engine="device")
        got, want = dblob.decode().splitlines(), jdblob.decode().splitlines()
        assert len(got) == len(want) == len(dscores) > 0
        for g, w in zip(got, want):
            assert g.rsplit(",", 1)[0] == w.rsplit(",", 1)[0]
        np.testing.assert_allclose(dscores, jdscores, rtol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.score_csv(port, model, 1.1, engine="device")


def test_featurize_day_matches_reference(tmp_path):
    """The pre-stage hook per source against the JAX spec's (what the
    JAX runner's pre stage runs): flow and proxy read their path spec,
    dns its CSV paths in order (two files here, one with CRLF ends and a
    blank line) with the top-1m whitelist and the analyst feedback file;
    the same feedback rows and word counts."""
    flow = tmp_path / "flow.csv"
    flow.write_text("header\n" + "\n".join(
        jsources.get("flow").synth_benign(50, seed=4)) + "\n")
    proxy = tmp_path / "proxy.csv"
    proxy.write_text(",".join(sources.get("proxy").columns) + "\n" +
                     "\n".join(jsources.get("proxy").synth_benign(50, 4)))
    dns_a, dns_b = tmp_path / "a.csv", tmp_path / "b.csv"
    with open(os.path.join(GOLDEN, "inputs", "dns.csv")) as f:
        golden = f.read().splitlines()
    dns_a.write_text("\n".join(golden[:20]) + "\n")
    dns_b.write_bytes(("\r\n".join(golden[20:]) + "\r\n\n").encode())
    fb = ["frame", "120", "172.16.0.9", "www.evil.com", "1", "16", "0"] + [
        str(i) for i in range(7, 18)] + ["3", "19", "20", "21", "22",
                                         "1454058786"]
    (tmp_path / "dns_scores.csv").write_text("h\n" + ",".join(fb) + "\n")
    kw = dict(data_dir=str(tmp_path), flow_path=str(flow),
              dns_path=f"{dns_a},{dns_b}", proxy_path=str(proxy),
              top_domains_path=os.path.join(GOLDEN, "inputs", "top1m.csv"))
    cfg = PipelineConfig(feedback=FeedbackConfig(dup_factor=3), **kw)
    jcfg = JPipelineConfig(feedback=JFeedbackConfig(dup_factor=3), **kw)
    for name in NAMES:
        port, fb_rows = sources.get(name).featurize_day(cfg)
        ref, jfb_rows = jsources.get(name).featurize_day(
            jcfg, str(tmp_path / f"{name}_spill.bin"), 1, {})
        assert [list(r) if not isinstance(r, str) else r for r in fb_rows] \
            == [list(r) if not isinstance(r, str) else r for r in jfb_rows]
        assert port.word_counts() == ref.word_counts(), name
        assert port.num_raw_events == ref.num_raw_events > 0
        assert port.num_events == ref.num_events
    assert len(sources.get("dns").featurize_day(cfg)[1]) == 3


def test_parquet_input_needs_pyarrow(tmp_path, monkeypatch):
    """A .parquet DNS path without pyarrow raises the JAX package's
    error, naming the file and the CSV alternative."""
    path = str(tmp_path / "day.parquet")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(RuntimeError) as port:
        builtin._dns_sources(path)
    with pytest.raises(RuntimeError) as ref:
        jbuiltin._read_parquet_rows(path)
    assert str(port.value) == str(ref.value)
    assert "requires pyarrow" in str(port.value)
    with pytest.raises(OSError, match="no DNS input files match"):
        builtin._dns_sources(str(tmp_path / "missing" / "*.csv"))


@pytest.mark.parametrize("variant", ["packed", "ragged_rows", "nul_in_a_field"])
@pytest.mark.parametrize("name", NAMES)
def test_features_pickle_round_trips(name, variant):
    """features.pkl: each container pickles its string lists packed (one
    string per list) and loads to equal fields, ragged rows included; a
    list in which a string holds the separator pickles unpacked, still
    equal."""
    import pickle

    from oni_ml_tpu_torch.features import pickling

    port, _ = _features(name)
    if variant == "ragged_rows":
        port.rows[2] = port.rows[2][:3]
    if variant == "nul_in_a_field":
        port.rows[3][0] += pickling.SEP
    state = port.__getstate__()
    for field in type(port)._PACKED:
        packed = isinstance(state[field], pickling._Packed)
        assert packed == (variant != "nul_in_a_field" or field != "rows")
    again = pickle.loads(pickle.dumps(port, protocol=pickle.HIGHEST_PROTOCOL))
    assert type(again) is type(port)
    np.testing.assert_equal(vars(again), vars(port))
