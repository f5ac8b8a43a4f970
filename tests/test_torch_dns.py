"""The port's DNS featurization against the JAX package's on the same
inputs, on the CPU: the golden DNS day's words, cuts, word counts and
featurized rows identical; the subdomain split and the entropy identical
on names that cover every branch (reverse DNS, country-code TLDs, empty
and "None" subdomains, trailing dots); the DNS feedback rows identical;
the golden corpus files and scored rows against tests/golden/expected."""

import os
import sys

import numpy as np
import pytest
import torch

from oni_ml_tpu.features import dns as jdns
from oni_ml_tpu.features import feedback as jfeedback
from oni_ml_tpu_torch.features import (
    DNS_COLUMNS,
    NUM_DNS_COLUMNS,
    extract_subdomain,
    featurize_dns,
    load_top_domains,
    read_dns_feedback_rows,
    shannon_entropy,
)
from oni_ml_tpu_torch.io import Corpus, formats
from oni_ml_tpu_torch.scoring import ScoringModel, score_dns, score_dns_csv

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
DNS_CSV = os.path.join(GOLDEN, "inputs", "dns.csv")
TOP1M = os.path.join(GOLDEN, "inputs", "top1m.csv")
EXPECTED = os.path.join(GOLDEN, "expected", "dns")
sys.path.insert(0, GOLDEN)
from generate import DNS_FALLBACK, DNS_TOL  # noqa: E402


def _rows():
    with open(DNS_CSV) as f:
        return [line.rstrip("\n").split(",") for line in f if line.strip()]


@pytest.fixture(scope="module")
def golden():
    """The golden day through both featurizers, with the top-1m
    whitelist and two feedback rows appended (trained, never scored)."""
    rows = _rows()
    feedback = [rows[0], rows[5]]
    port = featurize_dns(rows, load_top_domains(TOP1M), feedback)
    ref = jdns.featurize_dns(rows, jdns.load_top_domains(TOP1M), feedback)
    return port, ref


def test_columns_match_reference():
    assert DNS_COLUMNS == jdns.DNS_COLUMNS
    assert NUM_DNS_COLUMNS == jdns.NUM_DNS_COLUMNS
    assert load_top_domains(TOP1M) == jdns.load_top_domains(TOP1M)


def test_golden_words_cuts_and_counts_identical(golden):
    port, ref = golden
    assert port.num_raw_events == ref.num_raw_events == len(_rows())
    assert port.num_events == ref.num_events
    assert port.word == ref.word
    assert port.domain == ref.domain and port.subdomain == ref.subdomain
    for name in ("time_cuts", "frame_length_cuts", "subdomain_length_cuts",
                 "entropy_cuts", "numperiods_cuts", "subdomain_length",
                 "num_periods", "subdomain_entropy", "top_domain"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port.word_counts() == ref.word_counts()
    assert [port.featurized_row(i) for i in range(port.num_events)] == [
        ref.featurized_row(i) for i in range(ref.num_events)]
    assert [port.client_ip(i) for i in range(port.num_events)] == [
        ref.client_ip(i) for i in range(ref.num_events)]


def test_precomputed_cuts_reproduce_words(golden):
    """Pinned cuts (a serving micro-batch's rule) bin like the day."""
    port, ref = golden
    cuts = (port.time_cuts, port.frame_length_cuts,
            port.subdomain_length_cuts, port.entropy_cuts,
            port.numperiods_cuts)
    rows = _rows()[:7]
    again = featurize_dns(rows, load_top_domains(TOP1M),
                          precomputed_cuts=cuts)
    jagain = jdns.featurize_dns(rows, jdns.load_top_domains(TOP1M),
                                precomputed_cuts=cuts)
    assert again.word == jagain.word == port.word[:7]


NAMES = [
    "www.google.com", "a.b.co.uk", "co.uk", "x.co.uk", "5.4.3.2.in-addr.arpa",
    "in-addr.arpa", "justtld", "", "two.parts", "trailing.dot.net.",
    "a..b.example.com", "deep.sub.example.org", "dga-x7f3k9q2.evil.biz",
    "None", "a.b.c.d.e.f.krd", "x.y.", "...", "ünï.cödé.de",
]


@pytest.mark.parametrize("name", NAMES)
def test_extract_subdomain_matches_reference(name):
    assert extract_subdomain(name) == jdns.extract_subdomain(name)


@pytest.mark.parametrize("s", ["", "None", "a", "aaaa", "abcabc",
                               "dga-x7f3k9q2", "deep.sub", "ünïcödé",
                               "x" * 300 + "yz"])
def test_shannon_entropy_matches_reference(s):
    assert shannon_entropy(s) == jdns.shannon_entropy(s)


def test_dns_feedback_rows_match_reference(tmp_path):
    """dns_scores.csv: the header dropped, severity-3 rows of 24 fields
    duplicated, other severities, short rows and a malformed severity
    skipped."""
    def row(sev, name, ts="1454058786"):
        f = ["frame", " 120", "172.16.0.9", name, "1", "16", "0"]
        f += [str(i) for i in range(7, 18)]
        f += [sev, "19", "20", "21", "22", ts]
        assert len(f) == 24
        return ",".join(f)

    path = tmp_path / "dns_scores.csv"
    path.write_text("\n".join([
        "header", row("3", "www.evil.com"), row("1", "ok.example.org"),
        row(" 3 ", "mail.example.org"), row("x", "bad.example.org"),
        "short,row", row("3", "a.b.co.uk", ts="1454000000"),
    ]) + "\n")
    port = read_dns_feedback_rows(str(path), 4)
    ref = jfeedback.read_dns_feedback_rows(str(path), 4)
    assert port == ref and len(port) == 12
    assert read_dns_feedback_rows(str(tmp_path / "none.csv"), 4) == []


def test_golden_corpus_files_pinned(tmp_path):
    """word_counts.dat and the model.dat triplet of the port's golden
    day equal tests/golden/expected/dns byte for byte."""
    feats = featurize_dns(_rows(), load_top_domains(TOP1M))
    formats.write_word_counts(str(tmp_path / "word_counts.dat"),
                              feats.word_counts())
    corpus = Corpus.from_word_counts_file(str(tmp_path / "word_counts.dat"))
    corpus.save(str(tmp_path))
    for name in ("word_counts.dat", "words.dat", "doc.dat", "model.dat"):
        with open(os.path.join(EXPECTED, name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name


def test_golden_scoring_pinned():
    """The port's host scorer over the golden day and the pinned model:
    dns_results.csv byte for byte, ascending, some events kept."""
    feats = featurize_dns(_rows(), load_top_domains(TOP1M))
    model = ScoringModel.from_files(
        os.path.join(EXPECTED, "doc_results.csv"),
        os.path.join(EXPECTED, "word_results.csv"), DNS_FALLBACK)
    blob, scores = score_dns_csv(feats, model, DNS_TOL)
    with open(os.path.join(EXPECTED, "dns_results.csv"), "rb") as f:
        assert blob == f.read()
    rows, again = score_dns(feats, model, DNS_TOL)
    assert "".join(r + "\n" for r in rows).encode() == blob
    np.testing.assert_array_equal(scores, again)
    assert 0 < len(rows) < feats.num_raw_events
    assert np.all(np.diff(scores) >= 0)


def test_device_scorer_not_ported_raises(monkeypatch):
    """The device engine scores the golden day through the pipeline: on
    the CPU (device="cpu") the same events as the pinned
    dns_results.csv, featurized columns byte-equal and scores within rel
    1e-6; without a card and without device="cpu" it raises instead of
    giving way to the host engine; an unknown engine raises."""
    feats = featurize_dns(_rows(), load_top_domains(TOP1M))
    model = ScoringModel.from_files(
        os.path.join(EXPECTED, "doc_results.csv"),
        os.path.join(EXPECTED, "word_results.csv"), DNS_FALLBACK)
    blob, scores = score_dns_csv(feats, model, DNS_TOL, engine="device",
                                 device="cpu")
    with open(os.path.join(EXPECTED, "dns_results.csv"), "rb") as f:
        want = f.read().decode().splitlines()
    got = blob.decode().splitlines()
    assert len(got) == len(want) == len(scores)
    for g, w in zip(got, want):
        assert g.rsplit(",", 1)[0] == w.rsplit(",", 1)[0]
        np.testing.assert_allclose(float(g.rsplit(",", 1)[1]),
                                   float(w.rsplit(",", 1)[1]), rtol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_dns_csv(feats, model, DNS_TOL, engine="device")
    with pytest.raises(ValueError, match="'host' or 'device'"):
        score_dns_csv(feats, model, DNS_TOL, engine="gpu")
