"""The port's float64 host scorer against the JAX package's: for the same
model, the scored CSV is byte-identical (same gathers, same k-order
accumulation, same stable sort)."""

import os

import numpy as np
import pytest

from oni_ml_tpu.features import flow as jflow
from oni_ml_tpu.io import formats as jformats
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.scoring import score_flow_csv as j_score_flow_csv
from oni_ml_tpu_torch.features import featurize_flow
from oni_ml_tpu_torch.features.lineio import iter_flow_lines
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.scoring import ScoringModel, score_flow_csv

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inputs", "flow.csv")


@pytest.fixture(scope="module")
def model_inputs():
    feats = featurize_flow(iter_flow_lines(GOLDEN))
    corpus = Corpus.from_features(feats)
    rng = np.random.default_rng(7)
    k = 20
    gamma = rng.gamma(0.5, 2.0, size=(corpus.num_docs, k))
    gamma[0] = 0.0          # an all-zero row takes the literal zero string
    log_beta = np.log(rng.dirichlet(np.ones(corpus.num_terms) * 0.3, size=k))
    with open(GOLDEN) as f:
        jfeats = jflow.featurize_flow(f.read().splitlines())
    return feats, jfeats, corpus, gamma, log_beta


@pytest.mark.parametrize("threshold", [1e-3, 0.02, 1.1])
def test_scored_csv_bytes_match_jax(model_inputs, threshold):
    feats, jfeats, corpus, gamma, log_beta = model_inputs
    ours = ScoringModel.from_lda(corpus.doc_names, gamma, corpus.vocab,
                                 log_beta, 0.05)
    ref = JScoringModel.from_lda(corpus.doc_names, gamma, corpus.vocab,
                                 log_beta, 0.05)
    blob, scores = score_flow_csv(feats, ours, threshold)
    jblob, jscores = j_score_flow_csv(jfeats, ref, threshold, engine="host")
    assert blob == jblob
    np.testing.assert_array_equal(scores, jscores)


def test_from_lda_equals_from_files(model_inputs, tmp_path):
    feats, _, corpus, gamma, log_beta = model_inputs
    jformats.write_doc_results(str(tmp_path / "doc_results.csv"),
                               corpus.doc_names, gamma)
    jformats.write_word_results(str(tmp_path / "word_results.csv"),
                                corpus.vocab, log_beta)
    a = ScoringModel.from_lda(corpus.doc_names, gamma, corpus.vocab,
                              log_beta, 0.05)
    b = ScoringModel.from_files(str(tmp_path / "doc_results.csv"),
                                str(tmp_path / "word_results.csv"), 0.05)
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.p, b.p)
    assert score_flow_csv(feats, a, 0.5)[0] == score_flow_csv(feats, b, 0.5)[0]
