"""The port's host stages against the JAX package's, byte for byte:
featurization, feedback rows, the corpus files and the bucketed layout,
on the golden flow day and on a synthetic day written by both
packages' writers."""

import io
import os

import numpy as np
import pytest

import bench
from oni_ml_tpu.features import flow as jflow
from oni_ml_tpu.features import read_flow_feedback_rows as j_feedback
from oni_ml_tpu.features.native_flow import featurize_flow_file
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu_torch.features import featurize_flow, read_flow_feedback_rows
from oni_ml_tpu_torch.features.lineio import iter_flow_lines
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.synth import write_flow_day

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "inputs", "flow.csv")


@pytest.fixture(scope="module")
def synth_day(tmp_path_factory):
    path = tmp_path_factory.mktemp("synth") / "day.csv"
    with open(path, "w") as f:
        write_flow_day(f, 3000, n_src=60, n_dst=40, seed=23)
    return str(path)


def test_synth_writer_matches_bench_bytes():
    ours, theirs = io.StringIO(), io.StringIO()
    write_flow_day(ours, 2500, n_src=300, n_dst=70_000, seed=3, chunk=1000)
    bench._write_flow_day(theirs, 2500, n_src=300, n_dst=70_000, seed=3,
                          chunk=1000)
    assert ours.getvalue() == theirs.getvalue()


@pytest.mark.parametrize("day", ["golden", "synth"])
def test_featurize_and_corpus_bytes_match_jax(day, synth_day, tmp_path):
    path = GOLDEN if day == "golden" else synth_day
    ours = featurize_flow(iter_flow_lines(path))
    with open(path) as f:
        numpy_ref = jflow.featurize_flow(f.read().splitlines())
    native_ref = featurize_flow_file(path)
    assert ours.word_counts() == numpy_ref.word_counts()
    assert ours.word_counts() == list(native_ref.word_counts())
    for i in range(ours.num_events):
        assert ours.featurized_row(i) == numpy_ref.featurized_row(i)
    for name in ("time_cuts", "ibyt_cuts", "ipkt_cuts"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(numpy_ref, name))

    ours_dir, ref_dir = tmp_path / "port", tmp_path / "jax"
    ours_dir.mkdir()
    ref_dir.mkdir()
    corpus = Corpus.from_features(ours)
    ref = JCorpus.from_features(native_ref)
    corpus.save(str(ours_dir))
    ref.save(str(ref_dir))
    for name in ("words.dat", "doc.dat", "model.dat"):
        assert (ours_dir / name).read_bytes() == (ref_dir / name).read_bytes()

    for min_len, cap, pad in ((128, 1024, 8), (16, 32, 8)):
        got = corpus.bucketed_layout(min_len=min_len, batch_cap=cap,
                                     pad_multiple=pad)
        want = ref.bucketed_layout(min_len=min_len, batch_cap=cap,
                                   pad_multiple=pad)
        np.testing.assert_array_equal(got.perm, want.perm)
        np.testing.assert_array_equal(got.inv_perm, want.inv_perm)
        assert len(got.batches) == len(want.batches)
        for gb, wb in zip(got.batches, want.batches):
            for field in ("word_idx", "counts", "doc_index", "doc_mask"):
                np.testing.assert_array_equal(getattr(gb, field),
                                              getattr(wb, field))
        assert corpus.bucket_shapes(min_len, cap, pad) == ref.bucket_shapes(
            min_len, cap, pad)


def test_feedback_rows_match_jax(tmp_path):
    path = tmp_path / "flow_scores.csv"
    head = ",".join(f"c{i}" for i in range(22))
    rows = [
        ["3", "2016-01-22 10:11:12", "10.0.0.1", "10.1.0.2", "443", "52100",
         "x", "x", "12", "3400"] + ["x"] * 12,
        ["1", "2016-01-22 10:11:12", "10.0.0.3", "10.1.0.4", "22", "6000",
         "x", "x", "1", "40"] + ["x"] * 12,
        ["3", "bad-tstart", "10.0.0.5", "10.1.0.6", "80", "7000",
         "x", "x", "2", "90"] + ["x"] * 12,
    ]
    path.write_text(head + "\n" + "\n".join(",".join(r) for r in rows) + "\n")
    got = read_flow_feedback_rows(str(path), 4)
    assert got == j_feedback(str(path), 4)
    assert len(got) == 4
    assert read_flow_feedback_rows(str(tmp_path / "missing.csv"), 4) == []

    day = featurize_flow(iter_flow_lines(GOLDEN), feedback_rows=got)
    with open(GOLDEN) as f:
        ref = jflow.featurize_flow(f.read().splitlines(), feedback_rows=got)
    assert day.num_raw_events == ref.num_raw_events
    assert day.word_counts() == ref.word_counts()
