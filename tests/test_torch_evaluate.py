"""The port's model-quality evaluation (models/evaluate.py) and the
runner's --eval-quality, --eval-holdout and --publish against the JAX
package's, on the CPU: hash_split's indices exactly equal;
held_out_per_token_ll within 1e-5 relative of the JAX value on the same
topics and batches (float32 fixed points that stop at var_tol, summed in
another order; measured ~1e-7); the runner's completion and held-out
records within 2e-4 relative of the JAX runner's from the same initial
beta (the EM drift of the model itself, ROADMAP Queue 3: ~1e-5 over
these iterations); publish_day's local copy byte for byte, and a
failing remote raises."""

import json
import os
import subprocess

import jax
import numpy as np
import pytest

from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.config import PipelineConfig as JPipelineConfig
from oni_ml_tpu.config import ScoringConfig as JScoringConfig
from oni_ml_tpu.io import make_batches as jmake_batches
from oni_ml_tpu.models import evaluate as jevaluate
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu_torch.config import LDAConfig, PipelineConfig, ScoringConfig
from oni_ml_tpu_torch.io import formats, make_batches
from oni_ml_tpu_torch.models import evaluate
from oni_ml_tpu_torch.runner import ml_ops

from test_torch_online import _corpora

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "inputs", "flow.csv")
FDATE = "20160122"
K, EM_ITERS = 5, 8
QUIET = {"emit": lambda *a, **k: None}


@pytest.mark.parametrize("frac", [0.1, 0.3, 0.5, 0.9])
def test_hash_split_equals_jax(frac):
    """The split by name hash: the JAX package's indices exactly, and a
    document's side does not depend on the order of the names."""
    rng = np.random.default_rng(int(frac * 10))
    names = [f"10.{rng.integers(256)}.{rng.integers(256)}.{i}"
             for i in range(500)] + ["café", "\udcff-bad-surrogate"]
    got, want = evaluate.hash_split(names, frac), jevaluate.hash_split(
        names, frac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rev = evaluate.hash_split(names[::-1], frac)[1]
    assert {names[i] for i in got[1]} == {names[::-1][i] for i in rev}
    assert len(got[0]) + len(got[1]) == len(names)


def test_hash_split_rejects_bad_fractions():
    for frac in (0.0, 1.0, 1.5, -0.1):
        with pytest.raises(ValueError, match=r"in \(0, 1\)"):
            evaluate.hash_split(["a", "b"], frac)


def test_held_out_per_token_ll_matches_jax():
    """Document completion over the same topics and padded batches: the
    JAX value within 1e-5, and a fitted-looking model scores above a
    flat one."""
    pc, jc = _corpora(num_docs=80, num_terms=40, seed=6)
    rng = np.random.default_rng(3)
    log_beta = np.log(rng.dirichlet(np.full(40, 0.3), size=K))
    log_beta[0, :3] = -100.0   # LOG_ZERO words: the float32 floor
    got = evaluate.held_out_per_token_ll(log_beta, 2.5,
                                         make_batches(pc, 32, 16),
                                         device="cpu")
    want = jevaluate.held_out_per_token_ll(log_beta, 2.5,
                                           jmake_batches(jc, 32, 16))
    assert np.isfinite(got) and got < 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    flat = evaluate.held_out_per_token_ll(np.full((K, 40), -np.log(40)),
                                          2.5, make_batches(pc, 32, 16),
                                          device="cpu")
    np.testing.assert_allclose(flat, -np.log(40), rtol=1e-6)


def _days(tmp_path, monkeypatch, **kw):
    """The golden flow day through both runners with `kw` (eval flags),
    the port from the JAX initial beta: -> (port lda record, JAX lda
    record, port day dir, JAX day dir)."""
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "p.jsonl"))
    jm = jml_ops.run_pipeline(JPipelineConfig(
        data_dir=str(tmp_path / "jax"), flow_path=GOLDEN,
        lda=JLDAConfig(num_topics=K, em_max_iters=EM_ITERS, em_tol=0.0),
        scoring=JScoringConfig(threshold=1.1)), FDATE, "flow", **kw)
    v = len(formats.read_words_dat(str(tmp_path / "jax" / FDATE
                                       / "words.dat")))
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), K, v))
    cfg = PipelineConfig(data_dir=str(tmp_path / "port"), flow_path=GOLDEN,
                         lda=LDAConfig(num_topics=K, em_max_iters=EM_ITERS,
                                       em_tol=0.0),
                         scoring=ScoringConfig(threshold=1.1))
    run = ml_ops.run_pipeline(cfg, FDATE, "flow", device="cpu",
                              initial_log_beta=init, **kw, **QUIET)
    lda = {r["stage"]: r for r in run.records}["lda"]
    jlda_rec = {r["stage"]: r for r in jm}["lda"]
    return (lda, jlda_rec, tmp_path / "port" / FDATE,
            tmp_path / "jax" / FDATE, cfg, init)


def test_eval_quality_record_matches_jax(tmp_path, monkeypatch):
    """--eval-quality: the lda record's completion score within 2e-4 of
    the JAX runner's; a resumed run whose lda stage is skipped scores the
    saved model to the same number."""
    lda, jrec, day, _, cfg, init = _days(tmp_path, monkeypatch,
                                         eval_quality=True)
    assert lda["completion_per_token_ll"] < 0
    np.testing.assert_allclose(lda["completion_per_token_ll"],
                               jrec["completion_per_token_ll"], rtol=2e-4)
    np.testing.assert_allclose(lda["completion_perplexity"],
                               np.exp(-lda["completion_per_token_ll"]))
    again = {r["stage"]: r for r in ml_ops.run_pipeline(
        cfg, FDATE, "flow", device="cpu", initial_log_beta=init,
        eval_quality=True, **QUIET).records}["lda"]
    assert again["skipped"] == "journal: stage completed in a prior run"
    np.testing.assert_allclose(again["completion_per_token_ll"],
                               lda["completion_per_token_ll"], rtol=1e-6)


def test_eval_holdout_record_matches_jax(tmp_path, monkeypatch):
    """--eval-holdout 0.3: the same held-out documents as the JAX runner
    (the name hash), its held-out score within 2e-4; final.gamma and
    doc_results.csv cover every document, within 2e-4 of the JAX day's,
    and the day is scored."""
    lda, jrec, day, jday, _, _ = _days(tmp_path, monkeypatch,
                                       eval_holdout=0.3)
    assert lda["held_out_frac"] == jrec["held_out_frac"] == 0.3
    assert lda["held_out_docs"] == jrec["held_out_docs"] > 0
    np.testing.assert_allclose(lda["held_out_per_token_ll"],
                               jrec["held_out_per_token_ll"], rtol=2e-4)
    docs = formats.read_doc_dat(str(day / "doc.dat"))
    gamma = formats.read_gamma(str(day / "final.gamma"))
    assert gamma.shape == (len(docs), K)
    np.testing.assert_allclose(gamma, formats.read_gamma(
        str(jday / "final.gamma")), rtol=2e-4)
    assert len((day / "doc_results.csv").read_text().splitlines()) == \
        len(docs)
    assert (day / "flow_results.csv").exists()
    assert lda["batches"] >= 1 and lda["member"] == "per_batch:xla"


def test_publish_delivers_the_day(tmp_path):
    """--publish DEST: the finished day lands under DEST byte for byte,
    its metrics.json written before the copy; the local copy also
    records the publish; publishing again over it works."""
    dest = tmp_path / "ui_node"
    dest.mkdir()
    cfg = PipelineConfig(data_dir=str(tmp_path / "data"), flow_path=GOLDEN,
                         lda=LDAConfig(num_topics=K, em_max_iters=3),
                         scoring=ScoringConfig(threshold=1.1))
    run = ml_ops.run_pipeline(cfg, FDATE, "flow", device="cpu",
                              publish=str(dest), **QUIET)
    pub = [r for r in run.records if r["stage"] == "publish"]
    assert len(pub) == 1 and pub[0]["transport"] == "copy"
    assert pub[0]["published"] == str(dest / FDATE)
    day, out = tmp_path / "data" / FDATE, dest / FDATE
    names = sorted(os.listdir(day))
    assert sorted(os.listdir(out)) == names
    for name in names:
        if name != "metrics.json":
            assert (out / name).read_bytes() == (day / name).read_bytes(), \
                name
    delivered = json.loads((out / "metrics.json").read_text())
    local = json.loads((day / "metrics.json").read_text())
    assert delivered == local[:-1] and local[-1]["stage"] == "publish"
    ml_ops.run_pipeline(cfg, FDATE, "flow", device="cpu", publish=str(dest),
                        **QUIET)


def test_publish_remote_failure_raises(monkeypatch):
    calls = {}

    def fake_run(argv, capture_output, text):
        calls["argv"] = argv

        class R:
            returncode = 1
            stderr = "ssh: connect refused"

        return R()

    monkeypatch.setattr(subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="connect refused"):
        ml_ops.publish_day("/data/20160122", "uinode:/var/oni")
    assert calls["argv"] == ["scp", "-r", "/data/20160122", "uinode:/var/oni"]


def test_cli_takes_the_new_flags(tmp_path, capsys):
    """The CLI parses the flags into the run: --eval-quality and
    --publish on a batch day; --online --eta --tau0 --kappa onto
    OnlineLDAConfig; --no-dataplane / --no-checkpoints onto
    DataplaneConfig (and --no-checkpoints with --stages is refused with
    the JAX runner's message)."""
    common = [FDATE, "flow", "1.1", "--flow-path", GOLDEN, "--device", "cpu",
              "--topics", "3", "--em-max-iters", "3"]
    dest = tmp_path / "dest"
    dest.mkdir()
    assert ml_ops.main(common + ["--data-dir", str(tmp_path / "a"),
                                 "--eval-quality", "--publish",
                                 str(dest)]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by = {r["stage"]: r for r in out}
    assert "completion_per_token_ll" in by["lda"] and "publish" in by
    assert ml_ops.main(common + ["--data-dir", str(tmp_path / "b"),
                                 "--online", "--eta", "0.05", "--tau0", "16",
                                 "--kappa", "0.6", "--no-dataplane"]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert {r["stage"]: r for r in out}["lda"]["engine"] == "online"
    args = ml_ops.build_parser().parse_args(
        common + ["--online", "--eta", "0.05", "--tau0", "16", "--kappa",
                  "0.6", "--no-checkpoints", "--eval-holdout", "0.2"])
    assert (args.eta, args.tau0, args.kappa, args.eval_holdout) == (
        0.05, 16.0, 0.6, 0.2)
    assert args.online and args.no_checkpoints and not args.no_dataplane
    with pytest.raises(ValueError, match="--stages subset"):
        ml_ops.main(common + ["--data-dir", str(tmp_path / "c"),
                              "--no-checkpoints", "--stages", "pre"])
