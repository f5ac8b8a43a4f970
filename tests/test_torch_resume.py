"""The port's resume contract on the CPU: EM checkpoints (the file, its
round trip against the JAX package's format, the streaming-checkpoint
guard, resume equal to an uninterrupted fit under both drivers, the
chunk driver's dispatches cut at checkpoint iterations), and the
runner's stages (a `--stages` split run writes a one-shot run's bytes,
missing inputs fail fast naming the file and the command that writes
it, the journal names why a stage was skipped, a stage that dies leaves
no outputs behind, a checkpoint of an older corpus or a forced fit is
not resumed, a JAX-written features.pkl is refused without importing
the JAX package)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus, formats, make_batches
from oni_ml_tpu_torch.models import lda as tlda
from oni_ml_tpu_torch.models import train_corpus
from oni_ml_tpu_torch.models.lda import (LDATrainer, load_checkpoint,
                                         save_checkpoint)
from oni_ml_tpu_torch.runner import ml_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "inputs")
FDATE = "20160122"


def _corpus():
    rng = np.random.default_rng(13)
    triples = [(f"10.0.0.{d}", f"w{w}", int(rng.integers(1, 5)))
               for d in range(30) for w in rng.choice(25, 8, replace=False)]
    return Corpus.from_word_counts(triples)


def _batches(corpus, engine):
    if engine == "sparse":
        return list(corpus.bucketed_layout(min_len=16, batch_cap=16).batches)
    return make_batches(corpus, 16, 16, pad_multiple=8)


# -- EM checkpoints ---------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    lb = -np.random.default_rng(0).random((3, 7))
    save_checkpoint(path, lb, 1.25, 4, [(-10.0, 1.0), (-9.0, 0.1)])
    ck = load_checkpoint(path)
    np.testing.assert_array_equal(ck["log_beta"], lb)
    assert ck["alpha"] == 1.25 and ck["em_iter"] == 4
    assert ck["likelihoods"] == [(-10.0, 1.0), (-9.0, 0.1)]
    assert os.listdir(tmp_path) == ["ck.npz"]   # no temporary left


def test_checkpoint_file_is_the_jax_packages(tmp_path):
    """Either package loads the other's checkpoint to the same values."""
    lb = -np.random.default_rng(1).random((4, 9))
    lls = [(-20.0, 1.0), (-19.5, 0.025)]
    save_checkpoint(str(tmp_path / "port.npz"), lb, 0.5, 2, lls)
    jlda.save_checkpoint(str(tmp_path / "jax.npz"), lb, 0.5, 2, lls)
    for a, b in ((load_checkpoint(str(tmp_path / "jax.npz")),
                  jlda.load_checkpoint(str(tmp_path / "port.npz"))),):
        np.testing.assert_array_equal(a["log_beta"], b["log_beta"])
        assert (a["alpha"], a["em_iter"], a["likelihoods"]) == (
            b["alpha"], b["em_iter"], b["likelihoods"])


def test_load_rejects_streaming_checkpoints(tmp_path):
    """Both streaming-LDA layouts that can share checkpoint.npz are
    refused, not trained from as topics."""
    lam = np.random.default_rng(1).gamma(100.0, 0.01, (3, 7))
    new_fmt = str(tmp_path / "new.npz")
    np.savez(new_fmt, lam=lam, alpha=np.float64(2.5), em_iter=np.int64(3),
             likelihoods=np.array([[-5.0, 0.5]]))
    with pytest.raises(ValueError, match="streaming-LDA checkpoint"):
        load_checkpoint(new_fmt)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, log_beta=lam, alpha=np.float64(2.5),
             em_iter=np.int64(3), likelihoods=np.array([[-5.0, 0.5]]))
    with pytest.raises(ValueError, match="strictly positive"):
        load_checkpoint(legacy)


def _config(iters, chunk, **kw):
    return LDAConfig(num_topics=3, em_max_iters=iters, em_tol=0.0,
                     batch_size=16, min_bucket_len=16,
                     sparse_min_bucket_len=16, seed=7, checkpoint_every=1,
                     fused_em_chunk=chunk, **kw)


@pytest.mark.parametrize("engine", ["sparse", "dense"])
@pytest.mark.parametrize("chunk", [1, 128], ids=["stepwise", "chunk"])
def test_resume_equals_uninterrupted(tmp_path, engine, chunk):
    """A fit cut after iteration 3 (its state saved as the checkpoint of
    a crashed run) and resumed to 6 repeats the uninterrupted 6-iteration
    fit bit for bit: warm start off, so both start iteration 4's fixed
    point from the same fresh gamma.  The file is gone after the fit."""
    corpus = _corpus()
    batches = _batches(corpus, engine)
    v, d = corpus.num_terms, corpus.num_docs
    mk = lambda it: _config(it, chunk, warm_start_gamma=False)  # noqa: E731
    full = LDATrainer(mk(6), v, "cpu").fit(
        batches, d, engine=engine,
        likelihood_file=str(tmp_path / "full_likelihood.dat"))
    part = LDATrainer(mk(3), v, "cpu").fit(batches, d, engine=engine)
    ckpt = str(tmp_path / "checkpoint.npz")
    save_checkpoint(ckpt, part.log_beta, part.alpha, 3, part.likelihoods)
    resumed = LDATrainer(mk(6), v, "cpu").fit(
        batches, d, engine=engine, checkpoint_path=ckpt,
        likelihood_file=str(tmp_path / "likelihood.dat"))
    assert resumed.stats["driver"] == ("stepwise" if chunk == 1 else "fused")
    assert resumed.em_iters == full.em_iters == 6
    assert resumed.likelihoods == full.likelihoods
    np.testing.assert_array_equal(resumed.log_beta, full.log_beta)
    np.testing.assert_array_equal(resumed.gamma, full.gamma)
    assert resumed.alpha == full.alpha
    assert not os.path.exists(ckpt)
    assert (tmp_path / "likelihood.dat").read_bytes() == (
        tmp_path / "full_likelihood.dat").read_bytes()


def test_resume_with_warm_start_within_tolerance(tmp_path):
    """Under warm start the resumed fit's first iteration starts gamma
    fresh where the uninterrupted fit seeds it from iteration 3's, as in
    the JAX package: the same optimum, reached by another path.
    Measured on this corpus (chunk driver, sparse engine): likelihood
    3.1e-7, beta 1.4e-6, gamma 2.0e-6, alpha 4.0e-6 relative; bounds
    about 10x: likelihood 3e-6, beta, gamma and alpha 4e-5."""
    corpus = _corpus()
    batches = _batches(corpus, "sparse")
    v, d = corpus.num_terms, corpus.num_docs
    full = LDATrainer(_config(6, 128), v, "cpu").fit(batches, d)
    part = LDATrainer(_config(3, 128), v, "cpu").fit(batches, d)
    ckpt = str(tmp_path / "checkpoint.npz")
    save_checkpoint(ckpt, part.log_beta, part.alpha, 3, part.likelihoods)
    resumed = LDATrainer(_config(6, 128), v, "cpu").fit(
        batches, d, checkpoint_path=ckpt)
    assert resumed.likelihoods[:3] == full.likelihoods[:3]
    np.testing.assert_allclose([ll for ll, _ in resumed.likelihoods],
                               [ll for ll, _ in full.likelihoods], rtol=3e-6)
    np.testing.assert_allclose(np.exp(resumed.log_beta),
                               np.exp(full.log_beta), rtol=4e-5, atol=1e-12)
    np.testing.assert_allclose(resumed.gamma, full.gamma, rtol=4e-5)
    np.testing.assert_allclose(resumed.alpha, full.alpha, rtol=4e-5)


def test_resume_at_the_last_iteration_reruns_one(tmp_path):
    """A checkpoint at em_max_iters re-runs the last iteration (gamma
    comes from the final E-step), as in the JAX package."""
    corpus = _corpus()
    batches = _batches(corpus, "sparse")
    v, d = corpus.num_terms, corpus.num_docs
    cfg = _config(4, 128, warm_start_gamma=False)
    full = LDATrainer(cfg, v, "cpu").fit(batches, d)
    ckpt = str(tmp_path / "checkpoint.npz")
    part = LDATrainer(_config(3, 128, warm_start_gamma=False), v,
                      "cpu").fit(batches, d)
    save_checkpoint(ckpt, full.log_beta, full.alpha, 9, full.likelihoods)
    again = LDATrainer(cfg, v, "cpu").fit(batches, d, checkpoint_path=ckpt)
    assert again.em_iters == 4 and len(again.likelihoods) == 4
    assert again.likelihoods[:3] == full.likelihoods[:3]
    with pytest.raises(ValueError, match="does not match config"):
        save_checkpoint(ckpt, part.log_beta[:, :5], 1.0, 2, [])
        LDATrainer(cfg, v, "cpu").fit(batches, d, checkpoint_path=ckpt)


@pytest.mark.parametrize("chunk", [1, 128], ids=["stepwise", "chunk"])
def test_train_corpus_checkpoints_every_n(tmp_path, monkeypatch, chunk):
    """train_corpus with checkpoint_every 2 over 7 iterations saves at
    2, 4 and 6 into out_dir/checkpoint.npz; the chunk driver ends a
    dispatch at each (host_sync_every 16 would otherwise take all 7 in
    one); likelihood.dat covers every iteration; the file is removed at
    the end."""
    seen = []

    def spy(path, log_beta, alpha, it, likelihoods):
        seen.append((os.path.basename(path), it, len(likelihoods)))
        save_checkpoint(path, log_beta, alpha, it, likelihoods)

    monkeypatch.setattr(tlda, "save_checkpoint", spy)
    cfg = LDAConfig(num_topics=3, em_max_iters=7, em_tol=0.0,
                    checkpoint_every=2, fused_em_chunk=chunk,
                    sparse_min_bucket_len=16, estep_engine="sparse")
    result = train_corpus(_corpus(), cfg, out_dir=str(tmp_path),
                          device="cpu")
    assert seen == [("checkpoint.npz", 2, 2), ("checkpoint.npz", 4, 4),
                    ("checkpoint.npz", 6, 6)]
    assert result.em_iters == 7
    assert result.stats["host_syncs"] == (7 if chunk == 1 else 4)
    assert not (tmp_path / "checkpoint.npz").exists()
    assert formats.read_likelihood(
        str(tmp_path / "likelihood.dat")).shape == (7, 2)


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_checkpoint_boundaries_keep_the_fit(tmp_path, engine):
    """Cutting the chunk driver's dispatches at every iteration (and
    saving there) changes nothing: warm gammas carry across dispatches
    in one process, and EM stops at the same iteration of an em_tol run
    that converges inside the cap."""
    corpus = _corpus()
    batches = _batches(corpus, engine)
    v, d = corpus.num_terms, corpus.num_docs
    cfg = LDAConfig(num_topics=3, em_max_iters=60, em_tol=1e-4,
                    batch_size=16, min_bucket_len=16,
                    sparse_min_bucket_len=16, seed=7, checkpoint_every=1)
    plain = LDATrainer(cfg, v, "cpu").fit(batches, d, engine=engine)
    cut = LDATrainer(cfg, v, "cpu").fit(
        batches, d, engine=engine,
        checkpoint_path=str(tmp_path / "checkpoint.npz"))
    assert 1 < plain.em_iters < 60
    assert cut.em_iters == plain.em_iters
    assert cut.likelihoods == plain.likelihoods
    np.testing.assert_array_equal(cut.log_beta, plain.log_beta)
    np.testing.assert_array_equal(cut.gamma, plain.gamma)
    assert cut.stats["dispatches"] == plain.em_iters
    assert plain.stats["dispatches"] == -(-plain.em_iters // 16)


# -- the runner's stages ------------------------------------------------------


@pytest.fixture
def pinned(monkeypatch, tmp_path):
    """The sparse engine pinned, a plan cache in the test's directory."""
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "sparse")
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "plans.jsonl"))


def _argv(dsource, data, *extra):
    paths = {
        "dns": ["--dns-path", os.path.join(GOLDEN, "dns.csv"),
                "--top-domains", os.path.join(GOLDEN, "top1m.csv")],
        "flow": ["--flow-path", os.path.join(GOLDEN, "flow.csv")],
    }[dsource]
    return [FDATE, dsource, "1.1", "--data-dir", str(data), "--device", "cpu",
            "--em-max-iters", "8", *paths, *extra]


def _main(argv, capsys):
    rc = ml_ops.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in out]


OUTPUTS = ["features.pkl", "word_counts.dat", "words.dat", "doc.dat",
           "model.dat", "final.beta", "final.gamma", "final.other",
           "likelihood.dat", "doc_results.csv", "word_results.csv"]


@pytest.mark.parametrize("dsource", ["dns", "flow"])
@pytest.mark.parametrize("split", [("pre,corpus", "lda,score"),
                                   ("pre", "corpus", "lda", "score")],
                         ids=["two", "four"])
def test_stages_split_writes_one_shot_bytes(tmp_path, capsys, pinned,
                                            dsource, split):
    """--stages pre,corpus then --stages lda,score (and each stage in a
    process of its own) write the bytes of a one-shot run: the later
    stages read word_counts.dat, the model.dat triplet, features.pkl and
    the results CSVs instead of the live objects."""
    rc, _ = _main(_argv(dsource, tmp_path / "one"), capsys)
    assert rc == 0
    recs = {}
    for stages in split:
        rc, out = _main(_argv(dsource, tmp_path / "split", "--stages",
                              stages), capsys)
        assert rc == 0
        recs.update({r["stage"]: r for r in out})
    one, two = tmp_path / "one" / FDATE, tmp_path / "split" / FDATE
    for name in OUTPUTS + [f"{dsource}_results.csv"]:
        if name == "features.pkl":
            continue  # pickles of equal objects, not pinned bytes
        assert (one / name).read_bytes() == (two / name).read_bytes(), name
    assert recs["lda"]["corpus"] == "file"
    assert recs["score"]["features"] == "file"
    assert recs["score"]["model"] == ("file" if len(split) == 4
                                      else "handoff")
    if len(split) == 4:
        assert recs["corpus"]["handoff"] == "file"


@pytest.mark.parametrize("stages,missing,regen", [
    ("corpus", "word_counts.dat", "pre"),
    ("lda", "model.dat", "corpus"),
    ("score", "features.pkl", "pre"),
    ("lda,score", "model.dat", "corpus"),
])
def test_missing_input_fails_fast(tmp_path, capsys, pinned, stages, missing,
                                  regen):
    """A stage whose upstream file is absent stops before any loader,
    naming the file and the `--stages <regen> --force` command; the CLI
    prints one JSON error and returns 2."""
    rc, out = _main(_argv("dns", tmp_path, "--stages", stages), capsys)
    assert rc == 2
    err = out[-1]
    assert err["error"] == "missing_artifact"
    assert f"needs {missing}" in err["detail"]
    assert f"`ml_ops {FDATE} dns --stages {regen} --force`" in err["detail"]


def test_score_without_model_names_the_lda_stage(tmp_path, capsys, pinned):
    assert _main(_argv("dns", tmp_path, "--stages", "pre,corpus"),
                 capsys)[0] == 0
    rc, out = _main(_argv("dns", tmp_path, "--stages", "score"), capsys)
    assert rc == 2 and "needs doc_results.csv" in out[-1]["detail"]
    assert "--stages lda --force" in out[-1]["detail"]
    assert "also missing: word_results.csv" in out[-1]["detail"]


def test_skips_name_the_journal(tmp_path, capsys, pinned):
    """A second run of a done day skips every stage, the journal vouching
    ("journal: ..."); without the journal the files alone do ("outputs
    exist"); a deleted output re-runs its stage whatever the journal
    says; --force re-runs all, and the journal's force boundary holds."""
    assert _main(_argv("dns", tmp_path), capsys)[0] == 0
    rc, out = _main(_argv("dns", tmp_path), capsys)
    assert rc == 0
    assert [(r["stage"], r["skipped"]) for r in out] == [
        (s, "journal: stage completed in a prior run")
        for s in ("pre", "corpus", "lda", "score")]
    day = tmp_path / FDATE
    records = [json.loads(line) for line in
               (day / "run_journal.jsonl").read_text().splitlines()]
    assert [r["status"] for r in records
            if r["kind"] == "stage"][-4:] == ["skipped"] * 4
    (day / "run_journal.jsonl").unlink()
    (day / "dns_results.csv").unlink()
    rc, out = _main(_argv("dns", tmp_path), capsys)
    assert [r.get("skipped") for r in out] == ["outputs exist"] * 3 + [None]
    assert out[-1]["stage"] == "score" and out[-1]["features"] == "file"
    rc, out = _main(_argv("dns", tmp_path, "--force"), capsys)
    assert rc == 0 and not any("skipped" in r for r in out)
    rc, out = _main(_argv("dns", tmp_path, "--no-journal"), capsys)
    assert [r["skipped"] for r in out] == ["outputs exist"] * 4


def test_failed_stage_leaves_no_outputs(tmp_path, capsys, pinned,
                                        monkeypatch):
    """A forced lda stage that dies has removed the previous run's lda
    outputs and the score stage's (made from them) first, journals the
    failure, and the next run resumes at lda."""
    assert _main(_argv("dns", tmp_path), capsys)[0] == 0

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(ml_ops, "train_corpus", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        ml_ops.main(_argv("dns", tmp_path, "--stages", "lda,score",
                          "--force"))
    day = tmp_path / FDATE
    assert not any((day / n).exists() for n in
                   ml_ops._STAGE_OUTPUTS[ml_ops.Stage.LDA]
                   + ["dns_results.csv"])
    assert all((day / n).exists() for n in ("features.pkl", "model.dat"))
    records = [json.loads(line) for line in
               (day / "run_journal.jsonl").read_text().splitlines()]
    assert records[-2]["status"] == "failed" and records[-1]["ok"] is False
    monkeypatch.undo()
    monkeypatch.setenv("ONI_ML_TPU_ESTEP", "sparse")
    monkeypatch.setenv("ONI_ML_TPU_PLAN_CACHE", str(tmp_path / "p.jsonl"))
    capsys.readouterr()
    rc, out = _main(_argv("dns", tmp_path), capsys)
    assert rc == 0
    # The forced run's start cleared the journal's earlier completions,
    # and its lda stage removed the lda and score outputs.
    assert [r.get("skipped", "ran") for r in out] == [
        "outputs exist", "outputs exist", "ran", "ran"]


def test_runner_resumes_lda_from_checkpoint(tmp_path, capsys, pinned):
    """--checkpoint-every 1: an lda stage that finds checkpoint.npz (a
    crashed run's, after iteration 3) resumes there and writes the
    uninterrupted run's final.* and likelihood.dat (warm start off)."""
    flags = ("--checkpoint-every", "1", "--no-warm-start")
    assert _main(_argv("dns", tmp_path / "one", *flags), capsys)[0] == 0
    assert _main(_argv("dns", tmp_path / "two", "--stages", "pre,corpus"),
                 capsys)[0] == 0
    day = tmp_path / "two" / FDATE
    corpus = Corpus.from_model_dat(str(day / "model.dat"),
                                   str(day / "words.dat"),
                                   str(day / "doc.dat"))
    part = train_corpus(corpus, LDAConfig(em_max_iters=3, em_tol=0.0,
                                          warm_start_gamma=False),
                        device="cpu")
    if part.em_iters < 3:
        pytest.fail("the partial fit converged before iteration 3")
    save_checkpoint(str(day / "checkpoint.npz"), part.log_beta, part.alpha,
                    3, part.likelihoods)
    rc, out = _main(_argv("dns", tmp_path / "two", "--stages", "lda,score",
                          *flags), capsys)
    assert rc == 0
    one = tmp_path / "one" / FDATE
    for name in ("final.beta", "final.gamma", "final.other",
                 "likelihood.dat", "dns_results.csv"):
        assert (one / name).read_bytes() == (day / name).read_bytes(), name
    assert not (day / "checkpoint.npz").exists()


@pytest.mark.parametrize("rerun", [
    ("--force",),
    ("--stages", "lda,score", "--force"),
    ("--stages", "corpus,lda,score", "--force"),
    "corpus remade",
], ids=["force", "force_lda", "force_corpus", "corpus_remade"])
def test_stale_checkpoint_is_not_resumed(tmp_path, capsys, pinned, rerun):
    """A checkpoint.npz that a crashed lda stage left is dropped when the
    corpus is remade (pre or corpus runs again) or a fresh fit is forced:
    the fit equals a fresh one, not one seeded from the old state (K and
    V match, so the trainer alone would resume from it)."""
    flags = ("--checkpoint-every", "1", "--no-warm-start")
    assert _main(_argv("dns", tmp_path / "one", *flags), capsys)[0] == 0
    assert _main(_argv("dns", tmp_path / "two", *flags), capsys)[0] == 0
    day = tmp_path / "two" / FDATE
    k, v = 20, len((day / "words.dat").read_text().splitlines())
    other = np.random.default_rng(7).dirichlet(np.ones(v), size=k)
    save_checkpoint(str(day / "checkpoint.npz"), np.log(other), 0.75, 5,
                    [(-1.0, 1.0)] * 5)
    if rerun == "corpus remade":
        (day / "model.dat").unlink()
        rerun = ()
    rc, out = _main(_argv("dns", tmp_path / "two", *flags, *rerun), capsys)
    assert rc == 0
    assert any(r["stage"] == "lda" and "skipped" not in r for r in out)
    one = tmp_path / "one" / FDATE
    for name in ("final.beta", "final.gamma", "final.other",
                 "likelihood.dat", "dns_results.csv"):
        assert (one / name).read_bytes() == (day / name).read_bytes(), name
    assert not (day / "checkpoint.npz").exists()


def test_jax_written_features_pkl_is_refused(tmp_path):
    """The JAX runner's features.pkl names oni_ml_tpu.features.* classes:
    the port's score stage refuses it, saying pre must be re-run, and
    neither jax nor oni_ml_tpu is imported on the way."""
    import pickle

    from oni_ml_tpu.features import dns as jdns

    day = tmp_path / FDATE
    day.mkdir()
    with open(os.path.join(GOLDEN, "dns.csv")) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    with open(day / "features.pkl", "wb") as f:
        pickle.dump(jdns.featurize_dns(rows), f)
    code = (
        "import importlib.abc, json, sys\n"
        "def forbidden(n):\n"
        "    return n.split('.')[0] in ('jax', 'jaxlib', 'oni_ml_tpu')\n"
        "for n in [n for n in sys.modules if forbidden(n)]:\n"
        "    del sys.modules[n]\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if forbidden(name):\n"
        "            raise ImportError(f'port imported {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from oni_ml_tpu_torch.runner import ml_ops\n"
        f"rc = ml_ops.main(['{FDATE}', 'dns', '--data-dir', "
        f"{str(tmp_path)!r}, '--device', 'cpu', '--stages', 'score'])\n"
        "print(json.dumps([rc, sorted(n for n in sys.modules "
        "if forbidden(n))]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    err = json.loads(lines[-2])
    assert json.loads(lines[-1]) == [2, []]
    assert err["error"] == "missing_artifact"
    assert "oni_ml_tpu.features.dns.DnsFeatures" in err["detail"]
    assert "re-run pre" in err["detail"]
    assert "--stages pre --force" in err["detail"]


def test_journal_replay_matches_reference(tmp_path):
    """The port's journal: records replay in order; a truncated final
    line (a kill mid-append) drops silently, a damaged line elsewhere is
    counted; the JAX package's replay reads the same file alike, and
    completed_stages honours a forced run's boundary."""
    from oni_ml_tpu.telemetry import journal as jjournal
    from oni_ml_tpu_torch.telemetry import Journal, RunJournal

    path = str(tmp_path / "run_journal.jsonl")
    with Journal(path, fsync_every=2) as j:
        run = RunJournal(j)
        run.run_start(force=False, fdate=FDATE)
        run.stage_begin("pre")
        run.stage_end("pre", wall_s=1.5, events=40)
        run.stage_skipped("corpus", "outputs exist")
        run.em_likelihood(1, -10.0, 1.0)
    with open(path, "ab") as f:
        f.write(b'{"not json\n{"kind": "stage", "stage": "lda", '
                b'"status": "end"}\n{"kind": "stage", "sta')
    records, dropped = Journal.replay_report(path)
    assert (records, dropped) == jjournal.Journal.replay_report(path)
    assert dropped == 1
    assert [r.get("kind") for r in records] == [
        "run_start", "stage", "stage", "stage", "em_ll", "stage"]
    assert [r["seq"] for r in records[:5]] == list(range(5))
    assert RunJournal.completed_stages(records) == {"pre", "lda"}
    forced = str(tmp_path / "forced.jsonl")
    with Journal(forced) as j:
        RunJournal(j).stage_end("pre")
        RunJournal(j).run_start(force=True)
        RunJournal(j).stage_end("corpus")
    assert RunJournal.completed_stages(Journal.replay(forced)) == {"corpus"}
    assert Journal.replay(str(tmp_path / "none.jsonl")) == []
