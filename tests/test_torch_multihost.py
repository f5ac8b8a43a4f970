"""Multi-process distributed EM in the port (`ml_ops --multihost`,
models/lda.py's distributed driver, the online trainer's distributed
step, `WindowTrainer(collective=)`, `continuous --multihost`) on the CPU,
in spawned worlds of one and two rank processes.

- The golden flow day through `ml_ops ... --multihost --em-shards 8` on
  one rank and on two: final.*, likelihood.dat and the results CSVs
  byte for byte the same (the shard plan and the reduction tree do not
  depend on the rank count); the same with the sparse engine pinned.
- The same day's corpus through the port's `train_corpus(distributed=
  True)` against the JAX package's, both in one process at 8 shards from
  the JAX initial beta, within the tolerances tests/test_torch_pipeline.py
  states for the plain day (likelihood 2e-5, gamma and alpha 2e-4, beta
  2e-3 relative).
- A rank whose lda stage fails: the other exits 3 with "failed on another
  rank", both within the time limit.
- `--online`: two ranks against one within rel 1e-4 per micro-batch.
- `WindowTrainer(collective=)` on one rank and two: the same bits.
- `continuous --multihost` on one rank and two: every rank's model
  digests the same, refresh for refresh.

Every rank runs with OMP_NUM_THREADS=1 and under its own time limit."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.io import Corpus, formats
from oni_ml_tpu_torch.models.lda import train_corpus
from oni_ml_tpu_torch.parallel import Collective

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GOLDEN = os.path.join(TESTS, "golden", "inputs", "flow.csv")
FDATE = "20160122"
WAIT_S = 240.0
DAY_FILES = ("final.beta", "final.gamma", "final.other", "likelihood.dat",
             "doc_results.csv", "word_results.csv", "flow_results.csv")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(nprocs, argvs, env=None):
    """Run `python -m oni_ml_tpu_torch.runner.ml_ops argvs[r]` as rank r
    of a world of `nprocs` (torchrun's variables); (returncode, output)
    per rank."""
    port = str(_free_port())
    base = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=port, WORLD_SIZE=str(nprocs),
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
                ONI_ML_TPU_ALLREDUCE_TIMEOUT_S="120", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops",
         *argvs[r]], env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for r in range(nprocs)]
    try:
        outs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _day(data, *extra):
    return [FDATE, "flow", "1.1", "--flow-path", GOLDEN, "--data-dir",
            str(data), "--device", "cpu", "--multihost", "--em-shards", "8",
            *extra]


def _run_day(data, nprocs, *extra, env=None):
    results = _world(nprocs, [_day(data, *extra)] * nprocs, env)
    for rc, out in results:
        assert rc == 0, out[-3000:]
    return data / FDATE, results


def _lda(out: str) -> dict:
    for line in out.splitlines():
        if line.startswith("{") and '"stage": "lda"' in line:
            return json.loads(line)
    raise AssertionError(f"no lda record in {out[-2000:]}")


@pytest.fixture(scope="module")
def days(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    return {n: _run_day(root / f"d{n}", n) for n in (1, 2)}


def test_golden_day_bytes_identical_on_one_and_two_ranks(days):
    (one, r1), (two, r2) = days[1], days[2]
    for name in DAY_FILES:
        assert (one / name).read_bytes() == (two / name).read_bytes(), name
    recs = [_lda(out) for _, out in r1 + r2]
    assert [r["allreduce"]["transport"] for r in recs] == \
        ["local", "kvring", "kvring"]
    assert all(r["driver"] == "distributed" for r in recs)
    assert all(r["em_shards"] == {"value": 8, "source": "config"}
               for r in recs)
    assert len({(r["final_likelihood"], r["em_iters"]) for r in recs}) == 1
    # Two ranks: one reduce per EM iteration plus the gamma merge.
    assert recs[1]["allreduce"]["ops"] == recs[1]["em_iters"] + 1
    # Rank 0 alone writes the day's files and metrics.
    metrics = json.load(open(two / "metrics.json"))
    assert [r["stage"] for r in metrics][:4] == ["pre", "corpus", "lda",
                                                 "score"]


def test_sparse_engine_survives_distribution(tmp_path):
    env = {"ONI_ML_TPU_ESTEP": "sparse"}
    one, r1 = _run_day(tmp_path / "s1", 1, env=env)
    two, r2 = _run_day(tmp_path / "s2", 2, env=env)
    for name in DAY_FILES:
        assert (one / name).read_bytes() == (two / name).read_bytes(), name
    recs = [_lda(out) for _, out in r1 + r2]
    assert all(r["engine"] == "sparse" and r["member"] == "sparse"
               for r in recs)


def test_distributed_day_matches_jax_distributed(days):
    """The port's distributed fit and the JAX package's, each in one
    process at 8 shards, from the JAX initial beta on the same corpus."""
    day = days[1][0]
    paths = [str(day / n) for n in ("model.dat", "words.dat", "doc.dat")]
    corpus, jcorpus = Corpus.from_model_dat(*paths), \
        JCorpus.from_model_dat(*paths)
    kw = dict(num_topics=20, em_max_iters=30, em_shards=8)
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), 20,
                                         corpus.num_terms))
    got = train_corpus(corpus, LDAConfig(**kw), device="cpu",
                       distributed=True, initial_log_beta=init,
                       collective=Collective(rank=0, nprocs=1))
    ref = jlda.train_corpus(jcorpus, JLDAConfig(**kw), distributed=True)
    assert got.plan["em_shards"] == ref.plan["em_shards"]
    assert got.stats["driver"] == "distributed"
    np.testing.assert_allclose([ll for ll, _ in got.likelihoods],
                               [ll for ll, _ in ref.likelihoods],
                               rtol=2e-5)
    np.testing.assert_allclose(np.exp(got.log_beta),
                               np.exp(np.asarray(ref.log_beta)),
                               rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(got.gamma, np.asarray(ref.gamma), rtol=2e-4)
    np.testing.assert_allclose(got.alpha, float(ref.alpha), rtol=2e-4)


def test_rank_failure_exits_three_on_the_other_rank(tmp_path):
    """Rank 1 asks for one shard, fewer than the two processes: its lda
    stage raises before any reduce and posts the failure; rank 0, waiting
    in the reduce, exits 3 with the runner's backend_lost record."""
    data = tmp_path / "f"
    (rc0, out0), (rc1, out1) = _world(2, [
        _day(data), _day(data)[:-1] + ["1"]])
    assert rc0 == 3, out0[-3000:]
    assert "failed on another rank" in out0
    assert json.loads(out0.strip().splitlines()[-1])["error"] == \
        "backend_lost"
    assert rc1 not in (0, 3) and "em_shards=1 < 2" in out1


def test_online_two_ranks_match_one(tmp_path):
    one, r1 = _run_day(tmp_path / "o1", 1, "--online")
    two, r2 = _run_day(tmp_path / "o2", 2, "--online")
    a = formats.read_likelihood(str(two / "likelihood.dat"))[:, 0]
    b = formats.read_likelihood(str(one / "likelihood.dat"))[:, 0]
    np.testing.assert_allclose(a, b, rtol=1e-4)
    np.testing.assert_allclose(np.exp(formats.read_beta(
        str(two / "final.beta"))), np.exp(formats.read_beta(
            str(one / "final.beta"))), rtol=1e-4, atol=1e-9)
    recs = [_lda(out) for _, out in r2]
    assert recs[0]["final_likelihood"] == recs[1]["final_likelihood"]
    assert [r["allreduce"]["transport"] for r in recs] == ["kvring"] * 2
    assert _lda(r1[0][1])["allreduce"]["transport"] == "local"


def _window_world(tmp_path, nprocs):
    kv = tmp_path / f"kv{nprocs}"
    outs = [str(tmp_path / f"w{nprocs}_{r}.npz") for r in range(nprocs)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_collective_worker.py"),
         "file", str(kv), str(r), str(nprocs), "window", outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nprocs)]
    try:
        logs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


def test_window_trainer_refits_the_same_on_one_and_two_ranks(tmp_path):
    one = _window_world(tmp_path, 1)
    two = _window_world(tmp_path, 2)
    for fits in two:
        for key, value in one[0].items():
            assert fits[key].tobytes() == value.tobytes(), key
    assert one[0]["warm_em_iters"] < one[0]["fresh_em_iters"]


def test_continuous_multihost_ranks_publish_the_same_models(tmp_path):
    from test_torch_continuous import CLI_FLAGS, _write_day

    day = tmp_path / "day.csv"
    _write_day(day, 13)
    digests = {}
    for nprocs in (1, 2):
        results = _world(nprocs, [
            ["continuous", "flow", "--flow-path", str(day), "--data-dir",
             str(tmp_path / f"c{nprocs}_{r}"), "--multihost", *CLI_FLAGS]
            for r in range(nprocs)])
        for rc, out in results:
            assert rc == 0, out[-3000:]
        payloads = [json.loads(out.strip().splitlines()[-1])
                    for _, out in results]
        for p in payloads:
            assert p["publishes"] >= 2 and not p.get("refresh_errors")
        digests[nprocs] = [[(r["refresh"], r["model_sha256"], r["published"])
                            for r in p["refresh_records"]]
                           for p in payloads]
    assert digests[2][0] == digests[2][1]
    assert digests[1][0] == digests[2][0]
