"""The port's single-process device mesh around the trainers: the mesh
itself (parallel/mesh.py: make_mesh, local_mesh, is_local_mesh,
mesh_from_spec and the placement helpers, with the JAX package's error
texts), the mesh path of the device scorer (scoring/pipeline.py), the
data-parallel online trainer, `ml_ops --mesh` and a `--multihost --mesh`
world, on the CPU (every slot bound to the CPU), against the JAX
package where it has the same case:
- the scorer at (8, 1): scores and survivors bit-equal to the unmeshed
  scorer (tests/test_scoring_pipeline.py:317-370) and to the JAX mesh
  scorer, theta/p counted once in weight_h2d_bytes;
- online at (4, 1): lambda within rtol 2e-4 / atol 2e-4 of one slot
  (tests/test_online_lda.py:148-174, 381-396), and within the port's
  online bounds of the JAX mesh trainer from its lambda
  (tests/test_torch_online.py: likelihood 1e-5, lambda rtol 2e-4 +
  atol 1e-4);
- the runner at --mesh 2,4 on the golden flow day against the JAX
  runner's --mesh 2,4 from the JAX initial beta, within
  tests/test_torch_pipeline.py's bounds (likelihood 2e-5, gamma and
  alpha 2e-4, beta 2e-3 relative), and the CLI's run the same bytes as
  the library's;
- two CPU ranks of `--multihost --mesh 2,1` against one rank at the same
  --em-shards: the same bytes.
The mesh's card cases are in tests/test_torch_mesh_card.py (no JAX
there)."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import reference_lda as ref
from oni_ml_tpu import parallel as jpar
from oni_ml_tpu.config import (
    DataplaneConfig,
    LDAConfig as JLDAConfig,
    OnlineLDAConfig as JOnlineLDAConfig,
    PipelineConfig as JPipelineConfig,
    ScoringConfig as JScoringConfig,
    TelemetryConfig as JTelemetryConfig,
)
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.io import make_batches as jmake_batches
from oni_ml_tpu.models import OnlineLDATrainer as JTrainer
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.runner import ml_ops as jml_ops
from oni_ml_tpu.scoring import ScoringModel as JScoringModel
from oni_ml_tpu.scoring import chunked_scores as j_chunked
from oni_ml_tpu_torch import parallel as tpar
from oni_ml_tpu_torch.config import (LDAConfig, OnlineLDAConfig,
                                     PipelineConfig, ScoringConfig)
from oni_ml_tpu_torch.io import Corpus, formats, make_batches
from oni_ml_tpu_torch.models.online_lda import (OnlineLDATrainer,
                                                train_corpus_online)
from oni_ml_tpu_torch.parallel import mesh as tmesh
from oni_ml_tpu_torch.runner import ml_ops
from oni_ml_tpu_torch.scoring import (DispatchStats, ScoringModel,
                                      chunked_scores, filtered_flow_scores,
                                      filtered_scores)
from oni_ml_tpu_torch.scoring.score import _batched_scores

CPU = "cpu"
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GOLDEN = os.path.join(TESTS, "golden", "inputs", "flow.csv")
FDATE = "20160122"
DAY_FILES = ("final.beta", "final.gamma", "final.other", "likelihood.dat",
             "doc_results.csv", "word_results.csv", "flow_results.csv")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_make_mesh_errors_and_warning_match_jax():
    cpu = torch.device(CPU)
    with pytest.raises(ValueError, match=r"mesh 2x2 needs 4 devices, have 1"):
        tpar.make_mesh(2, 2, devices=[cpu])
    with pytest.raises(ValueError, match="3 devices not divisible by model=2"):
        tpar.make_mesh(-1, 2, devices=[cpu] * 3)
    with pytest.warns(UserWarning, match="uses 2 of 4 devices; 2 left idle"):
        tpar.make_mesh(2, 1, devices=[cpu] * 4)
    mesh = tpar.make_mesh(-1, 2, devices=[cpu] * 6)
    assert mesh.shape == {"data": 3, "model": 2}
    with pytest.raises(ValueError) as e:
        jpar.make_mesh(data=4, model=4)
    assert str(e.value) == "mesh 4x4 needs 16 devices, have 8"
    with pytest.raises(ValueError) as e:
        tpar.make_mesh(4, 4, devices=[cpu] * 8)
    assert str(e.value) == "mesh 4x4 needs 16 devices, have 8"


@pytest.mark.parametrize("spec", ["8", "2,x", "0,1", "1,2,3"])
def test_mesh_from_spec_messages_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jpar.mesh_from_spec(spec)
    with pytest.raises(ValueError) as got:
        tpar.mesh_from_spec(spec, device=CPU)
    assert str(got.value) == str(want.value)


def test_mesh_from_spec_and_local_mesh_on_the_cpu():
    mesh, vocab = tpar.mesh_from_spec("2,4", device=CPU)
    assert mesh.shape == {"data": 2, "model": 4} and vocab
    assert tpar.mesh_from_spec("8,1", device=CPU)[1] is False
    local = tpar.local_mesh(2, 1, device=CPU)
    assert tpar.is_local_mesh(local) and tpar.is_local_mesh(mesh)
    assert local.primary == torch.device(CPU)


def test_a_cuda_mesh_never_binds_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("asserts the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh(1, 1, devices=["cuda:0"])
    with pytest.raises(ValueError, match="one kind of device"):
        tmesh.Mesh(np.array([[torch.device(CPU), torch.device("meta")]],
                            dtype=object))


def test_placement_helpers_split_and_join():
    """Each JAX sharding's counterpart puts each slot's piece on its
    slot and joins back to the whole tensor; slots of one device that
    hold the same piece share it."""
    mesh = tpar.make_mesh(2, 4, device=CPU)
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for helper, piece in ((tpar.batch_sharding, (4, 12)),
                          (tpar.beta_sharding, (8, 3)),
                          (tpar.vocab_sharding, (2, 12)),
                          (tpar.replicated, (8, 12))):
        s = helper(mesh).put(x)
        assert tuple(s.block(1, 2).shape) == piece
        assert torch.equal(s.to_global(), x)
    b = tpar.batch_sharding(mesh).put(x)
    assert b.block(1, 0) is b.block(1, 3)
    stack = tpar.stacked_batch_sharding(mesh).put(x.reshape(3, 8, 4))
    parts = stack.unbind(0)
    assert [tuple(p.block(0).shape) for p in parts] == [(4, 4)] * 3
    assert torch.equal(parts[2].to_global(), x.reshape(3, 8, 4)[2])
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        tpar.batch_sharding(mesh).put(torch.zeros(5, 2))


def test_psum_is_a_fixed_pairwise_tree():
    """The mesh's psum adds in allreduce.tree_combine's order, so two
    calls give the same bits, and pmax is the max."""
    rng = np.random.default_rng(0)
    parts = [torch.tensor(rng.standard_normal(1000), dtype=torch.float32)
             for _ in range(7)]
    a, b = tmesh.psum(parts), tmesh.psum(list(parts))
    assert torch.equal(a, b)
    want = ((parts[0] + parts[1]) + (parts[2] + parts[3])) + (
        (parts[4] + parts[5]) + parts[6])
    assert torch.equal(a, want)
    assert torch.equal(tmesh.pmax(parts), torch.stack(parts).max(0).values)


# ---------------------------------------------------------------------------
# The mesh scorer (tests/test_scoring_pipeline.py:317-370)
# ---------------------------------------------------------------------------


def _model(k=20, d=300, v=200, seed=0):
    rng = np.random.default_rng(seed)
    theta, p = rng.random((d + 1, k)), rng.random((v + 1, k))
    return (ScoringModel(ip_index={}, theta=theta, word_index={}, p=p),
            JScoringModel(ip_index={}, theta=theta, word_index={}, p=p))


def _idx(model, n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, model.theta.shape[0], n).astype(np.int32),
            rng.integers(0, model.p.shape[0], n).astype(np.int32))


def _gap_threshold(scores):
    s = np.sort(np.unique(scores))
    mid = len(s) // 2
    i0, i1 = max(1, mid - 64), min(len(s), mid + 64)
    ratios = s[i0:i1] / s[i0 - 1: i1 - 1]
    j = int(np.argmax(ratios)) + i0
    assert s[j] / s[j - 1] > 1 + 1e-5, "no f32-safe gap in the sample"
    return float(np.sqrt(s[j] * s[j - 1]))


@pytest.fixture(scope="module")
def mesh8():
    return tpar.make_mesh(8, 1, device=CPU)


def test_sharded_scores_equal_single_device(mesh8):
    model, jmodel = _model(k=20, seed=23)
    ia, ib = _idx(model, 5000, seed=24)
    single = chunked_scores(model, ia, ib, chunk=1024, device=CPU)
    stats = DispatchStats()
    sharded = chunked_scores(model, ia, ib, chunk=1024, mesh=mesh8,
                             stats=stats)
    np.testing.assert_array_equal(sharded, single)
    np.testing.assert_allclose(sharded, _batched_scores(model, ia, ib),
                               rtol=1e-6)
    assert stats.chunk % 8 == 0                  # divisible by data axis
    want = j_chunked(jmodel, ia, ib, chunk=1024,
                     mesh=jpar.make_mesh(data=8, model=1))
    np.testing.assert_array_equal(sharded, want)


def test_sharded_filtered_equal_single_device(mesh8):
    model, _ = _model(k=20, seed=25)
    ia, ib = _idx(model, 5000, seed=26)
    threshold = _gap_threshold(_batched_scores(model, ia, ib))
    o1, s1 = filtered_scores(model, ia, ib, threshold, chunk=1024,
                             device=CPU)
    o2, s2 = filtered_scores(model, ia, ib, threshold, chunk=1024,
                             mesh=mesh8)
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(s1, s2)
    f1 = filtered_flow_scores(model, ia, ib, ia, ib, threshold, chunk=1024,
                              device=CPU)
    stats = DispatchStats()
    f2 = filtered_flow_scores(model, ia, ib, ia, ib, threshold, chunk=1024,
                              mesh=mesh8, stats=stats)
    for a, b in zip(f1, f2):
        np.testing.assert_array_equal(a, b)
    # Two sharded dots and the compaction per chunk, as the JAX mesh path
    # counts its programs.
    assert stats.dispatches == 3 * stats.chunks


def test_sharded_model_replicates_once(mesh8):
    model, _ = _model(seed=27)
    ia, ib = _idx(model, 2000, seed=28)
    stats = DispatchStats()
    chunked_scores(model, ia, ib, chunk=512, mesh=mesh8, stats=stats)
    once = stats.weight_h2d_bytes
    assert once == 4 * (model.theta.size + model.p.size)
    chunked_scores(model, ia, ib, chunk=512, mesh=mesh8, stats=stats)
    assert stats.weight_h2d_bytes == once


# ---------------------------------------------------------------------------
# Data-parallel online (tests/test_online_lda.py:148-174, 381-396)
# ---------------------------------------------------------------------------


def _online_problem():
    docs, _ = ref.make_synthetic_corpus(num_docs=64, num_terms=20,
                                        num_topics=2, seed=4)
    ptr, widx, cnts = [0], [], []
    for words, counts in docs:
        widx.extend(words.tolist())
        cnts.extend(counts.tolist())
        ptr.append(len(widx))
    kw = dict(doc_names=[f"ip{d}" for d in range(len(docs))],
              vocab=[f"w{i}" for i in range(20)],
              doc_ptr=np.asarray(ptr, np.int64),
              word_idx=np.asarray(widx, np.int32),
              counts=np.asarray(cnts, np.int32))
    common = dict(num_topics=3, batch_size=16, min_bucket_len=64, tau0=8.0,
                  seed=6)
    return (Corpus(**kw), JCorpus(**kw), OnlineLDAConfig(**common),
            JOnlineLDAConfig(**common))


def test_online_sharded_matches_single_device():
    corpus, jcorpus, cfg, jcfg = _online_problem()
    V = 20
    batches = make_batches(corpus, cfg.batch_size, cfg.min_bucket_len)
    single = OnlineLDATrainer(cfg, num_terms=V, total_docs=corpus.num_docs,
                              device=CPU)
    mesh = tpar.make_mesh(4, 1, device=CPU)
    sharded = OnlineLDATrainer(cfg, num_terms=V,
                               total_docs=corpus.num_docs, mesh=mesh)
    for b in batches:
        single.step(b)
        sharded.step(b)
    np.testing.assert_allclose(single.lam.numpy(), sharded.lam.numpy(),
                               rtol=2e-4, atol=2e-4)
    assert sharded.member(16, 64) == "per_batch:xla"
    # Vocab sharding is explicitly rejected for online mode, and so is a
    # forced dense E-step on a mesh.
    with pytest.raises(ValueError, match="data-parallel"):
        OnlineLDATrainer(cfg, num_terms=V, total_docs=10,
                         mesh=tpar.make_mesh(2, 2, device=CPU))
    import dataclasses

    with pytest.raises(ValueError, match="no mesh"):
        OnlineLDATrainer(dataclasses.replace(cfg, dense_em="on"),
                         num_terms=V, total_docs=10, mesh=mesh)
    # Against the JAX package's mesh trainer from its own lambda.
    jmesh = jpar.make_mesh(data=4, model=1, devices=jax.devices()[:4])
    jtr = JTrainer(jcfg, num_terms=V, total_docs=corpus.num_docs,
                   mesh=jmesh)
    ptr = OnlineLDATrainer(cfg, num_terms=V, total_docs=corpus.num_docs,
                           mesh=mesh, initial_lam=np.asarray(jtr.lam))
    for b, jb in zip(batches, jmake_batches(jcorpus, jcfg.batch_size,
                                            jcfg.min_bucket_len)):
        pi, ji = ptr.step(b), jtr.step(jb)
        np.testing.assert_allclose(float(pi.likelihood),
                                   float(ji.likelihood), rtol=1e-5)
    np.testing.assert_allclose(ptr.lam.numpy(), np.asarray(jtr.lam),
                               rtol=2e-4, atol=1e-4)


def test_step_many_sharded_matches_single_device():
    corpus, _, cfg, _ = _online_problem()
    V = 20
    batches = list(make_batches(corpus, cfg.batch_size, cfg.min_bucket_len))
    stream = (batches * 3)[:8]
    single = OnlineLDATrainer(cfg, num_terms=V, total_docs=corpus.num_docs,
                              device=CPU)
    single.step_many(stream, chunk=4)
    sharded = OnlineLDATrainer(cfg, num_terms=V,
                               total_docs=corpus.num_docs,
                               mesh=tpar.make_mesh(4, 1, device=CPU))
    sharded.step_many(stream, chunk=4)
    np.testing.assert_allclose(single.lam.numpy(), sharded.lam.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_train_corpus_online_pads_to_the_data_axis(tmp_path):
    corpus, _, cfg, _ = _online_problem()
    res = train_corpus_online(corpus, cfg, out_dir=str(tmp_path),
                              mesh=tpar.make_mesh(4, 1, device=CPU))
    assert all(b % 4 == 0 for b, _ in res.stats["batch_shapes"])
    assert res.stats["mesh"]["shape"] == [4, 1]
    assert (tmp_path / "final.beta").exists()


# ---------------------------------------------------------------------------
# The runner: --mesh 2,4 against the JAX runner, the CLI, --multihost
# ---------------------------------------------------------------------------

K, EM_ITERS, TOL = 20, 30, 1.1


@pytest.fixture(scope="module")
def mesh_days(tmp_path_factory):
    """The golden flow day through the JAX runner at --mesh 2,4 and
    through the port's run_pipeline on a (2, 4) CPU mesh from the JAX
    initial beta."""
    root = tmp_path_factory.mktemp("mesh_days")
    mp = pytest.MonkeyPatch()
    mp.setenv("ONI_ML_TPU_PLAN_CACHE", str(root / "plans.jsonl"))
    try:
        jcfg = JPipelineConfig(
            data_dir=str(root / "jax"), flow_path=GOLDEN,
            lda=JLDAConfig(num_topics=K, em_max_iters=EM_ITERS),
            scoring=JScoringConfig(threshold=TOL),
            telemetry=JTelemetryConfig(journal=False),
            dataplane=DataplaneConfig(enabled=False),
        )
        jmesh, jvocab = jpar.mesh_from_spec("2,4")
        jml_ops.run_pipeline(jcfg, FDATE, "flow", mesh=jmesh,
                             vocab_sharded=jvocab)
    finally:
        mp.undo()
    jday = root / "jax" / FDATE
    v = len(formats.read_words_dat(str(jday / "words.dat")))
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(0), K, v))
    cfg = PipelineConfig(data_dir=str(root / "port"), flow_path=GOLDEN,
                         lda=LDAConfig(num_topics=K, em_max_iters=EM_ITERS),
                         scoring=ScoringConfig(threshold=TOL))
    mesh, vocab = tpar.mesh_from_spec("2,4", device=CPU)
    recs = []
    ml_ops.run_pipeline(cfg, FDATE, "flow", device=CPU,
                        initial_log_beta=init, mesh=mesh,
                        vocab_sharded=vocab,
                        emit=lambda line, **_: recs.append(json.loads(line)))
    return root / "port" / FDATE, jday, recs


def test_runner_mesh_2_4_matches_jax_runner(mesh_days):
    port, ref_day, recs = mesh_days
    for name in ("word_counts.dat", "words.dat", "doc.dat", "model.dat"):
        assert (port / name).read_bytes() == (ref_day / name).read_bytes()
    ll_p = formats.read_likelihood(str(port / "likelihood.dat"))
    ll_r = formats.read_likelihood(str(ref_day / "likelihood.dat"))
    assert ll_p.shape == ll_r.shape
    np.testing.assert_allclose(ll_p[:, 0], ll_r[:, 0], rtol=2e-5)
    np.testing.assert_allclose(
        np.exp(formats.read_beta(str(port / "final.beta"))),
        np.exp(formats.read_beta(str(ref_day / "final.beta"))),
        rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(
        formats.read_gamma(str(port / "final.gamma")),
        formats.read_gamma(str(ref_day / "final.gamma")), rtol=2e-4)
    o_p = formats.read_other(str(port / "final.other"))
    o_r = formats.read_other(str(ref_day / "final.other"))
    assert (o_p["num_topics"], o_p["num_terms"]) == (o_r["num_topics"],
                                                     o_r["num_terms"])
    np.testing.assert_allclose(o_p["alpha"], o_r["alpha"], rtol=2e-4)
    rows_p = (port / "flow_results.csv").read_text().splitlines()
    rows_r = (ref_day / "flow_results.csv").read_text().splitlines()
    assert len(rows_p) == len(rows_r) > 0
    for a, b in zip(rows_p, rows_r):
        assert a.split(",")[:-2] == b.split(",")[:-2]
    lda = next(r for r in recs if r.get("stage") == "lda")
    assert lda["member"] == "vocab_sparse"
    assert lda["mesh"]["shape"] == [2, 4] and lda["mesh"]["vocab_sharded"]


def _cli_day(data, *extra):
    return [FDATE, "flow", "1.1", "--flow-path", GOLDEN, "--data-dir",
            str(data), "--device", CPU, "--em-max-iters", "10", *extra]


def test_cli_mesh_runs_the_library_mesh(tmp_path, capsys):
    """`ml_ops ... --mesh 2,4 --device cpu` writes the bytes run_pipeline
    writes on a (2, 4) CPU mesh, and its lda record names the mesh; a
    score stage under ONI_ML_TPU_SCORE=device runs over the mesh."""
    assert ml_ops.main(_cli_day(tmp_path / "cli", "--mesh", "2,4")) == 0
    out = capsys.readouterr().out
    lda = next(json.loads(l) for l in out.splitlines()
               if '"stage": "lda"' in l)
    assert lda["mesh"]["shape"] == [2, 4]
    assert lda["mesh"]["devices"] == [CPU] * 8
    cfg = PipelineConfig(data_dir=str(tmp_path / "lib"), flow_path=GOLDEN,
                         lda=LDAConfig(em_max_iters=10),
                         scoring=ScoringConfig(threshold=1.1))
    mesh, vocab = tpar.mesh_from_spec("2,4", device=CPU)
    ml_ops.run_pipeline(cfg, FDATE, "flow", device=CPU, mesh=mesh,
                        vocab_sharded=vocab, emit=lambda *a, **k: None)
    for name in DAY_FILES:
        assert ((tmp_path / "cli" / FDATE / name).read_bytes()
                == (tmp_path / "lib" / FDATE / name).read_bytes()), name


def test_cli_mesh_device_score_and_online(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("ONI_ML_TPU_SCORE", "device")
    assert ml_ops.main(_cli_day(tmp_path / "d", "--mesh", "4,1")) == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    score = next(r for r in recs if r.get("stage") == "score")
    assert score["engine"] == "device"
    assert score["score_dispatch"]["chunk"] % 4 == 0
    monkeypatch.delenv("ONI_ML_TPU_SCORE")
    assert ml_ops.main(_cli_day(tmp_path / "o", "--mesh", "4,1",
                                "--online")) == 0
    lda = next(json.loads(l) for l in capsys.readouterr().out.splitlines()
               if '"stage": "lda"' in l)
    assert lda["engine"] == "online" and lda["mesh"]["shape"] == [4, 1]
    with pytest.raises(ValueError, match="data-parallel meshes only"):
        ml_ops.main(_cli_day(tmp_path / "v", "--mesh", "2,2", "--online"))


def test_cli_mesh_errors_exit_2(tmp_path, capsys, monkeypatch):
    """A bad spec, and a spec the visible cards cannot fill (a one-card
    machine stood in for by the device list), exit 2 with the JAX
    runner's messages."""
    with pytest.raises(SystemExit) as e:
        ml_ops.main(_cli_day(tmp_path, "--mesh", "2,x"))
    assert e.value.code == 2
    assert "mesh spec must be two integers 'DATA,MODEL'" in \
        capsys.readouterr().err
    monkeypatch.setattr(tmesh, "_visible_devices",
                        lambda device: [torch.device("cuda", 0)])
    monkeypatch.setattr(tmesh, "_check_devices", lambda devices: None)
    with pytest.raises(SystemExit) as e:
        ml_ops.main(_cli_day(tmp_path, "--mesh", "2,2"))
    assert e.value.code == 2
    assert "mesh 2x2 needs 4 devices, have 1" in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(nprocs, argv):
    port = str(_free_port())
    base = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=port, WORLD_SIZE=str(nprocs),
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
                ONI_ML_TPU_ALLREDUCE_TIMEOUT_S="120")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "oni_ml_tpu_torch.runner.ml_ops", *argv],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for r in range(nprocs)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return outs


def test_multihost_mesh_two_ranks_same_bytes_as_one(tmp_path):
    """`--multihost --mesh 2,1`: each rank trains its shards over its own
    (2, 1) CPU mesh; two ranks write the bytes one rank writes at the
    same --em-shards."""
    days = {}
    for n in (1, 2):
        outs = _world(n, _cli_day(tmp_path / f"r{n}", "--multihost",
                                  "--em-shards", "8", "--mesh", "2,1"))
        days[n] = tmp_path / f"r{n}" / FDATE
        lda = next(json.loads(l) for l in outs[0].splitlines()
                   if '"stage": "lda"' in l)
        assert lda["driver"] == "distributed"
        assert lda["mesh"]["shape"] == [2, 1]
    for name in DAY_FILES:
        assert (days[1] / name).read_bytes() == (days[2] / name).read_bytes()
