"""The port's corpus window, warm start and window trainer
(oni_ml_tpu_torch/dataplane/window.py, models/lda.py
warm_start_log_beta and WindowTrainer) against the JAX package's, on
the CPU, at the JAX tests' own sizes and seeds (tests/test_streaming.py).

Tolerances: the window is host numpy, so its CSR arrays, vocabulary
order, capacity tiers and journal records are byte-equal to the JAX
window's; warm_start_log_beta is float64 numpy and bit-equal.  A window
fit runs float32 EM on both sides in another summation order, so on the
same window and the same initial beta the final likelihood agrees
within rel 1e-4, gamma within rel 2e-4 + abs 1e-4, and the EM iteration
counts within 1."""

import jax
import numpy as np
import pytest
import torch

from oni_ml_tpu.config import LDAConfig as JLDAConfig
from oni_ml_tpu.dataplane import CorpusWindow as JCorpusWindow
from oni_ml_tpu.dataplane import pow2_capacity as jpow2_capacity
from oni_ml_tpu.dataplane import word_count_columns as jword_count_columns
from oni_ml_tpu.io import Corpus as JCorpus
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.sources import get as jget_source
from oni_ml_tpu_torch.config import LDAConfig
from oni_ml_tpu_torch.dataplane import (CorpusWindow, pow2_capacity,
                                        word_count_columns)
from oni_ml_tpu_torch.io import Corpus
from oni_ml_tpu_torch.models import lda
from oni_ml_tpu_torch.models.lda import WindowTrainer, warm_start_log_beta
from oni_ml_tpu_torch.sources import get as get_source

CPU = "cpu"
RTOL_LL = 1e-4
RTOL_GAMMA, ATOL_GAMMA = 2e-4, 1e-4


class _J:
    def __init__(self):
        self.records = []

    def append(self, rec, sync=False):
        self.records.append(rec)


def _triples(rng, ips, words, n):
    return [(str(rng.choice(ips)), str(rng.choice(words)),
             int(rng.integers(1, 5))) for _ in range(n)]


def _unique_triples():
    rng = np.random.default_rng(0)
    ips = [f"ip{i}" for i in range(12)]
    words = [f"w{i}" for i in range(20)]
    out, seen = [], set()
    for t in _triples(rng, ips, words, 400):
        if (t[0], t[1]) not in seen:
            seen.add((t[0], t[1]))
            out.append(t)
    return out


# Each scenario: (window span, vocab floor, [("ingest", triples, t0, t1)
# | ("advance", now) | ("reserve", capacity)]), the op sequences of
# tests/test_streaming.py:62-166 plus a reserve and a long stream.
def _scenarios():
    trips = _unique_triples()
    third = len(trips) // 3
    rng = np.random.default_rng(5)
    long_ops = []
    for i in range(12):
        long_ops.append(("ingest", _triples(
            rng, [f"10.0.0.{j}" for j in range(30)],
            [f"w{j}" for j in range(40 + 10 * i)], 60), i * 50.0,
            i * 50.0 + 50.0))
        if i % 3 == 2:
            long_ops.append(("advance", i * 50.0 + 50.0))
    return {
        "batch": (1e9, 4, [("ingest", trips[:third], 0, 100),
                           ("ingest", trips[third:2 * third], 100, 200),
                           ("ingest", trips[2 * third:], 200, 300)]),
        "duplicates": (1e9, 4, [
            ("ingest", [("a", "x", 2), ("a", "y", 1)], 0, 10),
            ("ingest", [("a", "x", 3), ("b", "x", 1)], 10, 20)]),
        "eviction": (100.0, 4, [
            ("ingest", [("a", f"w{i}", 1) for i in range(10)], 0, 50),
            ("advance", 200.0),
            ("ingest", [("b", f"w{i}", 1) for i in range(5, 15)], 150,
             200)]),
        "advance": (100.0, 4, [
            *(("ingest", [("a", "x", 1)], i * 50, i * 50 + 50)
              for i in range(5)),
            ("advance", 300.0)]),
        "reserve": (1e9, 8, [("ingest", trips[:third], 0, 100),
                             ("reserve", 100), ("advance", 50.0),
                             ("ingest", trips[third:], 100, 200)]),
        "long": (200.0, 16, long_ops),
    }


def _drive(window_cls, span, floor, ops):
    j = _J()
    w = window_cls(span, vocab_floor=floor, journal=j)
    out = []
    for op in ops:
        if op[0] == "ingest":
            w.ingest_triples(op[1], op[2], op[3])
        elif op[0] == "advance":
            rec = dict(w.advance(op[1]))
            rec.pop("advance_s")
            out.append(rec)
        else:
            out.append(w.reserve_capacity(op[1]))
    return w, w.snapshot(), out, j.records


def _assert_snapshots_equal(got, ref):
    c, rc = got.corpus, ref.corpus
    assert c.doc_names == rc.doc_names
    assert c.vocab == rc.vocab
    for name in ("doc_ptr", "word_idx", "counts"):
        a, b = getattr(c, name), getattr(rc, name)
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    for name in ("real_vocab", "vocab_capacity", "t0", "t1", "chunks",
                 "rows"):
        assert getattr(got, name) == getattr(ref, name), name


@pytest.mark.parametrize("name", sorted(_scenarios()))
def test_window_snapshot_byte_equal_to_jax(name):
    span, floor, ops = _scenarios()[name]
    w, snap, out, recs = _drive(CorpusWindow, span, floor, ops)
    jw, jsnap, jout, jrecs = _drive(JCorpusWindow, span, floor, ops)
    _assert_snapshots_equal(snap, jsnap)
    assert out == jout
    strip = [{k: v for k, v in r.items() if k != "advance_s"}
             for r in recs]
    jstrip = [{k: v for k, v in r.items() if k != "advance_s"}
              for r in jrecs]
    assert strip == jstrip
    assert w._words.table == jw._words.table
    assert w._docs.table == jw._docs.table
    assert (w.vocab_size, w.vocab_capacity(), w.live_rows, w.live_chunks,
            w.evicted_chunks, w.evicted_rows, w.advances) == (
        jw.vocab_size, jw.vocab_capacity(), jw.live_rows, jw.live_chunks,
        jw.evicted_chunks, jw.evicted_rows, jw.advances)


def test_window_snapshot_matches_batch_corpus():
    trips = _unique_triples()
    span, floor, ops = _scenarios()["batch"]
    _, snap, _, _ = _drive(CorpusWindow, span, floor, ops)
    batch = Corpus.from_word_counts(trips)
    assert snap.corpus.vocab[:snap.real_vocab] == batch.vocab
    assert snap.corpus.doc_names == batch.doc_names
    np.testing.assert_array_equal(snap.corpus.word_idx, batch.word_idx)
    assert snap.vocab_capacity == pow2_capacity(batch.num_terms, 4)
    assert all(v.startswith("__pad")
               for v in snap.corpus.vocab[snap.real_vocab:])


@pytest.mark.parametrize("dsource", ["flow", "dns", "proxy"])
def test_window_columnar_ingest_byte_equal_to_jax(dsource):
    """Three slices of a synthetic day through each package's featurizer
    with pinned cuts and word_count_columns, into each window."""
    spec, jspec = get_source(dsource), jget_source(dsource)
    lines = spec.synth_benign(660, seed=3)
    assert lines == jspec.synth_benign(660, seed=3)
    cuts = spec.derive_cuts(lines[:220])
    jcuts = jspec.derive_cuts(lines[:220])
    w = CorpusWindow(1e9, vocab_floor=64)
    jw = JCorpusWindow(1e9, vocab_floor=64)
    for i in range(3):
        part = lines[i * 220:(i + 1) * 220]
        w.ingest(word_count_columns(spec.featurize(
            part, skip_header=False, precomputed_cuts=cuts)), i, i + 1)
        jw.ingest(jword_count_columns(jspec.featurize(
            part, skip_header=False, precomputed_cuts=jcuts)), i, i + 1)
    _assert_snapshots_equal(w.snapshot(), jw.snapshot())


def test_window_empty_snapshot_and_disorder_like_jax():
    for cls in (CorpusWindow, JCorpusWindow):
        w = cls(100.0, vocab_floor=8)
        snap = w.snapshot()
        assert snap.corpus.num_docs == 0 and snap.vocab_capacity == 8
        w.ingest_triples([("a", "x", 1)], 0, 50)
        with pytest.raises(ValueError, match="stream order"):
            w.ingest_triples([("a", "y", 1)], 0, 40)
        with pytest.raises(ValueError, match="inverted"):
            w.ingest_triples([("a", "y", 1)], 90, 80)
        with pytest.raises(ValueError, match="span"):
            cls(0.0)


def test_pow2_capacity_equals_jax():
    for n in (0, 1, 3, 7, 8, 9, 16, 17, 999, 1000, 1024, 4097):
        for floor in (0, 1, 3, 8, 12, 512, 4096):
            assert pow2_capacity(n, floor) == jpow2_capacity(n, floor)


# ---------------------------------------------------------------------------
# warm_start_log_beta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,v0,v1", [(4, 10, 16), (3, 12, 12), (20, 50, 512)])
def test_warm_start_log_beta_bit_equal(k, v0, v1):
    rng = np.random.default_rng(1)
    p = rng.dirichlet(np.ones(v0), size=k).T       # [V0, K]
    p[0, 0] = 0.0                                  # a LOG_ZERO entry
    got = warm_start_log_beta(p, v1)
    ref = jlda.warm_start_log_beta(p, v1)
    assert got.dtype == ref.dtype == np.float64
    assert got.tobytes() == np.asarray(ref).tobytes()


def test_warm_start_log_beta_refusals_like_jax():
    p = np.full((8, 4), 1.0 / 8)
    for fn in (warm_start_log_beta, jlda.warm_start_log_beta):
        with pytest.raises(ValueError, match="shrink"):
            fn(p, 4)
        with pytest.raises(ValueError, match="finite"):
            fn(np.full((8, 4), np.nan), 8)
        with pytest.raises(ValueError, match=r"\[V, K\]"):
            fn(np.ones(8), 8)


# ---------------------------------------------------------------------------
# WindowTrainer
# ---------------------------------------------------------------------------


def _structured_triples(rng, docs=60, v=64, k=3, tokens=30):
    trips = []
    block = v // k
    for d in range(docs):
        t = d % k
        for _ in range(tokens):
            if rng.random() < 0.9:
                wid = t * block + int(rng.integers(0, block))
            else:
                wid = int(rng.integers(0, v))
            trips.append((f"ip{d}", f"w{wid}", 1))
    return trips


def _cfgs(**kw):
    base = dict(num_topics=3, batch_size=64, fused_em_chunk=1,
                em_max_iters=60, seed=1)
    base.update(kw)
    return LDAConfig(**base), JLDAConfig(**base)


def _assert_fits_close(got, ref):
    assert abs(got.em_iters - ref.em_iters) <= 1
    np.testing.assert_allclose(got.likelihoods[-1][0],
                               ref.likelihoods[-1][0], rtol=RTOL_LL)
    np.testing.assert_allclose(got.gamma, np.asarray(ref.gamma),
                               rtol=RTOL_GAMMA, atol=ATOL_GAMMA)


def _jax_init(monkeypatch, cfg, v):
    """The port's fresh init replaced by the JAX package's threefry draw
    for the same seed (the two RNGs differ; ROADMAP Queue 3 spot 5)."""
    init = np.asarray(jlda.init_log_beta(jax.random.PRNGKey(cfg.seed),
                                         cfg.num_topics, v))
    monkeypatch.setattr(lda, "init_log_beta",
                        lambda gen, k, v, device="cpu":
                        torch.as_tensor(init.copy()).to(device))


def test_window_trainer_fresh_and_warm_match_jax(monkeypatch):
    trips = _structured_triples(np.random.default_rng(3))
    corpus, jcorpus = Corpus.from_word_counts(trips), \
        JCorpus.from_word_counts(trips)
    cfg, jcfg = _cfgs()
    _jax_init(monkeypatch, cfg, corpus.num_terms)
    tr = WindowTrainer(cfg, corpus.num_terms, device=CPU)
    jtr = jlda.WindowTrainer(jcfg, jcorpus.num_terms)
    fresh, jfresh = tr.fit(corpus), jtr.fit(jcorpus)
    _assert_fits_close(fresh, jfresh)
    assert fresh.plan["warm_start"] == {"value": False, "source": "window"}
    # The same seed topics and alpha on both sides: the JAX fit's.
    probs = np.exp(np.asarray(jfresh.log_beta)).T
    warm = tr.fit(corpus, topic_probs=probs, alpha=jfresh.alpha)
    jwarm = jtr.fit(jcorpus, topic_probs=probs, alpha=jfresh.alpha)
    _assert_fits_close(warm, jwarm)
    assert warm.plan["warm_start"]["value"] is True
    assert warm.em_iters < fresh.em_iters / 2
    assert jwarm.em_iters < jfresh.em_iters / 2
    assert tr.fits == 2
    # The CPU resolves the dense family, per batch through the plain
    # ops, once per tier.
    assert fresh.plan["estep_engine"] == {"value": "dense",
                                          "source": "default",
                                          "resolved": True}
    assert warm.plan["estep_engine"]["resolved"] is False
    assert warm.stats["member"] == "per_batch:xla"


def test_window_trainer_warm_start_grown_vocab_matches_jax():
    """A warm start whose seed covers fewer words than the window (the
    window grew inside its tier): the pad rows start at the prior."""
    rng = np.random.default_rng(4)
    trips = _structured_triples(rng, docs=40, v=60)
    corpus, jcorpus = Corpus.from_word_counts(trips), \
        JCorpus.from_word_counts(trips)
    cfg, jcfg = _cfgs(em_max_iters=40)
    probs = rng.dirichlet(np.ones(corpus.num_terms - 5), size=3).T
    got = WindowTrainer(cfg, corpus.num_terms, device=CPU).fit(
        corpus, topic_probs=probs, alpha=1.5)
    ref = jlda.WindowTrainer(jcfg, jcorpus.num_terms).fit(
        jcorpus, topic_probs=probs, alpha=1.5)
    _assert_fits_close(got, ref)


def test_window_trainer_rejects_wrong_tier_and_collective(monkeypatch):
    """A corpus outside the trainer's tier is refused, with a collective
    too; and a collective (one rank) no longer is: the refresh trains
    distributed over the shard plan, as the JAX WindowTrainer with its
    one-rank collective does, fresh and warm."""
    from oni_ml_tpu.parallel.allreduce import Collective as JCollective
    from oni_ml_tpu_torch.parallel import Collective

    cfg, jcfg = _cfgs()
    corpus = Corpus.from_word_counts(
        _structured_triples(np.random.default_rng(4), docs=10, v=32))
    for coll in (None, Collective(rank=0, nprocs=1)):
        with pytest.raises(ValueError, match="capacity tier"):
            WindowTrainer(cfg, 64, device=CPU, collective=coll).fit(corpus)
    trips = _structured_triples(np.random.default_rng(3))
    corpus, jcorpus = Corpus.from_word_counts(trips), \
        JCorpus.from_word_counts(trips)
    _jax_init(monkeypatch, cfg, corpus.num_terms)
    tr = WindowTrainer(cfg, corpus.num_terms, device=CPU,
                       collective=Collective(rank=0, nprocs=1))
    jtr = jlda.WindowTrainer(jcfg, jcorpus.num_terms,
                             collective=JCollective(rank=0, nprocs=1))
    fresh, jfresh = tr.fit(corpus), jtr.fit(jcorpus)
    _assert_fits_close(fresh, jfresh)
    probs = np.exp(np.asarray(jfresh.log_beta)).T
    warm = tr.fit(corpus, topic_probs=probs, alpha=jfresh.alpha)
    jwarm = jtr.fit(jcorpus, topic_probs=probs, alpha=jfresh.alpha)
    _assert_fits_close(warm, jwarm)
    assert warm.em_iters < fresh.em_iters / 2
    for res, jres in ((fresh, jfresh), (warm, jwarm)):
        assert res.stats["driver"] == "distributed"
        assert res.plan["em_shards"] == jres.plan["em_shards"]
        assert res.plan["allreduce"] == jres.plan["allreduce"]


@pytest.mark.parametrize("chunk", [1, 4])
def test_window_trainer_yield_hook_slots(chunk):
    """The stepwise driver enters one slot per EM iteration, the chunk
    driver one per chunk dispatch; the fit is unchanged by the hook."""
    from contextlib import contextmanager

    trips = _structured_triples(np.random.default_rng(6), docs=30)
    corpus = Corpus.from_word_counts(trips)
    cfg, _ = _cfgs(fused_em_chunk=chunk, host_sync_every=chunk,
                   em_max_iters=12)
    slots = []

    @contextmanager
    def hook():
        slots.append(1)
        yield

    plain = WindowTrainer(cfg, corpus.num_terms, device=CPU).fit(corpus)
    hooked = WindowTrainer(cfg, corpus.num_terms, device=CPU,
                           yield_hook=hook).fit(corpus)
    np.testing.assert_array_equal(plain.log_beta, hooked.log_beta)
    if chunk == 1:
        assert len(slots) == hooked.em_iters
    else:
        assert len(slots) == hooked.stats["dispatches"]
        assert len(slots) == -(-hooked.em_iters // chunk)


def test_window_config_batches_pad_to_full_batch():
    """Window batches pad to the full batch size at the window's length
    floor, as the JAX WindowTrainer's do."""
    from oni_ml_tpu.io import make_batches as jmake_batches
    from oni_ml_tpu_torch.io import make_batches

    trips = _structured_triples(np.random.default_rng(7), docs=70)
    corpus, jcorpus = Corpus.from_word_counts(trips), \
        JCorpus.from_word_counts(trips)
    got = make_batches(corpus, batch_size=64, min_bucket_len=64)
    ref = jmake_batches(jcorpus, batch_size=64, min_bucket_len=64)
    assert [b.word_idx.shape for b in got] == [b.word_idx.shape for b in ref]
    assert all(b.word_idx.shape[0] == 64 for b in got)
