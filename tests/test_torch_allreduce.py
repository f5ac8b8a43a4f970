"""The port's shard plan and collective (oni_ml_tpu_torch/parallel/
shard_plan.py, allreduce.py, mesh.py) against the JAX package's, on the
CPU.

- `plan_shards` / `resolve_em_shards`: the same records (and the same
  refusals) over a grid of documents x processes x shards.
- `tree_combine` / `reduce_partials`: bit-identical to the JAX functions
  on the same seeded numpy partials, for aligned and unaligned plans, at
  every rank and every rank count (each rank's payload gathered and
  handed to every rank, as a transport would).
- The bf16 wire pack: the JAX pack's bits, NaN kept a NaN.
- The wire: a JSON header and raw bytes, no pickle; a frame that lies
  about its size is refused.
- Real worlds of 2 and 3 processes on the kvring over a FileKVClient and
  over the TCP KV, and on gloo (psum): allgather_arrays (chunked at 256
  characters a KV value), a bf16 allgather, broadcast_obj,
  broadcast_arrays, allgather_obj and barrier; a posted failure raising
  PeerFailure in each peer; a peer that leaves without posting timing
  out as PeerFailure under ONI_ML_TPU_ALLREDUCE_TIMEOUT_S=4 (the other
  scenarios wait up to 120 s, so a rank that starts late on a loaded
  host is not taken for a dead one).  Every subprocess has its own time
  limit (WAIT_S).

Tolerances: none; every comparison is exact."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from oni_ml_tpu.parallel import allreduce as jallreduce
from oni_ml_tpu.parallel import shard_plan as jshard_plan
from oni_ml_tpu_torch.parallel import KVServer, allreduce, shard_plan

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_collective_worker.py")
WAIT_S = 180.0
TIMEOUT_S = {"kill": "4", "ops": "120", "fail": "120"}


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "err", str(e)


@pytest.mark.parametrize("num_docs", [0, 1, 7, 8, 80, 1001])
def test_plan_shards_equals_jax(num_docs):
    for procs in (1, 2, 3, 4, 8, 9):
        for shards in (0, 1, 3, 8, 16):
            got = _outcome(shard_plan.plan_shards, num_docs, procs, shards)
            ref = _outcome(jshard_plan.plan_shards, num_docs, procs, shards)
            assert got[0] == ref[0], (num_docs, procs, shards)
            if got[0] == "err":
                assert got[1] == ref[1]
                continue
            g, r = got[1], ref[1]
            assert (g.bounds, g.owners, g.aligned) == (r.bounds, r.owners,
                                                       r.aligned)
            for rank in range(procs):
                assert g.record(rank) == r.record(rank)


def test_resolve_em_shards_equals_jax(monkeypatch):
    for env in ("", "4", "16"):
        monkeypatch.setenv("ONI_ML_TPU_EM_SHARDS", env)
        for value in (0, 1, 2, 8, 32):
            for procs in (1, 2, 3, 8, 9, 17):
                got = _outcome(shard_plan.resolve_em_shards, value, procs)
                ref = _outcome(jshard_plan.resolve_em_shards, value, procs)
                assert got == ref, (env, value, procs)


def _partials(num_shards, seed):
    rng = np.random.default_rng(seed)
    return {s: {"suff_stats": rng.standard_normal((53, 7)).astype(np.float32)
                * np.float32(10.0 ** rng.integers(-3, 4)),
                "likelihood": np.asarray(rng.standard_normal() * 1e4,
                                         np.float32),
                "alpha_ss": np.asarray(rng.standard_normal(), np.float32)}
            for s in range(num_shards)}


def test_tree_combine_bit_identical_to_jax():
    for n in range(1, 12):
        parts = _partials(n, n)
        got = allreduce.tree_combine([parts[s] for s in range(n)])
        ref = jallreduce.tree_combine([parts[s] for s in range(n)])
        for k in ref:
            assert np.asarray(got[k]).tobytes() == np.asarray(ref[k]).tobytes()
        arrays = [parts[s]["suff_stats"] for s in range(n)]
        assert (allreduce.tree_combine(arrays).tobytes()
                == jallreduce.tree_combine(arrays).tobytes())
    with pytest.raises(ValueError):
        allreduce.tree_combine([])


class _Capture:
    """A stand-in collective: records the payload a rank would send."""

    class Sent(Exception):
        pass

    def allgather_arrays(self, named, tag, precision=None):
        self.named = named
        raise self.Sent


class _Deliver:
    """A stand-in collective: hands a rank every rank's payload."""

    def __init__(self, payloads):
        self.payloads = payloads

    def allgather_arrays(self, named, tag, precision=None):
        return [dict(p) for p in self.payloads]


def _reduce_everywhere(mod, plan, parts):
    """Each rank's reduce_partials result, its owned shards' partials in,
    every rank's payload delivered to every rank."""
    payloads = []
    for r in range(plan.num_procs):
        cap = _Capture()
        with pytest.raises(_Capture.Sent):
            mod.reduce_partials(cap, plan, {s: parts[s] for s in
                                            plan.owned(r)}, "t")
        payloads.append(cap.named)
    return [mod.reduce_partials(_Deliver(payloads), plan,
                                {s: parts[s] for s in plan.owned(r)}, "t")
            for r in range(plan.num_procs)]


@pytest.mark.parametrize("num_shards,procs", [(8, 1), (8, 2), (8, 4),
                                              (8, 8), (8, 3), (6, 4),
                                              (5, 2), (16, 3)])
def test_reduce_partials_bit_identical_to_jax(num_shards, procs):
    """The port's reduce equals the JAX reduce bit for bit on every rank;
    an aligned plan's result is also the one-rank result (rank-count
    invariance), and an unaligned one reduces per shard."""
    parts = _partials(num_shards, 7 * num_shards + procs)
    plan = shard_plan.plan_shards(97, procs, num_shards)
    jplan = jshard_plan.plan_shards(97, procs, num_shards)
    got = _reduce_everywhere(allreduce, plan, parts)
    ref = _reduce_everywhere(jallreduce, jplan, parts)
    one = allreduce.tree_combine([parts[s] for s in range(num_shards)])
    for g, r in zip(got, ref):
        for k in r:
            assert np.asarray(g[k]).tobytes() == np.asarray(r[k]).tobytes()
            assert np.asarray(g[k]).tobytes() == np.asarray(one[k]).tobytes()


def test_bf16_pack_bit_identical_to_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32) * 1e3
    bits = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(
        np.uint32).view(np.float32)           # NaNs, infs, subnormals
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                        1e-40, 3.4e38], np.float32)
    for a in (x, bits, special, x.reshape(64, 64), np.float32(1.5),
              x.astype(np.float64)):
        got, ref = allreduce._bf16_pack(a), jallreduce._bf16_pack(a)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()
        un, jun = allreduce._bf16_unpack(got), jallreduce._bf16_unpack(ref)
        assert un.tobytes() == jun.tobytes()
    assert np.isnan(allreduce._bf16_unpack(
        allreduce._bf16_pack(np.float32(np.nan))))


def test_wire_is_json_header_and_raw_bytes():
    named = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.float64(2.5), "c": np.array([True, False]),
             "d": np.arange(3, dtype=np.int64)}
    frame = allreduce.encode_arrays(named)
    (n,) = allreduce._HLEN.unpack_from(frame)
    head = json.loads(frame[allreduce._HLEN.size:allreduce._HLEN.size + n])
    assert [e["name"] for e in head["arrays"]] == list(named)
    assert b"pickle" not in frame and b"\x80\x04" not in frame[:2]
    back = allreduce.decode_arrays(frame)
    for k, v in named.items():
        assert back[k].dtype == np.asarray(v).dtype
        assert back[k].tobytes() == np.asarray(v).tobytes()
    packed = allreduce.decode_arrays(allreduce.encode_arrays(named, "bf16"))
    assert packed["a"].dtype == np.float32 and packed["d"].dtype == np.int64
    with pytest.raises(ValueError):
        allreduce.decode_arrays(frame[:-1])
    with pytest.raises(ValueError):
        allreduce.decode_arrays(frame + b"\0")
    with pytest.raises(TypeError):
        allreduce.encode_arrays({"o": np.array([object()])})


def test_one_process_collective_is_the_identity():
    coll = allreduce.Collective(rank=0, nprocs=1)
    assert coll.transport == "local"
    named = {"x": np.arange(3, dtype=np.float32)}
    assert coll.allgather_arrays(named, "t")[0]["x"] is not None
    assert coll.broadcast_obj({"a": 1}, "b") == {"a": 1}
    assert coll.allgather_obj(5, "o") == [5]
    coll.barrier("b")
    assert coll.stats["ops"] == 0
    with pytest.raises(ValueError):
        allreduce.Collective(rank=0, nprocs=1, transport="ring")
    with pytest.raises(ValueError):
        allreduce.Collective(rank=0, nprocs=2, transport="local",
                             client=object())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(tmp_path, kind, nprocs, scenario):
    """Run one world of `nprocs` worker processes; their JSON results."""
    server = None
    if kind == "file":
        spec = str(tmp_path / "kv")
    elif kind == "tcp":
        server = KVServer()
        spec = f"{server.host}:{server.port}"
    else:
        spec = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               ONI_ML_TPU_ALLREDUCE_TIMEOUT_S=TIMEOUT_S[scenario])
    outs = [str(tmp_path / f"r{r}.json") for r in range(nprocs)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, kind, spec, str(r), str(nprocs), scenario,
         outs[r]], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nprocs)]
    try:
        logs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if server is not None:
            server.close()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.load(open(o)) if os.path.exists(o) else None for o in outs]


KINDS = ["file", "tcp", "gloo"]


@pytest.mark.parametrize("nprocs", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_world_ops(tmp_path, kind, nprocs):
    from torch_collective_worker import _payload

    res = _world(tmp_path, kind, nprocs, "ops")
    want = [_payload(r) for r in range(nprocs)]
    for r, got in enumerate(res):
        assert got["transport"] == ("psum" if kind == "gloo" else "kvring")
        assert len(got["gathered"]) == nprocs
        for g, dt, w in zip(got["gathered"], got["dtypes"], want):
            for k, v in w.items():
                assert dt[k] == str(np.asarray(v).dtype), (k, dt[k])
                assert np.array_equal(np.asarray(g[k], dtype=dt[k]),
                                      np.asarray(v)), k
        packed = [allreduce._bf16_unpack(allreduce._bf16_pack(
            w["suff_stats"])) for w in want]
        if kind == "gloo":     # psum gathers raw words: no wire to pack
            packed = [w["suff_stats"] for w in want]
        assert got["bf16_applied"] == ("f32" if kind == "gloo" else "bf16")
        assert all(np.array_equal(np.asarray(b, np.float32), p)
                   for b, p in zip(got["bf16"], packed))
        assert got["bcast"] == {"engine": "sparse", "rank": 0}
        assert got["bcast_arrays"] == (np.arange(5) / 3).tolist()
        assert got["allgather_obj"] == [[q, "r"] for q in range(nprocs)]
        assert got["stats"]["ops"] == 2
        assert got["stats"]["bytes_out"] > 0


@pytest.mark.parametrize("scenario", ["fail", "kill"])
@pytest.mark.parametrize("nprocs", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_world_peer_failure(tmp_path, kind, nprocs, scenario):
    """Rank 1 posts a failure and leaves (`fail`), or leaves without a
    word (`kill`): every other rank raises PeerFailure, naming the
    posted reason or the timeout, within the worker's time limit."""
    res = _world(tmp_path, kind, nprocs, scenario)
    for r, got in enumerate(res):
        if r == 1:
            assert got is None
            continue
        assert got["error"], got
        if scenario == "fail":
            assert "failed on another rank" in got["error"]
            assert "injected failure on rank 1" in got["error"]
        else:
            assert "timed out" in got["error"]
