"""One rank of a multi-process world for tests/test_torch_allreduce.py:
the port's Collective over one transport, driven through one scenario,
its results written as JSON.

    python torch_collective_worker.py KIND SPEC RANK NPROCS SCENARIO OUT

KIND/SPEC: `file DIR` (kvring over a FileKVClient on DIR), `tcp
HOST:PORT` (kvring over a TcpKVClient to a KVServer) or `gloo PORT`
(psum on gloo, the rendezvous store on 127.0.0.1:PORT).  SCENARIO:
`ops` (allgather_arrays with chunking, a bf16 allgather, broadcast_obj,
broadcast_arrays, allgather_obj, barrier), `fail` (rank 1 posts a
failure and leaves; the others wait in a barrier), `kill` (rank 1
leaves without posting; the others time out), `window` (a
WindowTrainer with the collective refits one seeded window corpus
fresh, then warm from the fresh fit's topics; OUT gets the fits' arrays
as .npz) or `sparse_bf16` (distributed EM of the sparse engine in the
bf16 mode over the window corpus, SPARSE_BF16_CONFIG, from the initial
beta in init.npy beside OUT; OUT gets the fit's arrays as .npz).
"""

import json
import os
import sys

import numpy as np


def _payload(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {
        "suff_stats": rng.standard_normal((37, 5)).astype(np.float32),
        "likelihood": np.float32(rng.standard_normal()),
        "gamma": rng.standard_normal((6, 3)),          # float64
        "ids": np.arange(rank, rank + 4, dtype=np.int64),
        "mask": np.array([True, False, rank % 2 == 0]),
    }


# The sparse_bf16 scenario's fit (LDAConfig fields both packages take).
SPARSE_BF16_CONFIG = dict(num_topics=3, batch_size=32, em_max_iters=10,
                          em_tol=1e-12, seed=1, em_shards=8,
                          estep_engine="sparse", dense_precision="bf16",
                          sparse_min_bucket_len=16)


def window_triples():
    """A seeded window corpus' (doc, word, count) triples: 300 documents
    over 80 words, three topics' blocks of words."""
    rng = np.random.default_rng(8)
    trips = []
    for d in range(300):
        t = d % 3
        for _ in range(int(rng.integers(5, 40))):
            wid = (t * 26 + int(rng.integers(0, 26))
                   if rng.random() < 0.9 else int(rng.integers(0, 80)))
            trips.append((f"ip{d}", f"w{wid}", 1))
    return trips


def window_corpus():
    from oni_ml_tpu_torch.io import Corpus

    return Corpus.from_word_counts(window_triples())


def _sparse_bf16(coll, out) -> None:
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import train_corpus

    init = np.load(os.path.join(os.path.dirname(out), "init.npy"))
    res = train_corpus(window_corpus(), LDAConfig(**SPARSE_BF16_CONFIG),
                       device="cpu", distributed=True, collective=coll,
                       initial_log_beta=init)
    np.savez(out, log_beta=res.log_beta, gamma=res.gamma,
             alpha=np.float64(res.alpha), em_iters=res.em_iters,
             lls=np.asarray([ll for ll, _ in res.likelihoods]),
             member=res.stats["member"],
             precision=res.stats["dense_precision"],
             batch_rows=np.asarray([b for b, _ in res.stats["batch_shapes"]]))


def _window(coll, out) -> None:
    from oni_ml_tpu_torch.config import LDAConfig
    from oni_ml_tpu_torch.models.lda import WindowTrainer

    corpus = window_corpus()
    cfg = LDAConfig(num_topics=3, batch_size=32, fused_em_chunk=1,
                    em_max_iters=30, seed=1, em_shards=8)
    tr = WindowTrainer(cfg, corpus.num_terms, device="cpu",
                       collective=coll)
    fresh = tr.fit(corpus)
    warm = tr.fit(corpus, topic_probs=np.exp(fresh.log_beta).T,
                  alpha=fresh.alpha)
    np.savez(out, **{f"{name}_{key}": np.asarray(value)
                     for name, res in (("fresh", fresh), ("warm", warm))
                     for key, value in (("log_beta", res.log_beta),
                                        ("gamma", res.gamma),
                                        ("alpha", res.alpha),
                                        ("em_iters", res.em_iters))})


def main() -> int:
    kind, spec, rank, nprocs, scenario, out = sys.argv[1:7]
    rank, nprocs = int(rank), int(nprocs)
    from oni_ml_tpu_torch.parallel import (Collective, FileKVClient,
                                           PeerFailure, TcpKVClient, mesh)

    if kind == "gloo":
        mesh.initialize_distributed("127.0.0.1", int(spec), nprocs, rank,
                                    device="cpu")
        coll = Collective(transport="psum", max_chunk_bytes=256)
    else:
        if kind == "file":
            client = FileKVClient(spec)
        else:
            host, port = spec.rsplit(":", 1)
            client = TcpKVClient(host, int(port))
        coll = Collective(client, rank, nprocs, transport="kvring",
                          max_chunk_bytes=256)
    result = {"rank": rank, "transport": coll.transport}
    if scenario == "window":
        _window(coll, out)
        return 0
    if scenario == "sparse_bf16":
        _sparse_bf16(coll, out)
        return 0
    if scenario == "ops":
        got = coll.allgather_arrays(_payload(rank), "ops")
        result["gathered"] = [
            {k: np.asarray(v).tolist() for k, v in g.items()} for g in got]
        result["dtypes"] = [{k: str(np.asarray(v).dtype)
                             for k, v in g.items()} for g in got]
        bf = coll.allgather_arrays({"x": _payload(rank)["suff_stats"]},
                                   "bf16", precision="bf16")
        result["bf16"] = [g["x"].tolist() for g in bf]
        result["bf16_applied"] = coll.applied_precision("bf16")
        result["bcast"] = coll.broadcast_obj(
            {"engine": "sparse", "rank": rank} if rank == 0 else None,
            "bcast")
        arrs = coll.broadcast_arrays(
            {"seed": np.arange(5, dtype=np.float64) / 3} if rank == 0
            else None, "seed")
        result["bcast_arrays"] = arrs["seed"].tolist()
        result["allgather_obj"] = coll.allgather_obj([rank, "r"], "obj")
        coll.barrier("end")
        result["stats"] = coll.stats
    else:
        if rank == 1:
            if scenario == "fail":
                coll.fail("injected failure on rank 1")
            os._exit(0)
        try:
            coll.barrier("after_failure")
            result["error"] = None
        except PeerFailure as e:
            result["error"] = str(e)
    with open(out, "w") as f:
        json.dump(result, f)
    if kind == "gloo":
        mesh.shutdown_distributed(timeout_s=10.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
