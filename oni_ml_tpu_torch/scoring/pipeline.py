"""Device scoring pipeline: the gather-dot-threshold programs driven by
chunked, double-buffered dispatch with survivors-only readback (port of
oni_ml_tpu/scoring/pipeline.py; `fused_featurize_scores` fronts the
serving fleet's fused flush).

With a `mesh` (parallel/mesh.py: the run's mesh, the one the LDA stage
trained on) each chunk's events split over the mesh's `data` slots,
each slot running the same gather-dot on its slice
(parallel.make_sharded_score_fn, one per mesh, cached); theta/p are
placed on the slots' devices once per (model, mesh) and counted once in
`weight_h2d_bytes`; the chunk rounds up to a multiple of the data axis;
the compaction runs on the primary device over the joined scores.  An
event's score depends on its two rows alone, so the mesh's scores and
survivors are the unsharded pipeline's, bit for bit.

What crosses the link:

    H2D  theta/p once per model (float32: half the bytes of the float64
         host matrices; `scoring.score._device_model`), then int32
         index arrays, one fixed-size chunk at a time;
    D2H  one int32 survivor count per chunk plus the compacted
         (event index, score) pairs of the survivors themselves: a
         suspicion threshold keeps a tiny fraction of a day, so the
         return traffic falls from 8·N bytes to ~8·survivors.

Each chunk runs the two model-row gathers, the K-wide dot, the
`score < threshold` filter and a stable compaction (kept events first,
original order kept) as plain PyTorch ops on the device; the JAX
package leaves the same arithmetic to XLA, outside any Pallas kernel.
The compaction needs no host read: it sorts `where(keep, pos, m)`
(stable), and the survivor count stays on the device until the chunk is
collected.

On the card the loop is double-buffered with CUDA streams and events:
- index chunks are staged in a ring of two pinned host buffers and
  copied with non_blocking=True on a copy stream; an event orders each
  copy before the compute stream's use of it, and a buffer is refilled
  only after its previous copy (host side) and its previous chunk's
  compute (device side) are done;
- chunk i+1 is enqueued before chunk i's survivor count is read: the
  count is copied to pinned memory behind chunk i's compute and an event
  recorded, so reading it waits for chunk i only (one host wait per
  chunk, as in the JAX loop); the survivors come back on a second copy
  stream that waits on the same event, while chunk i+1 computes.
On the CPU (the tests) the same programs run on CPU tensors with no
streams.

Numerics: float32 gathers and a k-order fused multiply-add against the
float64 host oracle in `scoring.score`: ~1e-6 relative at K=20.  Each
event's score depends on its two rows alone, in a fixed order, so
chunked and one-shot scores agree bit for bit whatever the chunk (a
reduction such as `.sum(-1)` could pick its order by the tensor's
shape).  The filter compares the float32 score
against the float32-cast threshold, so an event whose float64 score
lies within float32 rounding of the threshold can land on the other
side than on the host engine; set parity is exact for thresholds no
score sits on.  The float64 host path stays the default engine and the
results-CSV oracle; the device engine is opt-in (ScoringConfig.engine /
ONI_ML_TPU_SCORE=device).

Every entry point takes a `DispatchStats` probe, accounted as the JAX
package accounts it (power-of-two chunks and survivor slices, the same
byte formulas), so the two records compare field by field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import ScoringConfig
from ..parallel.mesh import mesh_device

# Events per device dispatch: 65536 int32 indices = 256 KiB per array
# per chunk (ScoringConfig.device_chunk, the JAX package's default).
DEFAULT_CHUNK = ScoringConfig.device_chunk


@dataclass
class DispatchStats:
    """Transfer/dispatch accounting for one pipeline run.  h2d_bytes
    counts index-array bytes only (weights are accounted separately in
    weight_h2d_bytes because they ship once per model, not per call);
    d2h_bytes counts the per-chunk survivor-count scalars plus the
    compacted survivor payload actually copied back."""

    dispatches: int = 0          # chunk programs enqueued (accumulates)
    chunks: int = 0              # logical event chunks processed (accum.)
    chunk: int = 0               # effective chunk size of the LAST call
    events: int = 0              # events scored (accumulates)
    survivors: int = 0           # events past the threshold (accum.)
    h2d_bytes: int = 0           # index-array host->device bytes (accum.)
    d2h_bytes: int = 0           # device->host bytes copied back: count
                                 # scalars + survivor slabs, pow2-rounded
                                 # per chunk (accumulates)
    weight_h2d_bytes: int = 0    # model theta/p transfer (once per model)

    def as_record(self) -> dict:
        """JSON-friendly payload for the run's records."""
        return {f: getattr(self, f) for f in self.__dataclass_fields__}


def score_dot_rows(theta: torch.Tensor, p: torch.Tensor,
                   ip_idx: torch.Tensor, word_idx: torch.Tensor):
    """THE gather-dot: two model-row gathers and a K-wide dot, every
    device scoring path's one definition.  The dot accumulates in k
    order, one fused multiply-add per k (`addcmul`), elementwise, so an
    event's score does not depend on the batch it rides in.  That is
    the order and rounding XLA gives the JAX package's
    `jnp.sum(a * b, -1)` on the CPU: the two engines' float32 scores
    agree bit for bit there (tests/test_torch_score_pipeline.py)."""
    a = theta.index_select(0, ip_idx).float()
    b = p.index_select(0, word_idx).float()
    acc = a[:, 0] * b[:, 0]
    for j in range(1, a.shape[1]):
        acc = torch.addcmul(acc, a[:, j], b[:, j])
    return acc


def compact(scores: torch.Tensor, threshold: torch.Tensor, valid_n: int):
    """Stable compaction on the device, no host read: kept rows
    (score < threshold among the first valid_n) first in event order.
    Kept rows sort by their position, dropped rows by the one-past-the-
    end sentinel.  -> (count [int32 scalar on the device], perm)."""
    m = scores.shape[0]
    pos = torch.arange(m, dtype=torch.int64, device=scores.device)
    keep = (scores < threshold) & (pos < valid_n)
    count = keep.sum(dtype=torch.int32)
    perm = torch.sort(torch.where(keep, pos, m), stable=True).indices
    return count, perm


def filt(theta, p, ip_idx, word_idx, threshold, valid_n, dot=None):
    """DNS-shaped chunk: (count, kept positions first, their scores).
    `dot` replaces the gather-dot (a mesh's sharded one)."""
    s = (dot or (lambda a, b: score_dot_rows(theta, p, a, b)))(
        ip_idx, word_idx)
    count, perm = compact(s, threshold, valid_n)
    return count, perm, s.index_select(0, perm)


def filt_flow(theta, p, sip, sw, dip, dw, threshold, valid_n, dot=None):
    """Flow-shaped chunk: both endpoint dots, min(src, dest) against the
    threshold -> (count, kept positions first, src, dest, min)."""
    dot = dot or (lambda a, b: score_dot_rows(theta, p, a, b))
    src = dot(sip, sw)
    dest = dot(dip, dw)
    mn = torch.minimum(src, dest)
    count, perm = compact(mn, threshold, valid_n)
    return (count, perm, src.index_select(0, perm),
            dest.index_select(0, perm), mn.index_select(0, perm))


def loop_cost(events: int, k: int, dots: int, table_rows: int,
              out_bytes: float) -> "tuple[float, float]":
    """(FLOPs, bytes) a chunk loop needs for its inputs, counted from
    their shapes whatever runs it: per event and dot, two int32 indices
    read and a K-term multiply-add; the float32 theta and p tables
    (`table_rows` rows of K together) read once over the loop, however
    many events gather from them; `out_bytes` written (the scores, or
    the survivor counts and the survivors)."""
    flops = float(dots * 2 * k * events)
    nbytes = float(dots * 2 * 4 * events + 4 * k * table_rows + out_bytes)
    return flops, nbytes


def _effective_chunk(n: int, chunk: int, mesh=None) -> int:
    """Shrink the chunk for small inputs to the next power of two, so a
    small day does not pad to the full chunk, and keep it divisible by
    the mesh's data axis."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    eff = min(chunk, 1 << max(0, (n - 1)).bit_length())
    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS

        d = mesh.shape[DATA_AXIS]
        eff = -(-eff // d) * d
    return max(eff, 1)


# One sharded gather-dot per mesh (parallel/sharded.py), cached, so every
# chunk of every call on that mesh reuses it.
_SHARDED_FNS: dict = {}


def _sharded_score_fn(mesh):
    fn = _SHARDED_FNS.get(id(mesh))
    if fn is None or fn.mesh is not mesh:
        from ..parallel.sharded import make_sharded_score_fn

        fn = _SHARDED_FNS[id(mesh)] = make_sharded_score_fn(mesh)
    return fn


def _replicated_model(model, mesh, stats: "DispatchStats | None"):
    """theta/p as float32 on every device of the mesh, cached per
    (model, mesh), so a run transfers each model once: {device: tensor}
    pairs for the sharded gather-dot, counted once in
    `weight_h2d_bytes`."""
    cache = model.__dict__.get("_device_cache_mesh")
    if cache is None or cache[0] is not mesh:
        theta = torch.as_tensor(model.theta, dtype=torch.float32)
        p = torch.as_tensor(model.p, dtype=torch.float32)
        devs = mesh.unique_devices()
        cache = (mesh, {d: theta.to(d) for d in devs},
                 {d: p.to(d) for d in devs})
        model.__dict__["_device_cache_mesh"] = cache
        if stats is not None:
            stats.weight_h2d_bytes += 4 * (model.theta.size + model.p.size)
    return cache[1], cache[2]


def _model_arrays(model, mesh, dev, stats):
    """(theta, p, dot): the model on the device(s) and the chunk's
    gather-dot (the sharded one on a mesh)."""
    if mesh is not None:
        theta, p = _replicated_model(model, mesh, stats)
        sfn = _sharded_score_fn(mesh)
        return (theta[mesh.primary], p[mesh.primary],
                lambda ip, w: sfn(theta, p, ip, w))
    from .score import _device_model

    theta, p = _device_model(model, dev, stats=stats)
    return theta, p, lambda ip, w: score_dot_rows(theta, p, ip, w)


def _pad_chunk(a: np.ndarray, lo: int, hi: int, chunk: int,
               out: "np.ndarray | None" = None) -> np.ndarray:
    """One fixed-size int32 chunk; the tail pads with row 0 (a valid
    model row; the valid_n mask keeps pad rows from surviving)."""
    if out is None:
        out = np.empty(chunk, np.int32)
    out[: hi - lo] = a[lo:hi]
    out[hi - lo:] = 0
    return out


class _Link:
    """The host<->device traffic of one pipeline call.  On the card: a
    ring of two slots, each with pinned host buffers and device buffers
    for the index arrays, an H2D copy stream and a D2H copy stream (see
    the module docstring).  On the CPU the chunks are wrapped as CPU
    tensors and read back directly."""

    def __init__(self, arrays, chunk: int, device: torch.device) -> None:
        self.arrays = arrays
        self.chunk = chunk
        self.device = device
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        self.compute = torch.cuda.current_stream(device)
        self.h2d = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        self.slots = []
        for _ in range(2):
            self.slots.append({
                "host": [torch.empty(chunk, dtype=torch.int32,
                                     pin_memory=True) for _ in arrays],
                "dev": [torch.empty(chunk, dtype=torch.int32, device=device)
                        for _ in arrays],
                "copied": torch.cuda.Event(),
                "used": torch.cuda.Event(),
                "busy": False,
            })
        # The device buffers come from the compute stream's pool: the
        # copy stream writes them only after the compute stream's work
        # so far (a previous tenant of that memory may still be in use).
        self.h2d.wait_stream(self.compute)

    def stage(self, i: int, lo: int, hi: int) -> list:
        """Chunk i's index arrays on the device, ready for the compute
        stream."""
        if not self.cuda:
            return [torch.from_numpy(_pad_chunk(a, lo, hi, self.chunk))
                    for a in self.arrays]
        slot = self.slots[i % 2]
        if slot["busy"]:
            # The pinned buffer is refilled only after its last copy has
            # read it.
            slot["copied"].synchronize()
        for h, a in zip(slot["host"], self.arrays):
            _pad_chunk(a, lo, hi, self.chunk, out=h.numpy())
        with torch.cuda.stream(self.h2d):
            if slot["busy"]:
                # The device buffer is overwritten only after the compute
                # that last read it.
                self.h2d.wait_event(slot["used"])
            for d, h in zip(slot["dev"], slot["host"]):
                d.copy_(h, non_blocking=True)
            slot["copied"].record(self.h2d)
        self.compute.wait_event(slot["copied"])
        slot["busy"] = True
        return slot["dev"]

    def enqueued(self, i: int, count=None):
        """Chunk i's programs are enqueued: mark its slot's use and, on
        the card, copy its survivor count to pinned memory behind it.
        -> a handle for read_count / read."""
        if not self.cuda:
            return None, count
        self.slots[i % 2]["used"].record(self.compute)
        host = None
        if count is not None:
            host = torch.empty((), dtype=torch.int32, pin_memory=True)
            host.copy_(count, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(self.compute)
        return ready, host

    def read_count(self, handle) -> int:
        """The one host wait per chunk: the survivor count."""
        ready, count = handle
        if ready is not None:
            ready.synchronize()
        return int(count)

    def read(self, handle, tensors, n: int) -> list:
        """The first n rows of each tensor as numpy, copied back on the
        D2H stream once the chunk's compute is done."""
        ready, _ = handle
        if ready is None:
            return [t[:n].numpy() for t in tensors]
        with torch.cuda.stream(self.d2h):
            self.d2h.wait_event(ready)
            host = [torch.empty(n, dtype=t.dtype, pin_memory=True)
                    .copy_(t[:n], non_blocking=True) for t in tensors]
            done = torch.cuda.Event()
            done.record(self.d2h)
        done.synchronize()
        return [h.numpy() for h in host]


def _run_chunks(n: int, chunk: int, dispatch, collect,
                label: str = "score.device.chunks", cost=None,
                device=None) -> int:
    """The double-buffered dispatch loop shared by every pipeline entry:
    chunk i+1 is enqueued BEFORE chunk i's results are read, so host-side
    collection overlaps device compute.

    Under an active telemetry Recorder the loop records one `label` span
    (events/chunks in args) and, after the loop, a roofline record: the
    loop wall against `cost()`, the loop's (FLOPs, bytes) counted from
    the shapes (loop_cost), registered under `label` per dispatch.
    Uninstrumented runs pay nothing."""
    from ..telemetry.spans import current_recorder, maybe_span, now_ns

    nchunks = -(-n // chunk)
    instrumented = current_recorder() is not None
    t0 = now_ns()
    with maybe_span(label, events=n, chunk=chunk, chunks=nchunks):
        pending = [dispatch(0)]
        for i in range(1, nchunks):
            pending.append(dispatch(i))
            collect(*pending.pop(0))
        collect(*pending.pop(0))
    if instrumented:
        from ..telemetry import roofline

        wall_s = (now_ns() - t0) / 1e9
        if cost is not None:
            flops, nbytes = cost()
            roofline.register_cost(label, flops=flops / nchunks,
                                   nbytes=nbytes / nchunks,
                                   shape=f"c{chunk}", device=device)
        roofline.emit(label, wall_s, dispatches=nchunks, count="needed",
                      events=n, chunk=chunk)
    return nchunks


def _index_arrays(model, pairs):
    from .score import _check_index_range

    for ip, w in pairs:
        _check_index_range(model, ip, w)
    return [np.asarray(a, np.int32) for pair in pairs for a in pair]


def chunked_scores(
    model, ip_idx, word_idx, *, chunk: int = DEFAULT_CHUNK,
    stats: "DispatchStats | None" = None, device=None, mesh=None,
) -> np.ndarray:
    """Full score vector through the chunked device pipeline (no
    threshold compaction: every event's score comes back), over the
    mesh's data slots where one is given.  Returns float64 for drop-in
    use where the host path is used."""
    dev = mesh_device(mesh, device)
    ip, w = _index_arrays(model, [(ip_idx, word_idx)])
    n = len(ip)
    if n == 0:
        return np.zeros(0, np.float64)
    chunk = _effective_chunk(n, chunk, mesh)
    theta, p, dot = _model_arrays(model, mesh, dev, stats)
    link = _Link([ip, w], chunk, dev)
    out = np.empty(n, np.float64)
    if stats is not None:
        stats.chunk = chunk
        stats.events += n

    def dispatch(i):
        lo = i * chunk
        hi = min(lo + chunk, n)
        ipc, wc = link.stage(i, lo, hi)
        if stats is not None:
            stats.dispatches += 1
            stats.chunks += 1
            stats.h2d_bytes += 2 * 4 * chunk
        s = dot(ipc, wc)
        return lo, hi, s, link.enqueued(i)

    def collect(lo, hi, s, handle):
        out[lo:hi] = link.read(handle, [s], hi - lo)[0]
        if stats is not None:
            stats.d2h_bytes += 4 * (hi - lo)

    k, rows = theta.shape[1], theta.shape[0] + p.shape[0]
    _run_chunks(n, chunk, dispatch, collect, label="score.device.full",
                cost=lambda: loop_cost(n, k, 1, rows, 4.0 * n), device=dev)
    if stats is not None:
        stats.survivors += n
    return out


def _survivor_slice(c: int, m: int) -> int:
    """Readback length for c survivors out of an m-row chunk: the next
    power of two (the JAX package's rule, which bounds its count of
    compiled slice programs); the pad rows transfer and are trimmed on
    the host, at most 2x the survivor payload."""
    return min(m, 1 << (c - 1).bit_length())


def _merge_survivors(parts):
    """Concatenate per-chunk survivor slabs (already in event order) and
    sort ascending by score — exactly `_keep_order`'s semantics: stable,
    so threshold-boundary ties keep event order."""
    pos = np.concatenate([p[0] for p in parts])
    cols = [
        np.concatenate([p[j] for p in parts])
        for j in range(1, len(parts[0]))
    ]
    order = np.argsort(cols[-1], kind="stable")
    return (pos[order], *[c[order] for c in cols])


def _filtered(model, arrays, threshold, chunk, stats, dev, label,
              mesh=None):
    """The survivors-only loop shared by filtered_scores (one dot) and
    filtered_flow_scores (two dots and their min).  On a mesh each chunk
    is the sharded gather-dot(s) and the compaction over their joined
    scores: the JAX package's two (flow: three) programs, counted so in
    `dispatches`."""
    n = len(arrays[0])
    dots = len(arrays) // 2
    empty = (np.zeros(0, np.int64),) + tuple(
        np.zeros(0, np.float64) for _ in range(1 if dots == 1 else 3))
    if n == 0:
        return empty
    chunk = _effective_chunk(n, chunk, mesh)
    theta, p, dot = _model_arrays(model, mesh, dev, stats)
    thr = torch.tensor(np.float32(threshold), device=dev)
    link = _Link(arrays, chunk, dev)
    program = filt if dots == 1 else filt_flow
    # Bytes of one survivor back: its event index and each score column.
    row_bytes = 8 if dots == 1 else 16
    parts = []
    kept = [0]
    if stats is not None:
        stats.chunk = chunk
        stats.events += n

    def dispatch(i):
        lo = i * chunk
        hi = min(lo + chunk, n)
        idx = link.stage(i, lo, hi)
        if stats is not None:
            stats.dispatches += 1 if mesh is None else 1 + dots
            stats.chunks += 1
            stats.h2d_bytes += len(arrays) * 4 * chunk
        out = program(theta, p, *idx, thr, hi - lo, dot=dot)
        return lo, out, link.enqueued(i, out[0])

    def collect(lo, out, handle):
        c = link.read_count(handle)
        if stats is not None:
            stats.d2h_bytes += 4
        if c:
            cp = _survivor_slice(c, chunk)
            cols = link.read(handle, out[1:], cp)
            parts.append((cols[0][:c].astype(np.int64) + lo,
                          *[col[:c].astype(np.float64) for col in cols[1:]]))
            kept[0] += c
            if stats is not None:
                stats.d2h_bytes += row_bytes * cp
                stats.survivors += c

    k, rows = theta.shape[1], theta.shape[0] + p.shape[0]
    nchunks = -(-n // chunk)
    _run_chunks(n, chunk, dispatch, collect, label=label,
                cost=lambda: loop_cost(n, k, dots, rows,
                                       4.0 * nchunks + row_bytes * kept[0]),
                device=dev)
    if not parts:
        return empty
    return _merge_survivors(parts)


def filtered_scores(
    model, ip_idx, word_idx, threshold, *, chunk: int = DEFAULT_CHUNK,
    stats: "DispatchStats | None" = None, device=None, mesh=None,
):
    """DNS-shaped pipeline: (event_indices, scores) of the events
    scoring under `threshold`, ascending by score with stable event-
    order ties — the device twin of host `_keep_order` over
    `_batched_scores`.  Only survivors come back."""
    dev = mesh_device(mesh, device)
    arrays = _index_arrays(model, [(ip_idx, word_idx)])
    return _filtered(model, arrays, threshold, chunk, stats, dev,
                     "score.device.filtered", mesh)


def filtered_flow_scores(
    model, sip_idx, sw_idx, dip_idx, dw_idx, threshold, *,
    chunk: int = DEFAULT_CHUNK, stats: "DispatchStats | None" = None,
    device=None, mesh=None,
):
    """Flow-shaped pipeline: both endpoint dots, min(src, dest)
    thresholding, and compaction per chunk.  Returns (event_indices,
    src_scores, dest_scores, min_scores) for the survivors, ascending
    by min score with stable ties."""
    dev = mesh_device(mesh, device)
    arrays = _index_arrays(model, [(sip_idx, sw_idx), (dip_idx, dw_idx)])
    return _filtered(model, arrays, threshold, chunk, stats, dev,
                     "score.device.filtered_flow", mesh)


def fused_featurize_scores(model, dev, codes, ip_idx, word_base: int = 0,
                           *, block: "int | None" = None, threshold=None,
                           stats: "DispatchStats | None" = None,
                           device=None):
    """The fleet's fused flush: a compiled device featurizer's codes
    (sources/device.py) -> word rows through its table, + `word_base`
    (a stacked snapshot's offset), -> `score_dot_rows`, optionally with
    the `score < threshold` mask, in one call on `device`.  The serving
    callers' door to ops/featurize_kernel.fused_scores; float32 scores,
    float64 on return."""
    from ..ops.featurize_kernel import fused_scores

    return fused_scores(model, dev, codes, ip_idx, word_base,
                        block=block, threshold=threshold, stats=stats,
                        device=device)
