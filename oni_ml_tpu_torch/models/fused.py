"""Chunked EM on the device: up to `chunk` EM iterations per dispatch,
with the stop decision on the device (port of oni_ml_tpu/models/fused.py).

The stepwise trainer (models/lda.py) reads the likelihood on the host
after every EM iteration to decide convergence, so the host waits for
the device once per iteration.  Here one dispatch enqueues up to
min(chunk, n_steps) EM iterations — E-step over every batch, M-step,
Newton alpha, the convergence test — and the host reads nothing until
the dispatch returns.  The JAX package runs this loop as a
`lax.while_loop`; the port keeps its contract without a host read:

- a device-resident int32 flag `stop` is set by the iteration whose
  |dll/ll| < em_tol (the first iteration, with ll_prev = nan, never
  stops);
- every E-step kernel launch takes a pointer to the flag and returns at
  once when it is set, and the iteration's new state is selected with
  `torch.where(active, new, old)`, so after the device stop
  (beta, alpha, ll_prev, gammas, steps_done) are exactly what the JAX
  while loop leaves, and lls[step] / vi_iters[step] are written only
  while the flag is clear.  The launches after the stop still count in
  the kernels' `launch_count`, but not in the counters the kernels keep
  on the card of the launches that ran (`executed_counts`); the driver
  counts the iterations after the stop as (dispatched - steps_done);
- on the CPU the plain versions compute the skipped iterations all the
  same, and the same `torch.where` discards them.

Batches are grouped by (B, L) shape and stacked [NB, B, L]; the JAX
`lax.scan` over a group becomes a Python loop over its batches.  Three
kinds of group:
- token groups (word_idx, counts, doc_mask, live-token plans per batch):
  each batch runs through `e_step_fn` — the sparse engine
  (sparse_estep.e_step, csrc/sparse_estep.cu) or the per-batch dispatch
  (estep.e_step, the default, as in the JAX package);
- full-V dense groups (C [NB, B, W] or [NB, W, B], doc_mask), for
  csrc/dense_estep.cu;
- compact-vocab dense groups (C [NB, B, Wc] or [NB, Wc, B], doc_mask,
  vocab_map [NB, Wc]): the dense kernel over each batch's own
  vocabulary, a beta column gather before it and a suff-stats row
  scatter after (`plan_compact`).
One dense group of one batch takes the fast path
(`run_chunk_impl_fast`), which carries beta in the kernel's exp-space
[K, W] layout across iterations.

`dense_precision` ("f32" or "bf16", LDAConfig.dense_precision) reaches
the dense kernel of every dense group and the sparse engine's table
(sparse_estep.exp_beta_table); the per-batch dispatch stays f32, as in
the JAX package.  The dense groups' corpus may be stored as bf16
(`densify_groups(dtype=)`, `compact_stack_batches(corpus_store=)`,
dense_estep.corpus_dtype).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..io import Batch
from ..ops import dense_estep, estep, sparse_estep
from ..telemetry.spans import current_recorder

# Which chunk impl the most recent dispatch ran ("fast" | "generic";
# None before any).  Observability: the two impls are pinned equal by
# the tests, so only this marker shows the fast path engaging.
LAST_CHUNK_PLAN = None


class StackedGroups(NamedTuple):
    """Shape-grouped batches, stacked along a leading axis.

    arrays[g] is (word_idx [NB,B,L], counts [NB,B,L], doc_mask [NB,B],
    live-token plans per batch) for a sparse group, or (C [NB,B,W] or
    [NB,W,B], doc_mask [NB,B], L) for a full-V dense one (L, the token
    lists' length, bounds a document's non-zero cells: the dense
    kernel's `cells`); batch_slots[g] lists the
    original batch indices, so slot j of group g holds
    batches[batch_slots[g][j]]."""

    arrays: tuple
    batch_slots: tuple


def stack_batches(batches: Sequence[Batch],
                  device: "str | torch.device", mesh=None,
                  e_step_fn=None, num_terms: int = 0) -> StackedGroups:
    """Group batches by (B, L), stack each group on `device`, and build
    each batch's live-token plan once (sparse_estep.live_tokens).

    With a `mesh` (parallel/mesh.py) each stacked array is placed once
    for the fit, its documents (axis 1) split over the mesh's `data` axis
    (mesh.stacked_batch_sharding), and each batch's plan is the mesh
    E-step's own (`e_step_fn.make_plan`: per-slot live tokens, or the
    vocab-sharded plan, which needs `num_terms`)."""
    groups: dict[tuple, list[int]] = {}
    for i, b in enumerate(batches):
        groups.setdefault(b.word_idx.shape, []).append(i)
    arrays, slots = [], []
    for shape in sorted(groups):
        idxs = groups[shape]
        stacks = (
            torch.as_tensor(np.stack([batches[i].word_idx for i in idxs]),
                            dtype=torch.int32),
            torch.as_tensor(np.stack([batches[i].counts for i in idxs]),
                            dtype=torch.float32),
            torch.as_tensor(np.stack([batches[i].doc_mask for i in idxs]),
                            dtype=torch.float32))
        if mesh is not None:
            from ..parallel.mesh import stacked_batch_sharding

            sh = stacked_batch_sharding(mesh)
            w, c, m = (sh.put(t) for t in stacks)
            lives = tuple(e_step_fn.make_plan(wj, cj, num_terms)
                          for wj, cj in zip(w.unbind(0), c.unbind(0)))
        else:
            w, c, m = (t.to(device) for t in stacks)
            lives = tuple(sparse_estep.live_tokens(w[j], c[j])
                          for j in range(len(idxs)))
        arrays.append((w, c, m, lives))
        slots.append(tuple(idxs))
    return StackedGroups(tuple(arrays), tuple(slots))


def _densify_mesh(w, c, num_terms: int, wmajor: bool, vocab: bool,
                  dtype: torch.dtype = torch.float32):
    """One stacked group densified slot by slot (each data slot's
    documents on its own device, never the whole corpus on one): full-V
    groups [NB, B, W] split over `data` (W-major [NB, W, B]); with
    `vocab` the width is `num_terms` (the model-divisible padded vocab)
    and slot (i, j) keeps its [NB, B/d, W/m] columns.  `dtype` is the
    storage dtype."""
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Sharded

    mesh = w.mesh
    d, msz = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    width = num_terms if vocab else dense_estep.padded_width(num_terms)
    blocks = []
    for i in range(d):
        wi, ci = w.block(i), c.block(i)
        nb, bl, _ = wi.shape
        full = torch.empty((nb, width, bl) if wmajor else (nb, bl, width),
                           dtype=dtype, device=wi.device)
        for j in range(nb):
            dj = dense_estep.densify(wi[j], ci[j], num_terms, width=width)
            full[j] = dj.t() if wmajor else dj
        if not vocab:
            blocks.append([full] * msz)
            continue
        per = width // msz
        blocks.append([full[:, :, j * per:(j + 1) * per].contiguous()
                       .to(mesh.device(i, j)) for j in range(msz)])
    nb, b = w.shape[0], w.shape[1]
    if vocab:
        return Sharded(mesh, (None, DATA_AXIS, MODEL_AXIS), blocks,
                       (nb, b, width), dtype)
    spec = (None, None, DATA_AXIS) if wmajor else (None, DATA_AXIS, None)
    shape = (nb, width, b) if wmajor else (nb, b, width)
    return Sharded(mesh, spec, blocks, shape, dtype)


def densify_groups(groups: StackedGroups, num_terms: int,
                   wmajor: bool = False, vocab: bool = False,
                   dtype: torch.dtype = torch.float32) -> StackedGroups:
    """Stacked sparse groups -> full-V dense groups (C [NB, B, W], or
    [NB, W, B] with `wmajor`, the mask and L), densified once for the run
    (dense_estep.densify) and stored as `dtype` (dense_estep.corpus_dtype:
    the float32 sums convert exactly).  Groups placed over a mesh densify
    on their slots (`_densify_mesh`); `vocab` is the vocab-sharded plan's
    layout, C split over `data` and `model`."""
    from ..parallel.mesh import Sharded

    width = dense_estep.padded_width(num_terms)
    arrays = []
    for w, c, m, _ in groups.arrays:
        if isinstance(w, Sharded):
            arrays.append((_densify_mesh(w, c, num_terms, wmajor, vocab,
                                         dtype), m, w.shape[2]))
            continue
        nb, b, l = w.shape
        shape = (nb, width, b) if wmajor else (nb, b, width)
        dense = torch.empty(shape, dtype=dtype, device=w.device)
        for j in range(nb):
            d = dense_estep.densify(w[j], c[j], num_terms, width=width)
            dense[j] = d.t() if wmajor else d
        arrays.append((dense, m, l))
    return StackedGroups(tuple(arrays), groups.batch_slots)


def dense_groups_bytes(batches: Sequence[Batch], num_terms: int,
                       itemsize: int = 4) -> int:
    """Device bytes the densified corpus would occupy."""
    width = dense_estep.padded_width(num_terms)
    return sum(b.word_idx.shape[0] for b in batches) * width * itemsize


def dense_scratch_bytes(shape_widths, num_topics: int) -> int:
    """The largest per-launch scratch the dense kernel takes over
    `shape_widths`, ((B, L), W) pairs: a batch of B documents from [B, L]
    token lists at dense width W (dense_estep.launch_geometry; 0 where
    every doc block's cells fit in shared memory).  Launches run in
    order, so one scratch is live at a time."""
    return max((dense_estep.launch_geometry(b, w, num_topics, cells=l)
                ["scratch_bytes"] for (b, l), w in shape_widths), default=0)


class CompactPlan(NamedTuple):
    """Host-side plan of the compact-vocab dense E-step: each batch
    remapped onto its own vocabulary (the words its documents hold), so
    the dense kernel runs at a width Wc << V, at the cost of one [K, Wc]
    beta column gather and one [Wc, K] suff-stats row scatter per batch
    and EM iteration.

    uniques[g][j]: sorted distinct word ids of group g's j-th batch;
    widths[g]: the group's compact width (the largest unique count,
    padded to 128 like padded_width)."""

    uniques: tuple
    widths: tuple
    wmajor: bool
    corpus_bytes: int       # device bytes of the compacted corpus


def _shape_groups(batches: Sequence[Batch]) -> "dict[tuple, list[int]]":
    groups: dict[tuple, list[int]] = {}
    for i, b in enumerate(batches):
        groups.setdefault(b.word_idx.shape, []).append(i)
    return groups


def plan_compact(batches: Sequence[Batch], num_topics: int,
                 precision: str = "f32", wmajor: bool = True,
                 itemsize: int = 4) -> "CompactPlan | None":
    """A CompactPlan, or None where the card cannot run the dense kernel
    (K above its compiled bound).  The JAX package also refuses widths
    whose doc block overflows the TPU's VMEM; the card's kernel keeps
    nothing sized by the width, so every width runs, at either precision
    (an unknown one raises).  `itemsize` is the corpus' storage width
    (corpus_bytes).  Pure host work: np.unique over each batch's token
    ids."""
    dense_estep._check_precision(precision)
    if not 0 < num_topics <= dense_estep.MAX_TOPICS:
        return None
    uniques, widths, total = [], [], 0
    for shape, idxs in sorted(_shape_groups(batches).items()):
        us = tuple(np.unique(batches[i].word_idx) for i in idxs)
        wc = -(-max(len(u) for u in us) // 128) * 128
        uniques.append(us)
        widths.append(wc)
        total += len(idxs) * shape[0] * wc * itemsize
    return CompactPlan(tuple(uniques), tuple(widths), wmajor, total)


def compact_stack_batches(batches: Sequence[Batch],
                          device: "str | torch.device",
                          plan: CompactPlan,
                          corpus_store: torch.dtype = torch.float32,
                          ) -> StackedGroups:
    """Stack batches into compact dense groups: arrays[g] =
    (C_local [NB, B, Wc] (or [NB, Wc, B] W-major), doc_mask [NB, B],
    vocab_map [NB, Wc] int64, L) with L the token lists' length (the
    dense kernel's `cells`, as in densify_groups).  vocab_map[j, u] is the global word id of
    local column u; the columns past the batch's unique count repeat
    word 0, inert because their counts are zero.  Token ids map to local
    columns by searchsorted into the batch's sorted uniques (exact:
    every token id is one of them).  C_local is stored as `corpus_store`
    (dense_estep.corpus_dtype)."""
    arrays, slots = [], []
    for g, (shape, idxs) in enumerate(sorted(_shape_groups(batches).items())):
        wc = plan.widths[g]
        local, vmaps = [], []
        for j, i in enumerate(idxs):
            u = plan.uniques[g][j]
            local.append(np.searchsorted(u, batches[i].word_idx))
            vm = np.zeros(wc, np.int64)
            vm[:len(u)] = u
            vmaps.append(vm)
        w = torch.as_tensor(np.stack(local), dtype=torch.int32).to(device)
        c = torch.as_tensor(np.stack([batches[i].counts for i in idxs]),
                            dtype=torch.float32).to(device)
        nb, b, _ = w.shape
        dense = torch.empty((nb, wc, b) if plan.wmajor else (nb, b, wc),
                            dtype=corpus_store, device=w.device)
        for j in range(nb):
            d = dense_estep.densify(w[j], c[j], wc, width=wc)
            dense[j] = d.t() if plan.wmajor else d
        m = torch.as_tensor(np.stack([batches[i].doc_mask for i in idxs]),
                            dtype=torch.float32).to(device)
        arrays.append((dense, m,
                       torch.as_tensor(np.stack(vmaps)).to(device),
                       shape[1]))
        slots.append(tuple(idxs))
    return StackedGroups(tuple(arrays), tuple(slots))


def _is_dense(group) -> bool:
    """A full-V or compact dense group (its corpus leads, in floats)."""
    return group[0].is_floating_point()


def initial_gammas(groups_arrays, k: int, dense_wmajor: bool = False):
    """Zero gamma buffers [NB, B, K] per group, ChunkResult.gammas'
    structure: what the first dispatch takes as `gammas_in` (with
    have_prev=False)."""
    def batch_dim(g):
        return g[0].shape[2] if _is_dense(g) and dense_wmajor else g[0].shape[1]

    return tuple(
        torch.zeros((g[0].shape[0], batch_dim(g), k), dtype=torch.float32,
                    device=g[0].device)
        for g in groups_arrays
    )


def table_precision(e_fn, dense_precision: str) -> str:
    """The precision of the exp(log beta)^T table a token group's E-step
    `e_fn` reads: the sparse engine's follows `dense_precision`; the
    per-batch dispatch (and the mesh's plans over it) stays f32, as in
    the JAX package."""
    dense_estep._check_precision(dense_precision)
    return dense_precision if e_fn is sparse_estep.e_step else "f32"


def make_em_accumulator(
    *,
    num_topics: int,
    num_terms: int,
    var_max_iters: int,
    var_tol: float,
    e_step_fn: "Callable | None" = None,
    dense_wmajor: bool = False,
    dense_e_step_fn: "Callable | None" = None,
    dense_precision: str = "f32",
):
    """Build `accumulate(log_beta, alpha, groups, gammas_prev, warm,
    stop=None) -> (suff_stats [V, K], likelihood, alpha_ss, gammas,
    vi_max)`: one EM iteration's E-step over stacked groups, without the
    M-step.  Token groups run through `e_step_fn` (default
    estep.e_step, the per-batch dispatch), warm-started only when it is
    marked `_oni_warm_capable`; the port's own E-steps (and its mesh
    wrappers, parallel/sharded.py) also take the iteration's shared
    exp(log beta)^T table, the batch's live-token plan, the stop flag
    and the alpha-prior constant.  Full-V dense groups run through
    `dense_e_step_fn` where given (the mesh's dense plans, built at their
    own precision), else the dense kernel at `dense_precision`, as do
    the compact groups; the sparse engine's table is built at it too.
    The tables are built once per call; suff-stats add in batch order."""
    e_fn = e_step_fn or estep.e_step
    e_warm = getattr(e_fn, "_oni_warm_capable", False)
    own = (e_fn in (estep.e_step, sparse_estep.e_step)
           or getattr(e_fn, "_oni_data_parallel", False)
           or getattr(e_fn, "_oni_vocab_sharded", False))
    table = table_precision(e_fn, dense_precision)
    vocab_dense = getattr(dense_e_step_fn, "_oni_vocab_sharded", False)
    k, v = num_topics, num_terms

    def dense_batch(log_beta, alpha, dense, mask, g, warm, stop, alpha_const,
                    cells, exp_beta=None):
        if dense_e_step_fn is not None:
            return dense_e_step_fn(
                log_beta, alpha, dense, mask, g, warm, var_max_iters,
                var_tol, stop=stop, alpha_const=alpha_const, cells=cells,
                exp_beta=exp_beta)
        return dense_estep.e_step_dense(
            log_beta, alpha, dense, mask, var_max_iters, var_tol,
            wmajor=dense_wmajor, gamma_prev=g, warm=warm, exp_beta=exp_beta,
            stop=stop, alpha_const=alpha_const, cells=cells,
            precision=dense_precision)

    def accumulate(log_beta, alpha, groups, gammas_prev, warm, stop=None):
        dev = log_beta.device
        total_ss = torch.zeros((v, k), dtype=torch.float32, device=dev)
        total_ll = torch.zeros((), dtype=torch.float32, device=dev)
        total_ass = torch.zeros((), dtype=torch.float32, device=dev)
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
        # Shared by every batch, and each batch's views taken with one
        # unbind per stacked tensor: on the card this loop is host-bound,
        # so every torch op per batch costs wall time.
        alpha_const = estep.alpha_constant(alpha, k)
        expb_vk = exp_beta = None
        gammas, vis = [], []
        for group, g_prev in zip(groups, gammas_prev):
            outs = []
            g_views = g_prev.unbind(0)
            if _is_dense(group) and len(group) == 3:     # full-V dense
                dense_views, mask_views = (t.unbind(0) for t in group[:2])
                for dense, mask, g in zip(dense_views, mask_views, g_views):
                    if exp_beta is None and not vocab_dense:
                        w = dense.shape[0] if dense_wmajor else dense.shape[1]
                        exp_beta = dense_estep.padded_exp_beta(log_beta, w)
                    res = dense_batch(log_beta, alpha, dense, mask, g, warm,
                                      stop, alpha_const, group[2], exp_beta)
                    total_ss, total_ll, total_ass = _add(
                        res, total_ss, total_ll, total_ass, vis, outs)
            elif _is_dense(group):                       # compact dense
                for dense, mask, vmap, g in zip(
                        *(t.unbind(0) for t in group[:3]), g_views):
                    res = dense_batch(log_beta.index_select(1, vmap), alpha,
                                      dense, mask, g, warm, stop, alpha_const,
                                      group[3])
                    # Unique rows, and the sentinel columns (word 0
                    # repeated) add exact zeros: index_add_ into the sum
                    # is the same bits in any order, on the card too.
                    total_ss.index_add_(0, vmap, res.suff_stats)
                    vis.append(res.vi_iters)
                    outs.append(res.gamma)
                    total_ll = total_ll + res.likelihood
                    total_ass = total_ass + res.alpha_ss
            else:                                        # token group
                kw = {}
                if own:
                    if expb_vk is None:
                        expb_vk = sparse_estep.exp_beta_table(
                            log_beta, table)
                    kw = dict(expb_vk=expb_vk, stop=stop,
                              alpha_const=alpha_const)
                w_views, c_views, m_views = (t.unbind(0) for t in group[:3])
                for word_idx, counts, mask, live, g in zip(
                        w_views, c_views, m_views, group[3], g_views):
                    if own:
                        kw["live"] = live
                    if e_warm:
                        kw.update(gamma_prev=g, warm=warm)
                    res = e_fn(log_beta, alpha, word_idx, counts, mask,
                               var_max_iters, var_tol, **kw)
                    total_ss, total_ll, total_ass = _add(
                        res, total_ss, total_ll, total_ass, vis, outs)
            gammas.append(torch.stack(outs))
        vi_max = torch.stack(vis).max().to(torch.int32)
        return total_ss, total_ll, total_ass, tuple(gammas), vi_max

    return accumulate


def make_partial_runner(**kw):
    """The distributed driver's per-shard E-step (port of the JAX
    package's make_partial_runner): `run(log_beta, alpha, groups,
    gammas_prev, warm) -> (suff_stats [V, K], likelihood, alpha_ss,
    gammas, vi_max)` over one document shard's stacked groups, the full
    E-step through the port's kernels (the member's: token groups
    through the sparse engine or the per-batch dispatch, dense groups
    through the dense kernel) and no M-step.  The distributed EM loop
    (models/lda.py `_distributed_loop`) reduces the partials across
    processes and runs the M-step on every rank from the reduced
    statistics.  `kw` is make_em_accumulator's."""
    return make_em_accumulator(**kw)


def _add(res, total_ss, total_ll, total_ass, vis, outs):
    """One batch's E-step into the iteration's sums (in batch order),
    its iteration count and gamma into the lists."""
    vis.append(res.vi_iters)
    outs.append(res.gamma)
    return (total_ss + res.suff_stats, total_ll + res.likelihood,
            total_ass + res.alpha_ss)


class ChunkResult(NamedTuple):
    log_beta: torch.Tensor
    alpha: torch.Tensor
    ll_prev: torch.Tensor       # scalar; nan before the first EM iteration
    lls: torch.Tensor           # [chunk] likelihood per executed step
    steps_done: torch.Tensor    # int32 scalar in [0, n_steps]
    converged: torch.Tensor     # bool scalar
    gammas: tuple               # per group: [NB, B, K] from the last E-step
    vi_iters: torch.Tensor      # [chunk] max fixed-point iterations per step


def make_chunk_runner(
    *,
    num_docs: int,
    num_topics: int,
    num_terms: int,
    chunk: int,
    var_max_iters: int,
    var_tol: float,
    em_tol: float,
    estimate_alpha: bool,
    e_step_fn: "Callable | None" = None,
    m_step_fn: "Callable | None" = None,
    dense_wmajor: bool = False,
    warm_start: bool = False,
    alpha_max_iters: int = 100,
    yield_hook: "Callable | None" = None,
    dense_e_step_fn: "Callable | None" = None,
    dense_precision: str = "f32",
):
    """Build `run_chunk(log_beta, alpha, ll_prev, groups, n_steps,
    gammas_in=None, have_prev=None) -> ChunkResult`, which enqueues
    min(chunk, n_steps) EM iterations and reads nothing on the host.

    `yield_hook` (a context-manager factory, e.g.
    serving.CoScheduler.train_chunk) makes each chunk dispatch
    preemptible: the runner enqueues each dispatch inside one hook slot.

    `have_prev` says whether `gammas_in` holds a previous dispatch's
    posteriors (warm start across dispatches); pass a Python bool — a
    device tensor costs a host read.  A custom `m_step_fn` keeps every
    dispatch on the generic impl, as in the JAX package.  `e_step_fn`
    runs the token groups and `dense_e_step_fn` (a mesh's dense plan)
    the full-V dense groups (make_em_accumulator), `dense_precision`
    the dense kernel's mode and the sparse engine's table."""
    from .lda import update_alpha  # lda.py imports this module

    m_fn = m_step_fn or estep.m_step
    k, v = num_topics, num_terms
    accumulate = make_em_accumulator(
        num_topics=num_topics, num_terms=num_terms,
        var_max_iters=var_max_iters, var_tol=var_tol, e_step_fn=e_step_fn,
        dense_wmajor=dense_wmajor, dense_e_step_fn=dense_e_step_fn,
        dense_precision=dense_precision,
    )

    def new_alpha_of(alpha_ss, alpha):
        if not estimate_alpha:
            return alpha
        return update_alpha(alpha_ss, alpha, num_docs, k,
                            max_iters=alpha_max_iters)

    def em_iteration(log_beta, alpha, groups, gammas_prev, warm, stop):
        total_ss, total_ll, total_ass, gammas, vi_max = accumulate(
            log_beta, alpha, groups, gammas_prev, warm, stop)
        return (m_fn(total_ss), new_alpha_of(total_ass, alpha), total_ll,
                gammas, vi_max)

    def _resolve_gammas(groups, gammas_in, have_prev):
        if gammas_in is None:
            return initial_gammas(groups, k, dense_wmajor=dense_wmajor), False
        return tuple(gammas_in), bool(have_prev)

    def _chunk_loop(model, alpha, ll_prev, gammas, n_steps, have_prev,
                    iterate):
        """The shared loop skeleton — warm gating, the device stop rule
        and the step/ll/vi bookkeeping — for the generic impl and the
        fast path.  `iterate(model, alpha, gammas, warm, stop) ->
        (model', alpha', ll, gammas', vi)` is the EM iteration; `model`
        is log-space [K, V] beta or the fast path's exp-space [K, W]."""
        dev = model.device
        lls = torch.zeros((chunk,), dtype=torch.float32, device=dev)
        vis = torch.zeros((chunk,), dtype=torch.int32, device=dev)
        steps = torch.zeros((), dtype=torch.int32, device=dev)
        stop = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(min(int(n_steps), chunk)):
            active = stop == 0
            # Warm once any gamma exists: made in this dispatch (i > 0,
            # which while active means steps > 0) or carried in.
            warm = int(warm_start and (i > 0 or have_prev))
            new_model, new_alpha, ll, new_gammas, vi = iterate(
                model, alpha, gammas, warm, stop)
            # The first-ever iteration (ll_prev = nan) never stops; the
            # host recomputes conv in float64 from the returned lls.
            conv = ((ll_prev - ll) / ll_prev).abs()
            done = ~torch.isnan(ll_prev) & (conv < em_tol)
            model = torch.where(active, new_model, model)
            alpha = torch.where(active, new_alpha, alpha)
            ll_prev = torch.where(active, ll, ll_prev)
            gammas = tuple(torch.where(active, ng, g)
                           for ng, g in zip(new_gammas, gammas))
            lls[i] = torch.where(active, ll, lls[i])
            vis[i] = torch.where(active, vi.to(torch.int32), vis[i])
            steps = steps + active.to(torch.int32)
            stop = stop | (active & done).to(torch.int32)
        return model, alpha, ll_prev, steps, lls, vis, stop != 0, gammas

    def _inputs(log_beta, alpha, ll_prev):
        dev = log_beta.device
        return (torch.as_tensor(alpha, dtype=torch.float32, device=dev),
                torch.as_tensor(ll_prev, dtype=torch.float32, device=dev))

    def run_chunk_impl(log_beta, alpha, ll_prev, groups, n_steps,
                       gammas_in=None, have_prev=None) -> ChunkResult:
        alpha, ll_prev = _inputs(log_beta, alpha, ll_prev)
        gammas0, have_prev = _resolve_gammas(groups, gammas_in, have_prev)

        def iterate(lb, a, gammas, warm, stop):
            return em_iteration(lb, a, groups, gammas, warm, stop)

        log_beta, alpha, ll_prev, steps, lls, vis, converged, gammas = (
            _chunk_loop(log_beta, alpha, ll_prev, gammas0, n_steps,
                        have_prev, iterate))
        return ChunkResult(log_beta, alpha, ll_prev, lls, steps, converged,
                           gammas, vis)

    # -- single-dense-group fast path ------------------------------------
    # One full-V dense group of one batch with the stock M-step carries
    # exp(beta) in the kernel's padded [K, W] layout across iterations:
    # each iteration is kernel -> exp-space M-step (ss / total), with no
    # exp/log pass and no [V, K] transposes.  Log-space beta is rebuilt
    # once at the end of the dispatch.  Zero-mass entries pass through
    # exp(LOG_ZERO) (a float32 subnormal, 3.7e-44); like every subnormal
    # of the exp-space tables they are held as zero (the XLA semantics,
    # estep.flush_subnormal), and anything not above exp(LOG_ZERO) maps
    # back to LOG_ZERO exactly.  Quotients below the normal range
    # (< 1.2e-38) map to LOG_ZERO too, where m_step would write their log
    # (about -88 to -103): the JAX fast path floors them the same way.
    dense_fast_ok = m_fn is estep.m_step and dense_e_step_fn is None

    def _is_single_dense(groups) -> bool:
        return (dense_fast_ok and len(groups) == 1
                and len(groups[0]) == 3 and _is_dense(groups[0])
                and groups[0][0].shape[0] == 1)

    def run_chunk_impl_fast(log_beta, alpha, ll_prev, groups, n_steps,
                            gammas_in=None, have_prev=None) -> ChunkResult:
        alpha, ll_prev = _inputs(log_beta, alpha, ll_prev)
        dense, mask = (a[0] for a in groups[0][:2])
        cells = groups[0][2]
        w = dense.shape[0] if dense_wmajor else dense.shape[1]
        fp = (dense_estep.dense_fixed_point_w if dense_wmajor
              else dense_estep.dense_fixed_point)
        gammas0, have_prev = _resolve_gammas(groups, gammas_in, have_prev)
        exp_zero = torch.tensor(np.exp(np.float64(estep.LOG_ZERO)),
                                dtype=torch.float32, device=log_beta.device)

        def iterate(exp_beta, alpha, gammas, warm, stop):
            gamma, t, docll, ass, iters = fp(
                exp_beta, alpha, dense, mask, var_max_iters, var_tol,
                gamma_prev=gammas[0][0], warm=warm, stop=stop, cells=cells,
                precision=dense_precision)
            ll = docll.sum() + mask.sum() * estep.alpha_constant(alpha, k)
            suff = exp_beta * t                        # [K, W]
            total = suff.sum(-1, keepdim=True)         # pad columns are 0
            new_exp = estep.flush_subnormal(
                torch.where(suff > 0, suff / total, exp_zero))
            return (new_exp, new_alpha_of(ass.sum(), alpha), ll,
                    (gamma[None],), iters)

        exp_beta, alpha, ll_prev, steps, lls, vis, converged, gammas = (
            _chunk_loop(dense_estep.padded_exp_beta(log_beta, w), alpha,
                        ll_prev, gammas0, n_steps, have_prev, iterate))
        # Log-space beta, once.  A zero-step dispatch returns the INPUT
        # log_beta (log(exp(x)) drifts an ulp).
        eb = exp_beta[:, :v]
        new_log = torch.where(eb > exp_zero, torch.log(eb),
                              torch.full_like(eb, estep.LOG_ZERO))
        log_out = torch.where(steps > 0, new_log, log_beta)
        return ChunkResult(log_out, alpha, ll_prev, lls, steps, converged,
                           gammas, vis)

    def runner(log_beta, alpha, ll_prev, groups, n_steps, gammas_in=None,
               have_prev=None) -> ChunkResult:
        global LAST_CHUNK_PLAN
        if _is_single_dense(groups):
            LAST_CHUNK_PLAN, impl = "fast", run_chunk_impl_fast
        else:
            LAST_CHUNK_PLAN, impl = "generic", run_chunk_impl
        slot = yield_hook() if yield_hook is not None else nullcontext()
        rec = current_recorder()
        if rec is None:
            with slot:
                return impl(log_beta, alpha, ll_prev, groups, n_steps,
                            gammas_in, have_prev)
        # Under a recorder: the dispatch's enqueue span (the device work
        # is asynchronous; the driver's em.host_sync span holds the wait)
        # and the em.chunk_dispatches counter.
        with slot, rec.span("em.run_chunk", chunk=chunk,
                            n_steps=int(n_steps), plan=LAST_CHUNK_PLAN):
            out = impl(log_beta, alpha, ll_prev, groups, n_steps, gammas_in,
                       have_prev)
        rec.counter("em.chunk_dispatches").add(1)
        return out

    return runner
