"""Sharded E/M steps over a single-process device mesh (port of
oni_ml_tpu/parallel/sharded.py).

Where the JAX package wraps ops/estep building blocks in `shard_map`,
the port runs the same body once per mesh slot from this process, in
slot order, each on its slot's device (parallel/mesh.py), and reduces
with the mesh's `psum` (a fixed pairwise tree over the slots, no
atomics) and `pmax`.  Two plans:

1. **Data-parallel** (`make_data_parallel_e_step`,
   `make_data_parallel_dense_e_step`): the batch shards over `data`,
   beta is the same on every slot, and suff-stats, alpha_ss and the
   likelihood psum over `data` (vi_iters pmaxes).  Each data slot runs
   the port's own E-step on its slice: `ops/estep.e_step`'s per-batch
   dispatch (on the card `auto` is the sparse kernel,
   csrc/sparse_estep.cu, and ONI_ML_TPU_ESTEP=pallas the fixed point,
   csrc/fixed_point_estep.cu) or the dense kernel (csrc/dense_estep.cu)
   on its [B/d, W] or [W, B/d] slice.  A mesh with a model axis above 1
   that does not shard the vocabulary runs each data row on its first
   model slot: the other slots would only repeat it.

2. **Vocab-sharded** (`make_vocab_sharded_fns`,
   `make_vocab_sharded_dense_e_step`): for huge-V corpora (BASELINE.json
   config 4, the high-cardinality DNS vocabulary) beta [K, V] and the
   suff-stats [V, K] shard their vocabulary over `model`.  The sparse
   plan gathers on each model slot only the beta columns it owns and
   psums the [B, L, K] slab over `model`; the fixed point and
   `phi_weighted` run on the slab, and each slot scatters into its own
   [V/m, K] slice (`estep.suff_stats`: on the card the scatter kernel).
   The dense plan holds C [B/d, W/m] per slot and psums one [B/d, K]
   product over `model` per fixed-point iteration.  The JAX package runs
   both plans' gathers, slab sums and matmuls through XLA, outside any
   Pallas kernel; the port runs them as plain torch ops (torch.matmul for
   the dense plan), and only the local scatter is a hand kernel.

Where a data row's model slots would compute the same value (gamma, the
stop decision, the per-document ELBO terms), the port computes it once
per data row, so the model group agrees by construction.

Inputs are whole tensors, or `mesh.Sharded` tensors the trainers placed
once per fit (a whole tensor is split here, on every call); the
replicated operands (beta, alpha, the shared tables, the chunk driver's
stop flag, gamma_prev) move to each slot's device at use, which is no
copy where the slots share a device.  Outputs land on the mesh's
primary device: gamma joined over `data`, the reductions psummed.

Each wrapper attributes the kernel launches of each slot's E-step to
that slot (`Mesh.launches`), so a run shows every slot launched.

Scope: these plans are host-local, the mesh spans one process's
devices (`parallel.local_mesh` under --multihost); the cross-process
reduction is the explicit suff-stats collective (parallel/allreduce.py)
over corpus-derived document shards (parallel/shard_plan.py).  A
multi-process run composes the two layers: the mesh within the process,
the collective across processes.
"""

from __future__ import annotations

import torch

from ..ops import estep
from ..ops.stop import fp_continue
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Sharded,
    Sharding,
    pmax,
    psum,
)


def kernel_launches() -> dict:
    """Launches so far of every hand kernel of the port."""
    from ..ops import dense_estep, pallas_estep, sparse_estep

    return {"sparse_estep": sparse_estep.launch_count,
            "sparse_scatter": sparse_estep.scatter_launch_count,
            "dense_estep": dense_estep.launch_count,
            "fixed_point_estep": pallas_estep.launch_count}


def _placed(x, mesh: Mesh, spec: tuple) -> Sharded:
    """x as placed over the mesh: as given, or split now."""
    if isinstance(x, Sharded):
        return x
    return Sharding(mesh, spec).put(x)


def _on(x, dev):
    """A replicated operand on `dev` (no copy where it is there)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return x


def _gamma_slice(gamma_prev, i: int, rows: int, dev):
    if gamma_prev is None:
        return None
    return gamma_prev[i * rows:(i + 1) * rows].to(dev)


def _check_batch(b: int, d: int) -> None:
    if b % d:
        raise ValueError(f"batch {b} not divisible by data axis {d}")


def _join(mesh: Mesh, outs: list, suff) -> estep.EStepResult:
    """One result from the data rows' results: gamma joined over `data`
    on the primary device, the reductions psummed (pmaxed)."""
    dev = mesh.primary
    return estep.EStepResult(
        gamma=torch.cat([o.gamma.to(dev) for o in outs]),
        suff_stats=suff,
        alpha_ss=psum([torch.as_tensor(o.alpha_ss) for o in outs]),
        likelihood=psum([torch.as_tensor(o.likelihood) for o in outs]),
        vi_iters=pmax([torch.as_tensor(o.vi_iters, dtype=torch.int32)
                       for o in outs]),
    )


def live_plans(mesh: Mesh, word_idx: Sharded, counts: Sharded):
    """The per-data-slot live-token plans of one batch placed over
    `data` (sparse_estep.live_tokens: what the card's scatter needs),
    made once per fit by the trainers; None on the CPU."""
    from ..ops import sparse_estep

    if mesh.device_type != "cuda":
        return None
    return tuple(sparse_estep.live_tokens(word_idx.block(i),
                                          counts.block(i))
                 for i in range(mesh.shape[DATA_AXIS]))


def make_data_parallel_e_step(mesh: Mesh):
    """e_step-compatible callable: the batch split over `data`, each data
    slot running `ops/estep.e_step` (the per-batch dispatch: its
    `backend`, ONI_ML_TPU_ESTEP and the device pick the path) on its
    slice, gamma joined, suff-stats / alpha_ss / likelihood psummed over
    `data`, vi_iters pmaxed.  `live` is `live_plans`' per-slot tuple;
    the other keyword operands are the drivers' shared tables, moved to
    each slot's device."""
    d = mesh.shape[DATA_AXIS]

    def wrapped(log_beta, alpha, word_idx, counts, doc_mask, var_max_iters,
                var_tol, gamma_prev=None, warm=None, backend="auto",
                expb_vk=None, live=None, stop=None, alpha_const=None,
                block=None):
        estep.check_warm_pair(gamma_prev, warm)
        b = word_idx.shape[0]
        _check_batch(b, d)
        spec = (DATA_AXIS,)
        w, c, m = (_placed(t, mesh, spec) for t in (word_idx, counts,
                                                     doc_mask))
        if live is None:
            live = live_plans(mesh, w, c)
        outs = []
        for i in range(d):
            dev = mesh.device(i, 0)
            kw = {}
            if gamma_prev is not None:
                kw = {"gamma_prev": _gamma_slice(gamma_prev, i, b // d, dev),
                      "warm": warm}
            before = kernel_launches()
            outs.append(estep.e_step(
                _on(log_beta, dev), _on(alpha, dev), w.block(i), c.block(i),
                m.block(i), var_max_iters, var_tol, backend=backend,
                expb_vk=_on(expb_vk, dev),
                live=None if live is None else live[i],
                stop=_on(stop, dev), alpha_const=_on(alpha_const, dev),
                block=block, **kw))
            mesh.count_launches(before, kernel_launches(), i)
        return _join(mesh, outs, psum([o.suff_stats for o in outs]))

    wrapped._oni_data_parallel = True  # lets the trainer's dense-mode
    wrapped._oni_warm_capable = True   # check recognize its own wrapper
    wrapped.mesh = mesh
    wrapped.make_plan = lambda w, c, num_terms: live_plans(mesh, w, c)
    return wrapped


def make_data_parallel_dense_e_step(mesh: Mesh, wmajor: bool = False,
                                    precision: str = "f32"):
    """Dense-corpus E-step (ops/dense_estep.py) over batch-sharded dense
    counts: each data slot runs the dense kernel (csrc/dense_estep.cu;
    its plain version on the CPU) on its local documents, suff-stats /
    likelihood psummed over `data`: the dense analogue of
    make_data_parallel_e_step.

    `dense` is the whole densified batch ([B, W] row-major or [W, B]
    W-major) or its placement over the mesh (spec (DATA, None), or
    (None, DATA) W-major); the local batch is B / data_size.  The
    keyword operands are e_step_dense's: the drivers' shared tables
    (moved to each slot's device) and `cells`.  `precision` is the dense
    kernel's mode on every slot (dense_estep: "bf16" takes its bf16
    instantiation, and the corpus may be stored as bf16)."""
    from ..ops import dense_estep

    dense_estep._check_precision(precision)
    d = mesh.shape[DATA_AXIS]
    batch_axis = 1 if wmajor else 0
    dense_spec = (None, DATA_AXIS) if wmajor else (DATA_AXIS, None)

    def wrapped(log_beta, alpha, dense, doc_mask, gamma_prev, warm,
                var_max_iters, var_tol, stop=None, alpha_const=None,
                cells=None, exp_beta=None, block=None):
        b = dense.shape[batch_axis]
        _check_batch(b, d)
        c = _placed(dense, mesh, dense_spec)
        m = _placed(doc_mask, mesh, (DATA_AXIS,))
        outs = []
        for i in range(d):
            dev = mesh.device(i, 0)
            before = kernel_launches()
            outs.append(dense_estep.e_step_dense(
                _on(log_beta, dev), _on(alpha, dev), c.block(i), m.block(i),
                var_max_iters, var_tol, block=block, wmajor=wmajor,
                gamma_prev=_gamma_slice(gamma_prev, i, b // d, dev),
                warm=warm, exp_beta=_on(exp_beta, dev), stop=_on(stop, dev),
                alpha_const=_on(alpha_const, dev), cells=cells,
                precision=precision))
            mesh.count_launches(before, kernel_launches(), i)
        return _join(mesh, outs, psum([o.suff_stats for o in outs]))

    wrapped._oni_data_parallel = True
    wrapped.mesh = mesh
    return wrapped


def make_vocab_sharded_dense_e_step(mesh: Mesh, precision: str = "f32"):
    """Dense-corpus E-step with the VOCABULARY sharded over `model` and
    documents over `data` (BASELINE.json config 4, the high-cardinality
    DNS vocabulary of dns_pre_lda.scala:320-326).

    Slot (i, j) owns C_l [B/d, W/m] (its doc rows x its vocab columns)
    and beta_l [K, W/m]; the densified corpus never exists whole on any
    slot.  Per fixed-point iteration the only collective is the
    gamma-update contraction s = psum_model(ratio_l @ beta_l^T), a
    [B/d, K] array, because q[b, w] and ratio[b, w] are local to the
    vocab slot that owns column w, while gamma and exp_et belong to the
    data row: computed once per row from the psummed s, so the gamma
    update and the stop are the same across the model group by
    construction.  Each data row runs its own loop to its own stop.  The
    contractions are torch.matmul, as the JAX package leaves them to XLA.

    Semantics match ops/dense_estep.e_step_dense (same fresh init, same
    q + 1e-30 guard, same masked-delta stop, full-f32 tail, warm start
    via gamma_prev/warm, and with precision "bf16" its in-loop rounding
    of beta, exp_et and the ratio to bf16 before each product; the
    corpus may be stored as bf16).  Requirements: dense width ==
    log_beta width, both divisible by the model-axis size; batch
    divisible by the data-axis size.  Pad the vocab with pad_vocab + LOG_ZERO beta
    columns: padded C columns are zero, so every contraction over them is
    exact.  `host_stop` (default: off the card) reads each iteration's
    stop on the host; on the card every iteration is enqueued and a
    stopped one leaves the state as it was (estep.fixed_point's rule)."""
    from ..ops import dense_estep

    dense_estep._check_precision(precision)
    d_sz, m_sz = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    cast = dense_estep.round_bf16 if precision == "bf16" else (lambda x: x)

    def row(i, log_beta, alpha, c, m, gamma_prev, warm, var_max_iters,
            var_tol, host_stop):
        dev = mesh.device(i, 0)
        w_l = log_beta.shape[1] // m_sz
        betas = [estep.flush_subnormal(torch.exp(
            log_beta[:, j * w_l:(j + 1) * w_l].to(mesh.device(i, j))))
            for j in range(m_sz)]                     # [K, W_l] per slot
        betas_m = [cast(bj) for bj in betas]           # the fixed point's
        cs = [c.block(i, j).float() for j in range(m_sz)]   # [B_l, W_l]
        mask = m.block(i).to(dev)
        k = log_beta.shape[0]
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
        n_d = psum([cj.sum(1, dtype=torch.float32) for cj in cs]).to(dev)
        # Relative stop normalizer, the row's own.
        inv_scale = 1.0 / (alpha + n_d / k)
        gamma = alpha + (n_d / k)[:, None] + torch.zeros(
            (cs[0].shape[0], k), dtype=torch.float32, device=dev)
        if gamma_prev is not None and int(warm) != 0:
            gamma = gamma_prev.to(dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        delta = prev = torch.full((), float("inf"), device=dev)
        for _ in range(max(0, var_max_iters)):
            go = fp_continue(it, delta, prev, var_max_iters, var_tol)
            if host_stop and not bool(go):
                break
            exp_et = torch.exp(estep.e_log_dirichlet(gamma))   # [B_l, K]
            parts = []
            for j in range(m_sz):
                e_j = cast(exp_et).to(betas[j].device)
                ratio = cs[j] / (e_j @ betas_m[j] + 1e-30)
                parts.append(cast(ratio) @ betas_m[j].t())  # [B_l, K]: psum
            s = psum(parts).to(dev)
            gamma_new = alpha + exp_et * s
            new_delta = torch.max(
                (gamma_new - gamma).abs().mean(1) * inv_scale * mask)
            gamma = torch.where(go, gamma_new, gamma)
            prev = torch.where(go, delta, prev)
            delta = torch.where(go, new_delta, delta)
            it = it + go.to(torch.int32)
        # Full-f32 tail off the converged gamma (dense-kernel semantics).
        e_lt = estep.e_log_dirichlet(gamma)
        exp_et = torch.exp(e_lt)
        mask_col = mask[:, None]
        suffs, toks = [], []
        for j in range(m_sz):
            dj = betas[j].device
            e_j, mc = exp_et.to(dj), mask_col.to(dj)
            q = e_j @ betas[j] + 1e-30
            ratio = (cs[j] / q) * mc
            t_l = (e_j * mc).t() @ ratio                # [K, W_l]
            suffs.append((betas[j] * t_l).t())          # [W_l, K]
            toks.append((cs[j] * torch.log(q) * mc).sum())
        # The token ELBO term spans the sharded vocab axis: psum over
        # model.  The gamma-Dirichlet terms and alpha_ss are per-doc
        # quantities, the same on every model slot of a data row: they
        # are summed over data ONLY (a model psum would count them m
        # times), so here they are computed once per row.
        tok = psum(toks).to(dev)
        core = ((((alpha - gamma) * e_lt + torch.lgamma(gamma)).sum(1)
                 - torch.lgamma(gamma.sum(1))) * mask).sum()
        alpha_const = torch.lgamma(k * alpha) - k * torch.lgamma(alpha)
        ll = core + tok + mask.sum() * alpha_const
        ass = (e_lt.sum(1) * mask).sum()
        return estep.EStepResult(gamma, suffs, ass, ll, it)

    def wrapped(log_beta, alpha, dense, doc_mask, gamma_prev, warm,
                var_max_iters, var_tol, host_stop=None, **_):
        b, w = dense.shape
        if b % d_sz:
            raise ValueError(
                f"batch {b} not divisible by data axis {d_sz}"
            )
        if w % m_sz:
            raise ValueError(
                f"dense width {w} not divisible by model axis {m_sz} "
                "(pad with parallel.pad_vocab)"
            )
        if log_beta.shape[1] != w:
            raise ValueError(
                f"log_beta width {log_beta.shape[1]} != dense width {w} "
                "(pad log_beta with LOG_ZERO columns to match)"
            )
        if host_stop is None:
            host_stop = mesh.device_type != "cuda"
        c = _placed(dense, mesh, (DATA_AXIS, MODEL_AXIS))
        m = _placed(doc_mask, mesh, (DATA_AXIS,))
        outs = [row(i, log_beta, alpha, c, m,
                    _gamma_slice(gamma_prev, i, b // d_sz, mesh.device(i)),
                    warm, var_max_iters, var_tol, host_stop)
                for i in range(d_sz)]
        # [W/m, K] per model slot, psummed over data, joined over model.
        suff = torch.cat([psum([o.suff_stats[j] for o in outs])
                          .to(mesh.primary) for j in range(m_sz)])
        return _join(mesh, outs, suff)

    wrapped._oni_vocab_sharded = True
    wrapped.mesh = mesh
    return wrapped


class VocabPlan:
    """One batch's per-slot plan for the vocab-sharded sparse E-step:
    for slot (i, j), its tokens' ids local to the slot's vocabulary
    slice (clipped to it), which of them the slot owns, and the live
    tokens the slot's scatter adds (its owned tokens with a non-zero
    count: on the card the scatter kernel's plan, None on the CPU).
    Fixed for a batch: the trainers make it once per fit."""

    def __init__(self, mesh: Mesh, word_idx: Sharded, counts: Sharded,
                 num_terms: int):
        from ..ops import sparse_estep

        m_sz = mesh.shape[MODEL_AXIS]
        v_local = num_terms // m_sz
        self.v_local = v_local
        self.safe, self.owned, self.live = [], [], []
        for i in range(mesh.shape[DATA_AXIS]):
            safe_r, owned_r, live_r = [], [], []
            for j in range(m_sz):
                local = word_idx.block(i, j).long() - j * v_local
                owned = (local >= 0) & (local < v_local)
                safe = local.clamp(0, v_local - 1)
                safe_r.append(safe)
                owned_r.append(owned)
                live_r.append(
                    sparse_estep.live_tokens(
                        safe, counts.block(i, j) * owned)
                    if mesh.device_type == "cuda" else None)
            self.safe.append(safe_r)
            self.owned.append(owned_r)
            self.live.append(live_r)


def make_vocab_sharded_fns(mesh: Mesh):
    """Returns (e_step_fn, m_step_fn) with beta / suff-stats
    vocab-sharded over `model` and batches sharded over `data`.

    Global shapes stay [K, V] / [V, K]; each slot sees its [K, V/m] /
    [V/m, K] slice.  V must be divisible by the model-axis size (pad the
    vocabulary: padded words never appear in word_idx, so their
    suff-stats stay zero and m_step floors them to LOG_ZERO).  The
    e_step_fn takes the batch's `VocabPlan` as `live` (the trainers make
    it once per fit; a call without one makes it)."""
    d_sz, m_sz = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]

    def e_step_fn(log_beta, alpha, word_idx, counts, doc_mask,
                  var_max_iters, var_tol, gamma_prev=None, warm=None,
                  live=None, stop=None, **_):
        estep.check_warm_pair(gamma_prev, warm)
        k, v = log_beta.shape
        if v % m_sz:
            raise ValueError(
                f"vocab size {v} not divisible by model axis {m_sz}"
            )
        b = word_idx.shape[0]
        _check_batch(b, d_sz)
        spec = (DATA_AXIS,)
        w, c, m = (_placed(t, mesh, spec) for t in (word_idx, counts,
                                                     doc_mask))
        plan = live if live is not None else VocabPlan(mesh, w, c, v)
        vl = plan.v_local
        outs, ss = [], [[] for _ in range(m_sz)]
        for i in range(d_sz):
            dev = mesh.device(i, 0)
            # Gather only locally-owned words, zero elsewhere; the psum
            # over the model axis assembles the full [B/d, L, K] slab.
            slabs = []
            for j in range(m_sz):
                dj = mesh.device(i, j)
                slab_l = estep.gather_beta(
                    log_beta[:, j * vl:(j + 1) * vl].to(dj),
                    plan.safe[i][j])
                slabs.append(torch.where(plan.owned[i][j][..., None],
                                         slab_l, 0.0))
            beta_bt = psum(slabs).to(dev)
            a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
            cnt, mask = c.block(i), m.block(i)
            gamma, iters = estep.fixed_point(
                beta_bt, a, cnt, mask, var_max_iters, var_tol,
                gamma_prev=_gamma_slice(gamma_prev, i, b // d_sz, dev),
                warm=warm)
            phi_c, phinorm = estep.phi_weighted(beta_bt, gamma, cnt, mask)
            for j in range(m_sz):
                dj = mesh.device(i, j)
                # Scatter only into the owned vocab slice.
                phi_j = torch.where(plan.owned[i][j][..., None],
                                    phi_c.to(dj), 0.0)
                before = kernel_launches()
                ss[j].append(estep.suff_stats(
                    phi_j, plan.safe[i][j], vl, live=plan.live[i][j],
                    stop=_on(stop, dj)))
                mesh.count_launches(before, kernel_launches(), i, j)
            likelihood, alpha_ss = estep.batch_likelihood(
                gamma, phinorm, cnt, a, mask)
            outs.append(estep.EStepResult(gamma, None, alpha_ss,
                                          likelihood, iters))
        suff = torch.cat([psum(ss[j]).to(mesh.primary)
                          for j in range(m_sz)])
        return _join(mesh, outs, suff)

    def m_step_fn(suff):
        # Per-topic totals need the full vocab: the model slots' local
        # sums psummed over `model`, then each slot's M-step against the
        # global normalizer.
        v = suff.shape[0]
        if v % m_sz:
            raise ValueError(
                f"vocab size {v} not divisible by model axis {m_sz}"
            )
        vl = v // m_sz
        parts = [suff[j * vl:(j + 1) * vl].to(mesh.device(0, j))
                 for j in range(m_sz)]
        total = psum([estep.flush_subnormal(p.t()).sum(-1, keepdim=True)
                      for p in parts])
        return torch.cat([estep.m_step(p, topic_total=total.to(p.device))
                          .to(mesh.primary) for p in parts], dim=1)

    # Lets the trainer's dense-mode check recognize this package's own
    # vocab-sharded plan.
    e_step_fn._oni_vocab_sharded = True
    e_step_fn._oni_warm_capable = True
    e_step_fn.mesh = mesh
    e_step_fn.make_plan = lambda w, c, num_terms: VocabPlan(mesh, w, c,
                                                            num_terms)
    m_step_fn._oni_vocab_sharded = True
    return e_step_fn, m_step_fn


def pad_vocab(v: int, model_size: int) -> int:
    """Smallest padded vocab size divisible by the model axis."""
    return -(-v // model_size) * model_size


def make_sharded_score_fn(mesh: Mesh):
    """Data-parallel event SCORING over the mesh the training side holds:
    the event axis (int32 model-row index arrays) splits over `data`,
    theta / p are the same on every slot, and each data slot runs the
    scoring pipeline's own gather-dot (`score_dot_rows`) on its slice,
    with no collective (the per-event dot is embarrassingly parallel).

    Returns fn(theta, p, ip_idx [N], word_idx [N]) -> scores [N] on the
    primary device; theta / p are tensors or {device: tensor} replicas
    (scoring/pipeline.py places them once per model and mesh).  N must
    divide by the data-axis size (the pipeline's chunker guarantees it).
    Each event's score depends on its two rows alone, so the sharded
    scores are the unsharded scorer's, bit for bit."""
    from ..scoring.pipeline import score_dot_rows

    d = mesh.shape[DATA_AXIS]

    def fn(theta, p, ip_idx, word_idx):
        n = ip_idx.shape[0]
        if n % d:
            raise ValueError(f"{n} events not divisible by data axis {d}")
        per = n // d
        outs = []
        for i in range(d):
            dev = mesh.device(i, 0)
            th = theta[dev] if isinstance(theta, dict) else theta.to(dev)
            pp = p[dev] if isinstance(p, dict) else p.to(dev)
            outs.append(score_dot_rows(
                th, pp, ip_idx[i * per:(i + 1) * per].to(dev),
                word_idx[i * per:(i + 1) * per].to(dev)).to(mesh.primary))
        return torch.cat(outs)

    fn.mesh = mesh
    return fn
