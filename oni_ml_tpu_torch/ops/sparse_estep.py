"""The fused sparse E-step: the whole variational E-step of one batch in
one kernel launch, over live tokens only (port of
oni_ml_tpu/ops/sparse_estep.py).

Per EM iteration and batch, `e_step` builds nothing but the
exp(log beta)^T [V, K] table (once per EM iteration, shared by every
batch), launches the kernel — gamma fixed point, phi_c, per-doc ELBO
and sum_k E[log theta] — then sums the live tokens' phi_c into [V, K]
(`scatter_live`, the JAX package's segment-sum) and adds the
alpha-prior constant.  K x L work per document, not K x V.

Two functions, each with two implementations:
- `fixed_point_blocks`: CUDA tensors launch `csrc/sparse_estep.cu`'s
  E-step kernel (see its header for the design and what bounds it) under
  `launch_geometry` (docs per CTA, warps per document, a thread-block
  cluster per long document, the shared-memory tile that stages the live
  tokens' beta rows, or none where a tile cannot fit) and count the
  launch in `launch_count` (the kernel itself counts the launches that
  ran past the chunk driver's stop: `executed_counts`); CPU tensors run
  `fixed_point_full_reference`, the same arithmetic in PyTorch ops with
  the same per-block stop, vectorised over blocks.
- `scatter_live`: CUDA tensors launch the same file's scatter kernel,
  which sums each word's rows in a fixed order (no atomics, so the
  [V, K] sums and every artifact after them are the same from run to
  run), counted in `scatter_launch_count`; CPU tensors run
  `scatter_live_reference` (`index_add_`, which adds in the same order).
There is no fallback between them: a CUDA tensor launches the kernel or
raises.

Precision: "f32", or "bf16", the JAX kernel's bf16 slab: the
exp(log beta)^T table is rounded to bf16 once per EM iteration
(`exp_beta_table(..., "bf16")`, round-to-nearest-even as XLA's astype)
and everything downstream reads the rounded values upcast to f32
(phinorm, the gamma update, phi_c and the token term), with f32 sums and
an f32 gamma carry.  The kernel takes the table's dtype as its
precision; its bf16 instantiation counts apart in `bf16_launch_count`.
On the TPU that mode was the slab's storage; on the card it halves the
table's bytes, and its results differ from f32 within bf16 tolerances
(tests/test_torch_bf16.py).

Block semantics: every document of a block of `block` documents
iterates until the block's max relative delta says stop (ops/stop.py),
exactly the Pallas kernel's per-grid-step rule, so the two agree bit for
bit in their stop decisions at equal blocks (the tests pass the port's
block to the JAX kernel).
"""

from __future__ import annotations

import ctypes
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda, estep, pallas_estep
from .special import digamma_pos, gammaln_pos
from .stop import fp_continue

KERNEL = "sparse_estep"
# The bf16 table's instantiation: the same source, its own library
# (ops/_cuda.py VARIANTS).
KERNEL_BF16 = "sparse_estep_bf16"
# Largest doc block (the stop group): one CTA takes the whole block.
MAX_BLOCK_DOCS = 8
# H100 SXM streaming multiprocessors: the block pick aims for at least
# one CTA per SM.
NUM_SMS = 132
# Topics the kernel holds in registers (the largest compiled bound).
MAX_TOPICS = 64
# Threads a CTA may have and CTAs a cluster may have, as for the fixed
# point (the geometry is its rule): csrc/sparse_estep.cu kMaxThreads and
# kMaxCluster, the same numbers.
MAX_THREADS = pallas_estep.MAX_THREADS
MAX_CLUSTER = pallas_estep.MAX_CLUSTER

launch_count = 0           # E-step kernel launches
bf16_launch_count = 0      # of those, launches over a bf16 table
scatter_launch_count = 0   # scatter kernel launches
# Device counters of the launches that ran: E-step (0), scatter (1).
_EXECUTED = _cuda.ExecutedCounters(2)
# library name -> (library, oni_sparse_estep, oni_sparse_scatter), typed
# once per library
_FN: dict = {}


def _kernel(name: str = KERNEL):
    if name not in _FN:
        lib = _cuda.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.oni_sparse_estep
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p, p, p, p, p, p]
        fn.restype = i
        scatter = lib.oni_sparse_scatter
        scatter.argtypes = [p, p, p, p, p, p, i, i, p, p]
        scatter.restype = i
        _FN[name] = (lib, fn, scatter)
    return _FN[name]


def reset_launch_count() -> None:
    """Zero the launch counts and the executed counters."""
    global launch_count, scatter_launch_count, bf16_launch_count
    launch_count = scatter_launch_count = bf16_launch_count = 0
    _EXECUTED.reset()


def executed_counts() -> "tuple[int, int]":
    """(E-step, scatter) launches that ran past the stop check, counted
    by the kernels on the card since the last reset (a host sync)."""
    return tuple(_EXECUTED.read())


def pick_block(b: int) -> int:
    """Doc block for a batch of `b` docs on the card: the largest power
    of two <= MAX_BLOCK_DOCS dividing `b` that still gives at least
    NUM_SMS blocks, else 1 (a small batch spreads over as many SMs as it
    can).  Smaller blocks also stop each document closer to its own
    convergence.  L and K do not enter, unlike the TPU rule: the block
    only groups the stop decisions, and launch_geometry sizes the shared
    memory a block stages (a tile too large for 8 CTAs' shared memory is
    read from the table instead, so every L runs)."""
    if b <= 0:
        raise ValueError(f"batch size must be positive, got {b}")
    bb = MAX_BLOCK_DOCS
    while bb > 1 and (b % bb or b // bb < NUM_SMS):
        bb //= 2
    return bb


_PRECISIONS = ("f32", "bf16")


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown sparse E-step precision {precision!r}; expected "
            f"one of {'/'.join(_PRECISIONS)}"
        )


def pad_multiple_for(precision: str = "f32") -> int:
    """Batch-axis pad multiple of the bucketed layout, the JAX package's:
    8 for f32, 16 for bf16 (its bf16 doc blocks sit on a 16-row tile).
    Every doc block pick_block can return divides both, so the card needs
    no more than 8; the bf16 layout keeps 16, so the two packages' bf16
    batches have the same shapes."""
    _check_precision(precision)
    return 16 if precision == "bf16" else MAX_BLOCK_DOCS


def resolve_layout_len(config_value=None, use_plans: bool = True,
                       device=None) -> "tuple[int, str]":
    """The bucketed layout's minimum packed tile length (the floor
    `Corpus.bucketed_layout` pads buckets up to), resolved through the
    plan cache for a run on `device`: knob `sparse_estep_l`, default
    LDAConfig.sparse_min_bucket_len.  -> (length, source).

    `use_plans=False` resolves from config and default only: distributed
    EM pins it, since per-host plan caches may hold different winners
    and a rank-divergent floor would give ranks other per-shard batch
    shapes than the one-rank run, breaking its byte-identical
    artifacts."""
    from ..plans import resolve

    kw = {} if use_plans else {"store": None}
    val, src = resolve("sparse_estep_l", config_value, device=device, **kw)
    return max(1, int(val)), src


def launch_geometry(b: int, l: int, k: int, block: "int | None" = None) -> dict:
    """How the kernel runs a [B, L] bucket on the card: the fixed
    point's rule, pallas_estep.launch_geometry (a token stages K beta
    values and its count, 4 * (K + 1) bytes, in both kernels)."""
    return pallas_estep.launch_geometry(b, l, k, block or pick_block(b))


def available(b: int, l: int, k: int, device, precision: str = "f32") -> bool:
    """True where the per-batch dispatch may take this kernel: a CUDA
    device and K within the compiled bound, at either precision (an
    unknown one raises).  B and L do not enter: pick_block always finds a
    block, and where a document's tile does not fit in 8 CTAs' shared
    memory the kernel reads the beta table from device memory instead."""
    _check_precision(precision)
    return torch.device(device).type == "cuda" and 0 < k <= MAX_TOPICS


class LiveTokens(NamedTuple):
    """A batch's tokens with a non-zero count — the only rows the [V, K]
    scatter needs — and the order the scatter kernel sums them in."""

    pos: torch.Tensor          # [n] int64 flat positions, ascending
    words: torch.Tensor        # [n] int64 their word ids
    sorted_pos: torch.Tensor   # [n] int32 positions sorted by (word, position)
    seg_ptr: torch.Tensor      # [U + 1] int32 bounds of each word's run
    seg_word: torch.Tensor     # [U] int32 the distinct words


def live_tokens(word_idx: torch.Tensor, counts: torch.Tensor) -> LiveTokens:
    """The live-token plan of one batch.  Padding carries word id 0 and
    count 0, so it is left out (about half the slots of a flow day's
    buckets).  Fixed for a batch: the trainer computes it once at
    set-up, not per EM iteration (`nonzero` waits for the device)."""
    pos = torch.nonzero(counts.reshape(-1)).squeeze(1)
    words = word_idx.reshape(-1).long()[pos]
    order = torch.argsort(words, stable=True)
    seg_word, seg_len = torch.unique_consecutive(words[order],
                                                 return_counts=True)
    seg_ptr = torch.zeros(len(seg_len) + 1, dtype=torch.int64,
                          device=pos.device)
    torch.cumsum(seg_len, 0, out=seg_ptr[1:])
    return LiveTokens(pos, words, pos[order].int(), seg_ptr.int(),
                      seg_word.int())


def exp_beta_table(log_beta: torch.Tensor,
                   precision: str = "f32") -> torch.Tensor:
    """exp(log beta)^T as a contiguous [V, K] table, the kernel's beta
    operand, built once per EM iteration: float32, or with precision
    "bf16" rounded to bfloat16 (round-to-nearest-even, as XLA's astype
    rounds the JAX package's slab).  Subnormal entries are zero, as XLA
    computes them (estep.flush_subnormal), before the rounding, so no
    bf16 subnormal arises."""
    _check_precision(precision)
    table = estep.flush_subnormal(torch.exp(log_beta.float())).t().contiguous()
    return table.to(torch.bfloat16) if precision == "bf16" else table


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fixed_point_full_reference(
    expb_vk: torch.Tensor,    # [V, K] exp(log beta)^T, f32 or bf16
    alpha: torch.Tensor,      # scalar
    word_idx: torch.Tensor,   # [B, L]
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    block: int,
    gamma_prev=None,          # [B, K] warm start
    warm=None,
):
    """The kernel's arithmetic in PyTorch ops, vectorised over doc
    blocks: each block stops on its own max relative delta, converged
    blocks freeze.  A bf16 table (the bf16 mode) is upcast exactly and
    read everywhere, the tail included.  Returns (gamma [B, K],
    phi_c [B, L, K], docll [B], ass [B], iters [B // block] int32)."""
    b, l = counts.shape
    k = expb_vk.shape[1]
    nb = b // block
    dev = counts.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    slab = expb_vk[word_idx.long()].float()               # [B, L, K]
    counts = counts.float()
    mask = doc_mask.float()
    n_d = counts.sum(1, keepdim=True)                     # [B, 1]
    mean0 = alpha + n_d / k
    inv_scale = 1.0 / mean0

    def e_log_theta(g):
        return digamma_pos(g) - digamma_pos(g.sum(1, keepdim=True))

    def phinorm_of(exp_et):
        ph = torch.zeros_like(counts)
        for kk in range(k):
            ph = ph + slab[:, :, kk] * exp_et[:, kk:kk + 1]
        return ph + 1e-30

    gamma = mean0.expand(b, k).clone()
    if gamma_prev is not None:
        estep.check_warm_pair(gamma_prev, warm)
        if int(warm) != 0:
            gamma = gamma_prev.float().clone()
    it = torch.zeros(nb, dtype=torch.int32, device=dev)
    delta = torch.full((nb,), float("inf"), device=dev)
    prev = torch.full((nb,), float("inf"), device=dev)
    while True:
        active = fp_continue(it, delta, prev, var_max_iters, var_tol)
        if not bool(active.any()):
            break
        exp_et = torch.exp(e_log_theta(gamma))
        ratio = counts / phinorm_of(exp_et)
        gamma_new = alpha + exp_et * (ratio[:, :, None] * slab).sum(1)
        d_doc = (gamma_new - gamma).abs().mean(1) * inv_scale[:, 0] * mask
        d_blk = d_doc.view(nb, block).max(1).values
        act_doc = active.repeat_interleave(block)[:, None]
        gamma = torch.where(act_doc, gamma_new, gamma)
        prev = torch.where(active, delta, prev)
        delta = torch.where(active, d_blk, delta)
        it = it + active.to(torch.int32)

    e_lt = e_log_theta(gamma)
    exp_et = torch.exp(e_lt)
    phinorm = phinorm_of(exp_et)
    ratio = (counts / phinorm) * mask[:, None]
    tok = (counts * torch.log(phinorm)).sum(1)
    core = (
        ((alpha - gamma) * e_lt + gammaln_pos(gamma)).sum(1)
        - gammaln_pos(gamma.sum(1))
    )
    docll = (core + tok) * mask
    ass = e_lt.sum(1) * mask
    # Each contribution below the normal range is zero before the [V, K]
    # sum, as XLA flushes it (estep.flush_subnormal).
    phic = estep.flush_subnormal(slab * (ratio[:, :, None] * exp_et[:, None, :]))
    return gamma, phic, docll, ass, it


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _launch_cuda(expb_vk, alpha, word_idx, counts, doc_mask, var_max_iters,
                 var_tol, block, gamma_in, warm, stop):
    global launch_count, bf16_launch_count
    b, l = word_idx.shape
    k = expb_vk.shape[1]
    dev = word_idx.device
    bf16 = expb_vk.dtype == torch.bfloat16
    operands = [
        ("expb_vk", expb_vk, torch.bfloat16 if bf16 else torch.float32,
         (expb_vk.shape[0], k)),
        ("word_idx", word_idx, torch.int32, (b, l)),
        ("counts", counts, torch.float32, (b, l)),
        ("doc_mask", doc_mask, torch.float32, (b,)),
        ("gamma_in", gamma_in, torch.float32, (b, k)),
        ("alpha", alpha, torch.float32, ()),
    ]
    if stop is not None:
        operands.append(("stop", stop, torch.int32, ()))
    _cuda.check_operands(dev, operands)
    if k > MAX_TOPICS:
        raise ValueError(f"K={k} exceeds the kernel's {MAX_TOPICS} topics")
    if block > MAX_BLOCK_DOCS or block & (block - 1):
        raise ValueError(f"doc block {block} must be a power of two "
                         f"<= {MAX_BLOCK_DOCS}")
    geom = launch_geometry(b, l, k, block)
    gamma = torch.empty((b, k), dtype=torch.float32, device=dev)
    phic = torch.empty((b, l, k), dtype=torch.float32, device=dev)
    docll = torch.empty((b,), dtype=torch.float32, device=dev)
    ass = torch.empty((b,), dtype=torch.float32, device=dev)
    iters = torch.empty((b // block,), dtype=torch.int32, device=dev)
    lib, fn, _ = _kernel(KERNEL_BF16 if bf16 else KERNEL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            expb_vk.data_ptr(), word_idx.data_ptr(), counts.data_ptr(),
            doc_mask.data_ptr(), gamma_in.data_ptr(), alpha.data_ptr(),
            _cuda.ptr(stop), _EXECUTED.slot(dev, 0), int(warm), b, l, k, block,
            geom["warps_per_doc"], geom["cluster"], geom["tile_len"],
            int(geom["staged"]), int(var_max_iters), float(var_tol),
            gamma.data_ptr(), phic.data_ptr(), docll.data_ptr(),
            ass.data_ptr(), iters.data_ptr(), stream,
        )
    # A refused launch (a cluster the card cannot place, too much shared
    # memory) raises with its geometry; nothing retries on plain ops.
    _cuda.check(lib, err, f"sparse_estep launch, geometry {geom}")
    launch_count += 1
    if bf16:
        bf16_launch_count += 1
    return gamma, phic, docll, ass, iters


def fixed_point_blocks(
    expb_vk: torch.Tensor,    # [V, K] exp(log beta)^T, f32 or bf16
    alpha: torch.Tensor,      # scalar f32 tensor on the batch's device
    word_idx: torch.Tensor,   # [B, L] int32
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    block: "int | None" = None,
    gamma_prev=None,          # [B, K] warm start (None = fresh init)
    warm=None,                # gates gamma_prev: 0 fresh, nonzero warm
    stop: "torch.Tensor | None" = None,   # int32 scalar stop flag
):
    """Fused sparse E-step core -> (gamma [B, K], phi_c [B, L, K],
    docll [B], ass [B], iters per block [B // block] int32).  docll is
    the per-doc ELBO without the alpha-prior constant.

    `stop` is the chunk driver's device-resident flag (models/fused.py):
    once it is nonzero the kernel returns at once and the outputs hold
    no values (the driver discards them).  The plain version computes
    them all the same; the driver discards them there too."""
    b = word_idx.shape[0]
    k = expb_vk.shape[1]
    bb = block or pick_block(b)
    if b % bb:
        raise ValueError(f"doc block {bb} does not divide batch size {b}")
    if gamma_prev is not None:
        estep.check_warm_pair(gamma_prev, warm)
    if word_idx.device.type == "cpu":
        return fixed_point_full_reference(
            expb_vk, alpha, word_idx, counts, doc_mask, var_max_iters,
            var_tol, bb, gamma_prev=gamma_prev, warm=warm,
        )
    if word_idx.device.type != "cuda":
        raise ValueError(f"unsupported device {word_idx.device}")
    if gamma_prev is None or int(warm) == 0:
        gamma_in, warm_i = torch.zeros((b, k), dtype=torch.float32,
                                       device=word_idx.device), 0
    else:
        gamma_in, warm_i = gamma_prev, 1
    return _launch_cuda(expb_vk, torch.as_tensor(alpha), word_idx, counts,
                        doc_mask, var_max_iters, var_tol, bb, gamma_in,
                        warm_i, stop)


def fixed_point_full(expb_vk, alpha, word_idx, counts, doc_mask,
                     var_max_iters, var_tol, block=None, gamma_prev=None,
                     warm=None):
    """The JAX `fixed_point_full` contract: (gamma [B, K],
    phi_c [K, B, L] (a view of the kernel's [B, L, K] output), docll [B],
    alpha_ss_part [B], iters = max over blocks)."""
    gamma, phic, docll, ass, iters = fixed_point_blocks(
        expb_vk, alpha, word_idx, counts, doc_mask, var_max_iters,
        var_tol, block=block, gamma_prev=gamma_prev, warm=warm,
    )
    return gamma, phic.permute(2, 0, 1), docll, ass, iters.max()


def scatter_live_reference(phic: torch.Tensor, live: LiveTokens,
                           num_terms: int) -> torch.Tensor:
    """The scatter's plain version: [B, L, K] phi_c -> [V, K] sums over
    the live tokens, with a sequential `index_add_` in position order."""
    b, l, k = phic.shape
    suff = torch.zeros((num_terms, k), dtype=phic.dtype, device=phic.device)
    suff.index_add_(0, live.words, phic.reshape(b * l, k).index_select(0, live.pos))
    return suff


def scatter_live(phic: torch.Tensor, live: LiveTokens, num_terms: int,
                 stop: "torch.Tensor | None" = None) -> torch.Tensor:
    """[B, L, K] phi_c -> [V, K] sums over the batch's live tokens, each
    word's rows added in position order (no atomics: the same bits on
    every run, and the CPU's bits given the same phi_c)."""
    global scatter_launch_count
    b, l, k = phic.shape
    if phic.device.type == "cpu":
        return scatter_live_reference(phic, live, num_terms)
    if phic.device.type != "cuda":
        raise ValueError(f"unsupported device {phic.device}")
    n, u = live.sorted_pos.shape[0], live.seg_word.shape[0]
    operands = [
        ("phic", phic, torch.float32, (b, l, k)),
        ("sorted_pos", live.sorted_pos, torch.int32, (n,)),
        ("seg_ptr", live.seg_ptr, torch.int32, (u + 1,)),
        ("seg_word", live.seg_word, torch.int32, (u,)),
    ]
    if stop is not None:
        operands.append(("stop", stop, torch.int32, ()))
    _cuda.check_operands(phic.device, operands)
    suff = torch.zeros((num_terms, k), dtype=torch.float32, device=phic.device)
    lib, _, fn = _kernel()
    with torch.cuda.device(phic.device):
        stream = torch.cuda.current_stream(phic.device).cuda_stream
        err = fn(phic.data_ptr(), live.sorted_pos.data_ptr(),
                 live.seg_ptr.data_ptr(), live.seg_word.data_ptr(), _cuda.ptr(stop),
                 _EXECUTED.slot(phic.device, 1), u, k, suff.data_ptr(), stream)
    _cuda.check(lib, err, "sparse_scatter launch")
    scatter_launch_count += 1
    return suff


def e_step(
    log_beta: torch.Tensor,   # [K, V]
    alpha: torch.Tensor,      # scalar
    word_idx: torch.Tensor,   # [B, L] int32
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    gamma_prev=None,
    warm=None,
    block: "int | None" = None,
    expb_vk: "torch.Tensor | None" = None,
    live: "LiveTokens | None" = None,
    stop: "torch.Tensor | None" = None,
    alpha_const: "torch.Tensor | None" = None,
    precision: str = "f32",
) -> estep.EStepResult:
    """The whole E-step of one batch: kernel (or its plain version on
    the CPU), [V, K] scatter of phi_c over the live tokens, alpha-prior
    constant.  Pass `expb_vk` (exp_beta_table(log_beta, precision)) to
    share the table across the batches of an EM iteration (its dtype is
    then the precision), `live` (live_tokens(word_idx, counts)) to reuse
    the batch's plan, `alpha_const` (estep.alpha_constant) to share it
    too, and `stop` under the chunk driver (see fixed_point_blocks)."""
    k, v = log_beta.shape
    dev = word_idx.device
    if expb_vk is None:
        expb_vk = exp_beta_table(log_beta, precision)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    gamma, phic, docll, ass, iters = fixed_point_blocks(
        expb_vk, alpha, word_idx, counts, doc_mask, var_max_iters, var_tol,
        block=block, gamma_prev=gamma_prev, warm=warm, stop=stop,
    )
    suff = scatter_live(phic, live if live is not None
                        else live_tokens(word_idx, counts), v, stop=stop)
    if alpha_const is None:
        alpha_const = estep.alpha_constant(alpha, k)
    likelihood = docll.sum() + doc_mask.sum() * alpha_const
    return estep.EStepResult(gamma, suff, ass.sum(), likelihood, iters.max())


# Takes gamma_prev/warm; the drivers hand it their shared tables and
# plans (models/fused.py, models/lda.py).
e_step._oni_warm_capable = True
e_step._oni_sparse_engine = True


# ---------------------------------------------------------------------------
# FLOP accounting: effective (sparse) against dense-equivalent
# ---------------------------------------------------------------------------


def effective_flops(b: int, l: int, k: int, vi_iters: float) -> float:
    """FLOPs the E-step needs per EM iteration at this shape: two
    K-contractions over the [B, L] slab per fixed-point iteration plus
    the converged tail, 4*B*K*L*(vi+1)."""
    return 4.0 * b * k * l * (float(vi_iters) + 1.0)


def dense_equiv_flops(b: int, v: int, k: int, vi_iters: float) -> float:
    """FLOPs the dense engine does for the same batch: effective_flops
    with L replaced by padded_width(V)."""
    from . import dense_estep

    return 4.0 * b * k * dense_estep.padded_width(v) * (float(vi_iters) + 1.0)


def em_iteration_cost(num_docs: int, live_tokens: int, num_terms: int,
                      k: int, vi_iters: float) -> dict:
    """The analytic cost of one EM iteration over a corpus, whatever
    engine runs it: FLOPs effective_flops over the live (doc, word)
    entries; bytes each input read once (word ids and counts 8 per live
    entry, beta [V, K] and the previous gamma [D, K] in f32) and each
    output written once (beta and gamma).  `dense_equiv_flops` is what a
    dense formulation over the padded vocabulary does for the same
    iteration."""
    return {
        "flops": effective_flops(1, live_tokens, k, vi_iters),
        "bytes": float(8 * live_tokens + 8 * num_terms * k + 8 * num_docs * k),
        "dense_equiv_flops": dense_equiv_flops(num_docs, num_terms, k,
                                               vi_iters),
    }


def kernel_cost(b: int, l: int, k: int, v: int, live, doc_iters, block: int,
                warm: bool, table_itemsize: int = 4) -> "tuple[float, float]":
    """(FLOPs, bytes) one launch of the kernel needs for these inputs:
    4*K operations per live token for each fixed-point iteration its
    block ran, plus one for the tail (`live`, `doc_iters`: per document);
    bytes: each input read once (the [V, K] table at its storage width,
    `table_itemsize` 2 in the bf16 mode, word ids and counts, mask,
    alpha, gamma when warm) and each output written once (gamma,
    phi_c [B, L, K], docll and ass, iterations per block)."""
    live = np.asarray(live, np.int64)
    doc_iters = np.asarray(doc_iters, np.int64)
    flops = float(4 * k * (live * (doc_iters + 1)).sum())
    nbytes = (v * k * table_itemsize + b * l * 8 + b * 4 + 4
              + (b * k * 4 if warm else 0)
              + b * k * 4 + b * l * k * 4 + b * 8 + (b // block) * 4)
    return flops, float(nbytes)


def scatter_cost(live_tokens: int, words: int, launches: int, v: int,
                 k: int) -> "tuple[float, float]":
    """(FLOPs, bytes) of `launches` [V, K] scatters over these inputs:
    one add per live token and topic; the live rows of phi_c and their
    positions, the word runs read, each launch's [V, K] output written."""
    nbytes = (live_tokens * (k * 4 + 4) + words * 8
              + launches * (v * k * 4 + 4))
    return float(live_tokens * k), float(nbytes)


# ---------------------------------------------------------------------------
# Measured dense-vs-sparse crossover, persisted in the plan cache
# ---------------------------------------------------------------------------

# Per-process memo of resolved crossovers, keyed by device fingerprint
# and exact shape.
_CROSSOVER_CACHE: "dict[str, dict]" = {}


def density_pct(l: int, v: int) -> float:
    """Row density of the densified batch: L live-token columns out of
    V, the x-axis of the crossover."""
    return 100.0 * l / max(v, 1)


def _density_band(pct: float) -> int:
    """Log2 density band (clamped): a crossover measured at one shape
    serves neighbouring densities."""
    return max(-3, min(7, int(round(math.log2(max(pct, 1e-3))))))


def crossover_shapes(k: int, v: int, b: int, l: int,
                     precision: str) -> "tuple[str, str]":
    """(exact shape sig, density-band sig) the crossover records under;
    exact beats band at lookup."""
    exact = f"k{k}.v{v}.b{b}.l{l}.{precision}"
    band = f"dlog{_density_band(density_pct(l, v))}.k{k}.{precision}"
    return exact, band


def measure_crossover(k: int, v: int, b: int, l: int, *,
                      precision: str = "f32", reps: int = 2,
                      wmajor: bool = True, device="cuda") -> dict:
    """Time one E-step through each engine at this shape on `device`
    (the card; the CPU, where a caller asks for it, times the plain
    versions) and return the winner: {"engine", "dense_s", "sparse_s",
    "source", "shape", "e_steps"} (e_steps: the E-steps run per engine,
    warm-up included).  Both kernels are built and run once before any
    timing; the clock is read after torch.cuda.synchronize().  The fixed point
    runs var_max_iters 8 at var_tol 0, so both engines do the same
    iterations (the crossover compares cost per iteration, not
    convergence).  The live-token plan and the densified batch are made
    outside the timing (the drivers make them once per run), so the
    comparison is the per-EM-iteration cost the engine choice trades.
    An engine the card cannot run at this K times as None and loses;
    both infeasible gives "dense" (the dense family's own paths take
    over)."""
    from . import _cuda, dense_estep

    dev = torch.device(device)
    pad_multiple_for(precision)
    exact, _ = crossover_shapes(k, v, b, l, precision)
    rng = np.random.default_rng(0)
    noise = rng.uniform(size=(k, v)) + 1.0 / v
    log_beta = torch.as_tensor(np.log(noise / noise.sum(-1, keepdims=True)),
                               dtype=torch.float32).to(dev)
    word = torch.as_tensor(rng.integers(0, v, size=(b, l)),
                           dtype=torch.int32).to(dev)
    counts = torch.as_tensor(rng.integers(1, 5, size=(b, l)),
                             dtype=torch.float32).to(dev)
    mask = torch.ones((b,), dtype=torch.float32, device=dev)
    alpha = torch.tensor(2.5, dtype=torch.float32, device=dev)
    vi = 8
    sparse_ok = k <= MAX_TOPICS
    dense_ok = k <= dense_estep.MAX_TOPICS
    if dev.type == "cuda":
        _cuda.build([name for name, ok in (
            (KERNEL if precision == "f32" else KERNEL_BF16, sparse_ok),
            (dense_estep.KERNEL, dense_ok),
            (dense_estep.KERNEL_BF16, dense_ok and precision == "bf16"))
            if ok])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    runs = {}
    if sparse_ok:
        live = live_tokens(word, counts)
        runs["sparse"] = lambda: e_step(log_beta, alpha, word, counts, mask,
                                        vi, 0.0, live=live,
                                        precision=precision)
    if dense_ok:
        store = dense_estep.corpus_dtype(
            dense_estep.max_dense_cell(word.cpu().numpy(),
                                       counts.cpu().numpy()), precision)
        dense = dense_estep.densify(word, counts, v, dtype=store)
        if wmajor:
            dense = dense.t().contiguous()
        runs["dense"] = lambda: dense_estep.e_step_dense(
            log_beta, alpha, dense, mask, vi, 0.0, wmajor=wmajor,
            cells=word.shape[1], precision=precision)
    for run in runs.values():              # build, load and warm both
        run()
    sync()
    secs = {"sparse": None, "dense": None}
    for name, run in runs.items():
        best = float("inf")
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            best = min(best, time.perf_counter() - t0)
        secs[name] = best
    sparse_s, dense_s = secs["sparse"], secs["dense"]
    engine = ("sparse" if sparse_s is not None
              and (dense_s is None or sparse_s <= dense_s) else "dense")
    return {"engine": engine, "dense_s": dense_s, "sparse_s": sparse_s,
            "source": "measured", "shape": exact,
            "e_steps": {name: reps + 1 for name in runs}}


def crossover_kernels() -> str:
    """The build hashes of the kernels the crossover times (this module's
    and the dense E-step's), which key its plan entries: a redesigned
    kernel re-measures the engine choice."""
    from . import _cuda, dense_estep

    return "+".join(_cuda.source_digest(name)
                    for name in (KERNEL, dense_estep.KERNEL))


def _journal_crossover(rec: dict) -> None:
    """Journal a resolved crossover through the active recorder, so a
    run's engine choice can be told apart afterwards ({"kind":
    "estep_crossover"}).  Never raises."""
    try:
        from ..telemetry.spans import current_recorder

        r = current_recorder()
        if r is not None:
            r.journal_record({
                "kind": "estep_crossover",
                "engine": rec["engine"],
                "shape": rec["shape"],
                "dense_s": rec["dense_s"],
                "sparse_s": rec["sparse_s"],
                "source": rec["source"],
            })
    except Exception:
        pass


def engine_crossover(k: int, v: int, b: int, l: int, *,
                     precision: str = "f32", force: bool = False,
                     device="cuda") -> dict:
    """The measured dense-vs-sparse engine decision (_engine_crossover),
    journaled once per call through the active recorder."""
    rec = _engine_crossover(k, v, b, l, precision=precision, force=force,
                            device=device)
    _journal_crossover(rec)
    return rec


def _engine_crossover(k: int, v: int, b: int, l: int, *,
                      precision: str = "f32", force: bool = False,
                      device="cuda") -> dict:
    """The measured dense-vs-sparse engine decision for this shape on
    `device`.  ONI_ML_TPU_ESTEP_ENGINE=sparse|dense pins it (source
    "env"); else this process's memo; else a plan-cache entry for the
    device's fingerprint, exact shape before density band (source
    "plan", so a second run measures nothing); else a fresh
    measurement (source "measured"), persisted under both keys with its
    timings.  Memo and plan entries are keyed by the device and by the
    build hashes of both engines' kernels (crossover_kernels), so a
    crossover measured with other kernel sources is measured again."""
    from ..plans import lookup_value, note_sweep, plan_backend, record_value

    pad_multiple_for(precision)
    exact, band = crossover_shapes(k, v, b, l, precision)
    kernels = crossover_kernels()
    env = os.environ.get("ONI_ML_TPU_ESTEP_ENGINE", "")
    if env:
        if env not in ("sparse", "dense"):
            raise ValueError(f"ONI_ML_TPU_ESTEP_ENGINE={env!r}: expected "
                             "sparse or dense")
        return {"engine": env, "dense_s": None, "sparse_s": None,
                "source": "env", "shape": exact}
    memo_key = f"{plan_backend(device, kernels)}|{exact}"
    if not force and memo_key in _CROSSOVER_CACHE:
        return _CROSSOVER_CACHE[memo_key]
    if not force:
        for shape in (exact, band):
            planned = lookup_value("estep_engine", shape=shape, device=device,
                                   kernels=kernels)
            if isinstance(planned, dict):
                rec = {"engine": planned["engine"],
                       "dense_s": planned.get("dense_s"),
                       "sparse_s": planned.get("sparse_s"),
                       "source": "plan", "shape": shape}
                _CROSSOVER_CACHE[memo_key] = rec
                return rec
    rec = measure_crossover(k, v, b, l, precision=precision, device=device)
    _CROSSOVER_CACHE[memo_key] = rec
    note_sweep("estep_engine")
    value = {key: rec[key] for key in ("engine", "dense_s", "sparse_s")}
    measurements = {"dense_s": rec["dense_s"], "sparse_s": rec["sparse_s"]}
    for shape in (exact, band):
        record_value("estep_engine", value, shape=shape, source="autotune",
                     measurements=measurements, device=device,
                     kernels=kernels)
    return rec
