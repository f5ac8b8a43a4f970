"""The dense-corpus E-step: the corpus densified once into C [B, W]
count matrices, and the fixed point as two contractions over W per
iteration (port of oni_ml_tpu/ops/dense_estep.py):

    q     = exp_et @ beta          # phinorm for every (doc, word) pair
    ratio = C / q                  # zero wherever C is zero
    gamma = alpha + exp_et * (ratio @ beta^T)
    T     = exp_et^T @ ratio       # suff stats:  SS[k,v] = beta[k,v]*T[k,v]

The identity behind T: phi_c[b,l,k] = beta[k,w]*exp_et[b,k]*c/phinorm, so
summing over the tokens of word v factors beta[k,v] out of the scatter —
what remains is a product over the doc axis, with no per-token index.

Two layouts of one function, each with the JAX package's name and
return contract: `dense_fixed_point` over C [B, W] (the row-major
`_dense_kernel`) and `dense_fixed_point_w` over C^T [W, B] (the W-major
`_dense_kernel_w`).  Each has two implementations:
- CUDA tensors launch `csrc/dense_estep.cu` (its header gives the
  design and what bounds it) and count the launch in `launch_count`
  (the kernel itself counts the launches that ran past the chunk
  driver's stop: `executed_count`);
- CPU tensors run `dense_fixed_point_reference`, the same arithmetic in
  PyTorch ops with the same per-block stop, vectorised over blocks.
There is no fallback between them: a CUDA tensor launches the kernel or
raises.  The layout changes nothing but the f32 summation order.

The TPU's block rules (W-major doc blocks in multiples of the 128-lane
tile, the VMEM model) do not carry over: `pick_block` sizes the doc
block for the card's 132 SMs and the kernel's registers, and
`launch_geometry` the shared memory that holds each block's lists of
non-zero cells (and the scratch that takes a block whose lists do not
fit).  A document has at most min(W, L) non-zero cells when its batch
was densified from [B, L] token lists: callers that know L pass it as
`cells`, which bounds both.

Precision (`LDAConfig.dense_precision`): "f32", or "bf16", the TPU
kernels' operand mode: beta, exp_et and each cell's ratio rounded to
bf16 (round-to-nearest-even) before the fixed point's two products,
whose sums stay f32; the tail runs in f32 on f32 beta.  On the TPU that
mode changes no result, since XLA's default matmul precision truncates
f32 operands to bf16 anyway; on the card the f32 path is full f32, so
bf16 here is a numeric mode of its own, held to tolerances against f32
(tests/test_torch_bf16.py).  In that mode the corpus is stored as bf16
where every densified cell is at most 256 (`corpus_dtype`, exact).  The
card runs it as its own instantiation of the kernel, counted apart in
`bf16_launch_count`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda, estep
from .special import digamma_pos, gammaln_pos
from .stop import fp_continue

KERNEL = "dense_estep"
# The bf16 mode's instantiations, the same source as libraries of their
# own (ops/_cuda.py VARIANTS): over a bf16-stored corpus, and over a
# float corpus (a cell above 256).
KERNEL_BF16 = "dense_estep_bf16"
KERNEL_BF16_F32CORPUS = "dense_estep_bf16_f32corpus"
# Largest doc block the kernel is compiled for (csrc/dense_estep.cu
# launch_bb).
MAX_BLOCK_DOCS = 4
# H100 SXM streaming multiprocessors: the block pick aims for at least
# one CTA per SM.
NUM_SMS = 132
# Topics the kernel's register arrays are compiled for.
MAX_TOPICS = 32
# Blocks wider than 2 docs are compiled only up to this many topics.
WIDE_BLOCK_TOPICS = 20
# Warps a CTA has (8 at most: csrc/dense_estep.cu kMaxThreads) where the
# batch has no more blocks than the card has SMs, shared evenly by the
# block's documents; a batch that fills the card runs one warp per
# document.  torch_kernel_sweep.py on an H100 at 700 W: at the flow day's
# B 1024 (256 blocks of 4) one warp per document ran 0.34-0.35 ms against
# 0.43 ms with two; at B 8 (blocks of 1) eight warps 0.21 ms against
# 0.28 ms with four.
CTA_WARPS = 8
# Dynamic shared memory for a block's cell lists: at most what one CTA may
# take (227 KB, less the kernel's static arrays), or, when the batch has
# more blocks than the card has SMs, what lets two CTAs share an SM.
SMEM_PER_CTA = 232_448
SMEM_STATIC = 4_096
SMEM_TWO_PER_SM = 102_400

launch_count = 0
# Of those, the launches of the bf16 instantiations (precision "bf16").
bf16_launch_count = 0
# Device counter of the launches that ran past the stop check.
_EXECUTED = _cuda.ExecutedCounters(1)
_FN: dict = {}   # library name -> (library, oni_dense_estep), typed once


def _kernel(name: str = KERNEL):
    if name not in _FN:
        lib = _cuda.load(name)
        fn = lib.oni_dense_estep
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, ll, ll, i, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, i, i, p, p, p, p, p, p, p, p, p, p,
                       p]
        fn.restype = i
        _FN[name] = (lib, fn)
    return _FN[name]


def reset_launch_count() -> None:
    """Zero the launch counts and the executed counter."""
    global launch_count, bf16_launch_count
    launch_count = bf16_launch_count = 0
    _EXECUTED.reset()


def executed_count() -> int:
    """Launches that ran past the stop check, counted by the kernel on
    the card since the last reset (a host sync)."""
    return _EXECUTED.read()[0]


def padded_width(num_terms: int) -> int:
    """Vocab width of the dense path: the next multiple of 128 (the
    JAX package's lane tile, kept so both packages densify to the same
    width).  The pad columns hold real zeros in C and in beta, so they
    add exact zeros to every contraction."""
    return -(-num_terms // 128) * 128


def kernel_cost(b: int, w: int, k: int, nnz_doc, nnz_block, block_iters,
                block: int, warm: bool,
                corpus_itemsize: int = 4) -> "tuple[float, float]":
    """(FLOPs, bytes) one launch needs for these inputs.  Every output
    depends only on the non-zero cells of C (a zero cell adds exactly
    zero to s, T and the token term), so: 4*K operations per non-zero
    cell per fixed-point iteration of its block (q and the s
    contraction), plus 4*K per non-zero cell for the tail (q and T)
    (`nnz_doc` per document, `nnz_block` and `block_iters` per block);
    bytes: C [B, W] read once at its storage width (`corpus_itemsize`:
    2 for a bf16 corpus), beta in (f32 in both modes: the bf16 mode
    rounds it in registers) and T out ([K, W] each), mask, gamma in when
    warm, gamma, docll and ass out, iterations per block."""
    nnz_doc = np.asarray(nnz_doc, np.int64)
    nnz_block = np.asarray(nnz_block, np.int64)
    block_iters = np.asarray(block_iters, np.int64)
    flops = float(4 * k * ((nnz_block * block_iters).sum() + nnz_doc.sum()))
    nbytes = (b * w * corpus_itemsize + 2 * k * w * 4 + b * 4
              + (b * k * 4 if warm else 0) + b * k * 4 + b * 8
              + (b // block) * 4)
    return flops, float(nbytes)


def _max_block(k: int) -> int:
    """The widest doc block the kernel is compiled for at K topics."""
    return MAX_BLOCK_DOCS if k <= WIDE_BLOCK_TOPICS else 2


def pick_block(b: int, v: int, k: int, precision: str = "f32") -> int:
    """Doc block for a batch of `b` docs on the card: the largest power
    of two <= _max_block(k) dividing `b` that still gives at least
    NUM_SMS blocks, else 1.  V does not enter: nothing in the kernel is
    sized by it; nor does the precision, which is checked (both modes
    stage the same f32 cells)."""
    _check_precision(precision)
    if b <= 0:
        raise ValueError(f"batch size must be positive, got {b}")
    if not 0 < k <= MAX_TOPICS:
        raise ValueError(f"K={k} outside the dense kernel's 1..{MAX_TOPICS}")
    bb = _max_block(k)
    while bb > 1 and (b % bb or b // bb < NUM_SMS):
        bb //= 2
    return bb


def launch_geometry(b: int, w: int, k: int, block: "int | None" = None,
                    cells: "int | None" = None) -> dict:
    """How csrc/dense_estep.cu runs a [B, W] batch whose documents have
    at most `cells` non-zero cells each (W unless given; L for a batch
    densified from [B, L] token lists): `block` documents per CTA
    (pick_block unless given), one warp each where the batch has more
    blocks than the card has SMs, else CTA_WARPS / block each; the
    dynamic shared memory (`smem_bytes`) that holds a block's non-zero
    cells, (K + 1) * 4 bytes each (`smem_cells`); `block_cells`, the most
    non-zero cells a block can have (block * min(W, cells)); and
    `scratch_bytes`, the per-launch scratch in device memory for the
    blocks whose cells do not fit, a slice of block_cells cells per
    block, or 0 where no block can overflow.  A block takes the scratch
    exactly when its non-zero cells outnumber smem_cells."""
    block = block or pick_block(b, w, k)
    if b % block:
        raise ValueError(f"doc block {block} does not divide batch size {b}")
    if cells is not None and cells <= 0:
        raise ValueError(f"cells per document must be positive, got {cells}")
    nb = b // block
    cell = 4 * (k + 1)
    block_cells = block * min(w, cells or w)
    cap = SMEM_TWO_PER_SM if nb > NUM_SMS else SMEM_PER_CTA - SMEM_STATIC
    smem = min(cap, block_cells * cell)
    wpd = 1 if nb > NUM_SMS else max(1, CTA_WARPS // block)
    return {"block": block, "docs_per_cta": block,
            "warps_per_doc": wpd, "threads": 32 * block * wpd,
            "ctas": nb, "cluster": 1, "smem_bytes": smem,
            "smem_cells": smem // cell, "block_cells": block_cells,
            "scratch_bytes": (0 if block_cells * cell <= smem
                              else nb * block_cells * cell)}


def pick_block_w(b: int, v: int, k: int, precision: str = "f32") -> int:
    """Doc block for the W-major layout: the same pick.  The TPU needed
    W-major blocks in multiples of its 128 lanes; the card has no such
    rule, so every shape is feasible in both layouts."""
    return pick_block(b, v, k, precision)


_PRECISIONS = ("f32", "bf16")


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown dense E-step precision {precision!r} (set via "
            "LDAConfig.dense_precision); expected one of "
            f"{'/'.join(_PRECISIONS)}"
        )


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (round-to-nearest-even, as XLA's astype and
    the card's __float2bfloat16_rn round) and upcast to float32."""
    return x.to(torch.bfloat16).float()


def max_dense_cell(word_idx, counts) -> float:
    """Largest value any densified cell will hold: the max over
    (doc, word) of the summed counts of duplicate tokens (the corpus
    keeps duplicate (doc, word) pairs as separate tokens, and the
    analyst-feedback path replicates a row 1,000 times), not the largest
    raw count.  Host arrays, as the JAX package's."""
    w = np.asarray(word_idx, np.int64)
    c = np.asarray(counts, np.float64)
    if w.size == 0:
        return 0.0
    docs = np.arange(w.shape[0], dtype=np.int64)[:, None]
    keys = (docs * (int(w.max()) + 1) + w).ravel()
    _, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv.ravel(), weights=c.ravel())
    return float(sums.max()) if sums.size else 0.0


def corpus_dtype(cell_max: float, precision: str = "f32") -> torch.dtype:
    """Storage dtype of the densified corpus: bf16 in the bf16 mode when
    every densified cell (max_dense_cell) is at most 256, the largest
    range in which bf16's 8 significand bits hold every integer, so the
    kernels read the exact counts from half the bytes; float32
    otherwise."""
    _check_precision(precision)
    if precision == "bf16" and cell_max <= 256:
        return torch.bfloat16
    return torch.float32


def densify(word_idx: torch.Tensor, counts: torch.Tensor, num_terms: int,
            width: "int | None" = None,
            dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """[B, L] token lists -> [B, W] dense counts, run once per run.  The
    scatter adds integer-valued counts in float32, so it is exact in any
    order (padding tokens carry count 0 and add nothing to column 0).
    `dtype` is the storage dtype (corpus_dtype): the sums convert to it
    once at the end, never accumulating in bf16."""
    if width is None:
        width = padded_width(num_terms)
    elif width < num_terms:
        raise ValueError(f"width {width} < num_terms {num_terms}")
    b = word_idx.shape[0]
    dense = torch.zeros((b, width), dtype=torch.float32, device=counts.device)
    dense.scatter_add_(1, word_idx.long(), counts.float())
    return dense if dtype is None else dense.to(dtype)


def padded_exp_beta(log_beta: torch.Tensor, width: int) -> torch.Tensor:
    """exp(log beta) [K, V] -> the kernel's [K, W] operand: subnormal
    entries zero, as XLA computes them (estep.flush_subnormal), and the
    pad columns zero."""
    eb = estep.flush_subnormal(torch.exp(log_beta.float()))
    k, v = eb.shape
    if width != v:
        eb = torch.nn.functional.pad(eb, (0, width - v))
    return eb.contiguous()


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def dense_fixed_point_reference(
    exp_beta: torch.Tensor,   # [K, W]
    alpha: torch.Tensor,      # scalar
    counts_bw: torch.Tensor,  # [B, W] (a transposed view is fine)
    doc_mask: torch.Tensor,   # [B]
    var_max_iters: int,
    var_tol: float,
    block: int,
    gamma_prev=None,          # [B, K] warm start
    warm=None,
    precision: str = "f32",
):
    """The kernel's arithmetic in PyTorch ops, vectorised over doc
    blocks: each block stops on its own max relative delta, converged
    blocks freeze.  With precision "bf16" the fixed point's two products
    read beta, exp_et and the ratio rounded to bf16, as the kernel's bf16
    instantiation does; the tail reads f32 beta.  Returns (gamma [B, K],
    T [K, W], docll [B], ass [B], iters [B // block] int32)."""
    _check_precision(precision)
    b, w = counts_bw.shape
    k = exp_beta.shape[0]
    nb = b // block
    dev = counts_bw.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    c = counts_bw.float()
    mask = doc_mask.float()
    n_d = c.sum(1, keepdim=True)
    mean0 = alpha + n_d / k
    inv_scale = 1.0 / mean0

    def e_log_theta(g):
        return digamma_pos(g) - digamma_pos(g.sum(1, keepdim=True))

    def qmat(exp_et, beta=exp_beta):
        return exp_et @ beta + 1e-30                      # [B, W]

    if precision == "bf16":
        beta_m, cast = round_bf16(exp_beta), round_bf16
    else:
        beta_m, cast = exp_beta, (lambda x: x)

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
        ratio = c / qmat(cast(exp_et), beta_m)
        gamma_new = alpha + exp_et * (cast(ratio) @ beta_m.t())
        d_doc = (gamma_new - gamma).abs().mean(1) * inv_scale[:, 0] * mask
        d_blk = d_doc.view(nb, block).max(1).values
        act_doc = active.repeat_interleave(block)[:, None]
        gamma = torch.where(act_doc, gamma_new, gamma)
        prev = torch.where(active, delta, prev)
        delta = torch.where(active, d_blk, delta)
        it = it + active.to(torch.int32)

    e_lt = e_log_theta(gamma)
    exp_et = torch.exp(e_lt)
    q = qmat(exp_et)
    ratio = (c / q) * mask[:, None]
    tok = (c * torch.log(q)).sum(1)
    core = (
        ((alpha - gamma) * e_lt + gammaln_pos(gamma)).sum(1)
        - gammaln_pos(gamma.sum(1))
    )
    docll = (core + tok) * mask
    ass = e_lt.sum(1) * mask
    t = (exp_et * mask[:, None]).t() @ ratio
    return gamma, t, docll, ass, it


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _launch_cuda(exp_beta, alpha, counts, wmajor, doc_mask, var_max_iters,
                 var_tol, block, cells, gamma_in, warm, stop, precision):
    global launch_count, bf16_launch_count
    k, w = exp_beta.shape
    b = counts.shape[1] if wmajor else counts.shape[0]
    dev = counts.device
    c_bf16 = counts.dtype == torch.bfloat16
    operands = [
        ("exp_beta", exp_beta, torch.float32, (k, w)),
        ("dense_counts", counts, torch.bfloat16 if c_bf16 else torch.float32,
         (w, b) if wmajor else (b, w)),
        ("doc_mask", doc_mask, torch.float32, (b,)),
        ("gamma_in", gamma_in, torch.float32, (b, k)),
        ("alpha", alpha, torch.float32, ()),
    ]
    if stop is not None:
        operands.append(("stop", stop, torch.int32, ()))
    _cuda.check_operands(dev, operands)
    if k > MAX_TOPICS:
        raise ValueError(f"K={k} exceeds the kernel's {MAX_TOPICS} topics")
    if block > _max_block(k) or block & (block - 1):
        raise ValueError(f"doc block {block} must be a power of two "
                         f"<= {_max_block(k)} at K={k}")
    # Element (d, w) of C sits at d * stride_d + w * stride_w.
    stride_d, stride_w = (1, b) if wmajor else (w, 1)
    geom = launch_geometry(b, w, k, block, cells)
    f32, i32 = torch.float32, torch.int32
    gamma = torch.empty((b, k), dtype=f32, device=dev)
    em = torch.empty((b, k), dtype=f32, device=dev)
    t = torch.empty((k, w), dtype=f32, device=dev)
    docll = torch.empty((b,), dtype=f32, device=dev)
    ass = torch.empty((b,), dtype=f32, device=dev)
    iters = torch.empty((b // block,), dtype=i32, device=dev)
    # The fixed point's hand-off to T: per 32-column group and document
    # the non-zero columns' mask and the list offset, and each cell's
    # c / q in list order (row d holds the first n_d entries).
    groups = -(-w // 32)
    masks = torch.empty((groups, b), dtype=i32, device=dev)
    pref = torch.empty((groups, b), dtype=i32, device=dev)
    ratio = torch.empty((b, w), dtype=f32, device=dev)
    scratch = (torch.empty((geom["scratch_bytes"] // 4,), dtype=f32,
                           device=dev) if geom["scratch_bytes"] else None)
    lib, fn = _kernel(KERNEL if precision == "f32" else KERNEL_BF16 if c_bf16
                      else KERNEL_BF16_F32CORPUS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            exp_beta.data_ptr(), counts.data_ptr(), stride_d, stride_w,
            int(wmajor), doc_mask.data_ptr(), gamma_in.data_ptr(),
            alpha.data_ptr(), _cuda.ptr(stop), _EXECUTED.slot(dev, 0),
            int(warm), b, w, k, block, geom["warps_per_doc"],
            int(var_max_iters), float(var_tol),
            geom["smem_bytes"], geom["block_cells"], _cuda.ptr(scratch),
            masks.data_ptr(), pref.data_ptr(), ratio.data_ptr(),
            gamma.data_ptr(), em.data_ptr(), docll.data_ptr(),
            ass.data_ptr(), iters.data_ptr(), t.data_ptr(), stream,
        )
    _cuda.check(lib, err, f"dense_estep launch, geometry {geom}")
    launch_count += 1
    if precision == "bf16":
        bf16_launch_count += 1
    return gamma, t, docll, ass, iters


def fixed_point_blocks(
    exp_beta: torch.Tensor,       # [K, W] exp(log beta), pad columns zero
    alpha: torch.Tensor,          # scalar f32 tensor on the corpus' device
    dense_counts: torch.Tensor,   # [B, W], or [W, B] with wmajor
    doc_mask: torch.Tensor,       # [B]
    var_max_iters: int,
    var_tol: float,
    block: "int | None" = None,
    wmajor: bool = False,
    gamma_prev=None,              # [B, K] warm start (None = fresh init)
    warm=None,                    # gates gamma_prev: 0 fresh, nonzero warm
    stop: "torch.Tensor | None" = None,   # int32 scalar stop flag
    cells: "int | None" = None,   # non-zero cells a doc may have (L)
    precision: str = "f32",       # "bf16": the bf16 operand mode
):
    """Dense E-step core -> (gamma [B, K], T [K, W], docll [B], ass [B],
    iters per block [B // block] int32), either layout.

    `dense_counts` may be stored as bf16 (corpus_dtype) only with
    precision "bf16", as the JAX package's drivers store it.

    `cells` bounds each document's non-zero cells (the L of the [B, L]
    token lists the batch was densified from; W when None) and so the
    card's per-launch scratch; a document with more non-zero cells than
    `cells` is the caller's error, which the kernel stops on.

    `stop` is the chunk driver's device-resident flag (models/fused.py):
    once it is nonzero the kernels return at once and the outputs hold
    no values (the driver discards them).  The plain version computes
    them all the same; the driver discards them there too."""
    _check_precision(precision)
    if dense_counts.dtype == torch.bfloat16 and precision != "bf16":
        raise ValueError("a bf16-stored corpus needs precision 'bf16' "
                         "(corpus_dtype stores bf16 in that mode only)")
    k = exp_beta.shape[0]
    b = dense_counts.shape[1] if wmajor else dense_counts.shape[0]
    bb = block or (pick_block_w if wmajor else pick_block)(
        b, exp_beta.shape[1], k, precision)
    if b % bb:
        raise ValueError(f"doc block {bb} does not divide batch size {b}")
    if gamma_prev is not None:
        estep.check_warm_pair(gamma_prev, warm)
    dev = dense_counts.device
    if dev.type == "cpu":
        return dense_fixed_point_reference(
            exp_beta, alpha, dense_counts.t() if wmajor else dense_counts,
            doc_mask, var_max_iters, var_tol, bb, gamma_prev=gamma_prev,
            warm=warm, precision=precision,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if gamma_prev is None or int(warm) == 0:
        gamma_in, warm_i = torch.zeros((b, k), dtype=torch.float32,
                                       device=dev), 0
    else:
        gamma_in, warm_i = gamma_prev, 1
    return _launch_cuda(exp_beta, torch.as_tensor(alpha), dense_counts,
                        wmajor, doc_mask, var_max_iters, var_tol, bb,
                        cells, gamma_in, warm_i, stop, precision)


def dense_fixed_point(exp_beta, alpha, dense_counts, doc_mask, var_max_iters,
                      var_tol, block=None, gamma_prev=None, warm=None,
                      stop=None, cells=None, precision="f32"):
    """Row-major C [B, W]: the JAX contract (gamma [B, K], T [K, W],
    docll [B], alpha_ss_part [B], iters = max over blocks).  docll is the
    per-doc ELBO without the alpha-prior constant."""
    gamma, t, docll, ass, iters = fixed_point_blocks(
        exp_beta, alpha, dense_counts, doc_mask, var_max_iters, var_tol,
        block=block, gamma_prev=gamma_prev, warm=warm, stop=stop,
        cells=cells, precision=precision)
    return gamma, t, docll, ass, iters.max()


def dense_fixed_point_w(exp_beta, alpha, dense_counts_t, doc_mask,
                        var_max_iters, var_tol, block=None, gamma_prev=None,
                        warm=None, stop=None, cells=None, precision="f32"):
    """W-major twin of dense_fixed_point over C^T [W, B]; same returns
    (gamma [B, K], as in the JAX package)."""
    gamma, t, docll, ass, iters = fixed_point_blocks(
        exp_beta, alpha, dense_counts_t, doc_mask, var_max_iters, var_tol,
        block=block, wmajor=True, gamma_prev=gamma_prev, warm=warm,
        stop=stop, cells=cells, precision=precision)
    return gamma, t, docll, ass, iters.max()


def e_step_dense(
    log_beta: torch.Tensor,      # [K, V]
    alpha: torch.Tensor,
    dense_counts: torch.Tensor,  # [B, W] from densify(), or [W, B] (wmajor)
    doc_mask: torch.Tensor,      # [B]
    var_max_iters: int,
    var_tol: float,
    block: "int | None" = None,
    wmajor: bool = False,
    gamma_prev=None,
    warm=None,
    exp_beta: "torch.Tensor | None" = None,
    stop: "torch.Tensor | None" = None,
    alpha_const: "torch.Tensor | None" = None,
    cells: "int | None" = None,
    precision: str = "f32",     # "bf16": the bf16 operand mode
) -> estep.EStepResult:
    """estep.e_step semantics over a densified batch.  Pass `exp_beta`
    (padded_exp_beta(log_beta, W)) and `alpha_const`
    (estep.alpha_constant) to share them across the batches of an EM
    iteration, and `cells` (the L the batch was densified from) to bound
    the card's scratch (fixed_point_blocks).  `exp_beta` stays f32 in
    both precisions: the bf16 mode rounds it for the fixed point only."""
    k, v = log_beta.shape
    w = dense_counts.shape[0] if wmajor else dense_counts.shape[1]
    if exp_beta is None:
        exp_beta = padded_exp_beta(log_beta, w)
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=dense_counts.device)
    fp = dense_fixed_point_w if wmajor else dense_fixed_point
    gamma, t, docll, ass, iters = fp(
        exp_beta, alpha, dense_counts, doc_mask, var_max_iters, var_tol,
        block=block, gamma_prev=gamma_prev, warm=warm, stop=stop,
        cells=cells, precision=precision)
    suff = (exp_beta * t)[:, :v].t()            # [V, K]
    if alpha_const is None:
        alpha_const = estep.alpha_constant(alpha, k)
    likelihood = docll.sum() + doc_mask.sum() * alpha_const
    return estep.EStepResult(gamma, suff, ass.sum(), likelihood, iters)
