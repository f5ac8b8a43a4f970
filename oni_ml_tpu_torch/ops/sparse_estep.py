"""The fused sparse E-step: the whole variational E-step of one batch in
one kernel launch, over live tokens only (port of
oni_ml_tpu/ops/sparse_estep.py).

Per EM iteration and batch, `e_step` builds nothing but the
exp(log beta)^T [V, K] table (once per EM iteration, shared by every
batch), launches the kernel — gamma fixed point, phi_c, per-doc ELBO
and sum_k E[log theta] — then scatters the live tokens' phi_c into
[V, K] with `index_add_` and adds the alpha-prior constant, as the JAX
package leaves its segment-sum to XLA.  K x L work per document, not K x V.

Two implementations of one function, `fixed_point_blocks`:
- CUDA tensors launch `csrc/sparse_estep.cu` (see its header for the
  design and what bounds it) and count the launch in `launch_count`;
- CPU tensors run `fixed_point_full_reference`, the same arithmetic in
  PyTorch ops with the same per-block stop, vectorised over blocks.
There is no fallback between them: a CUDA tensor launches the kernel or
raises.

Block semantics: every document of a block of `block` documents
iterates until the block's max relative delta says stop (ops/stop.py),
exactly the Pallas kernel's per-grid-step rule, so the two agree bit for
bit in their stop decisions at equal blocks (the tests pass the port's
block to the JAX kernel).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, estep
from .special import digamma_pos, gammaln_pos
from .stop import fp_continue

KERNEL = "sparse_estep"
# Largest doc block: one warp per doc, 8 warps = 256 threads per CTA.
MAX_BLOCK_DOCS = 8
# H100 SXM streaming multiprocessors: the block pick aims for at least
# one CTA per SM.
NUM_SMS = 132
# Topics the kernel holds in registers (the largest compiled bound).
MAX_TOPICS = 64

launch_count = 0
_FN = None   # (library, its oni_sparse_estep), typed once at first load


def _kernel():
    global _FN
    if _FN is None:
        lib = _cuda.load(KERNEL)
        fn = lib.oni_sparse_estep
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float,
                       p, p, p, p, p, p]
        fn.restype = i
        _FN = (lib, fn)
    return _FN


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def pick_block(b: int) -> int:
    """Doc block for a batch of `b` docs on the card: the largest power
    of two <= MAX_BLOCK_DOCS dividing `b` that still gives at least
    NUM_SMS blocks, else 1 (a small batch spreads over as many SMs as it
    can).  Smaller blocks also stop each document closer to its own
    convergence.  L and K do not enter, unlike the TPU rule: the
    kernel's footprint does not grow with L, and K is bounded by
    MAX_TOPICS."""
    if b <= 0:
        raise ValueError(f"batch size must be positive, got {b}")
    bb = MAX_BLOCK_DOCS
    while bb > 1 and (b % bb or b // bb < NUM_SMS):
        bb //= 2
    return bb


def pad_multiple_for(precision: str = "f32") -> int:
    """Batch-axis pad multiple of the bucketed layout: every doc block
    pick_block can return divides a multiple of 8.  Only float32 beta is
    supported in this port."""
    if precision != "f32":
        raise ValueError(
            f"sparse E-step precision {precision!r} is not supported by "
            "the port; expected 'f32'"
        )
    return MAX_BLOCK_DOCS


def live_tokens(word_idx: torch.Tensor, counts: torch.Tensor):
    """(flat positions, word ids) of a batch's tokens with a non-zero
    count: the only rows the [V, K] scatter needs.  Padding carries word
    id 0 and count 0, so scattering it would pile every padding slot's
    atomics onto row 0 (about half the slots of a flow day's buckets).
    Fixed for a batch: the trainer computes it once, not per EM
    iteration (`nonzero` waits for the device)."""
    pos = torch.nonzero(counts.reshape(-1)).squeeze(1)
    return pos, word_idx.reshape(-1).long()[pos]


def exp_beta_table(log_beta: torch.Tensor) -> torch.Tensor:
    """exp(log beta)^T as a contiguous [V, K] float32 table — the
    kernel's beta operand, built once per EM iteration."""
    return torch.exp(log_beta.float()).t().contiguous()


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fixed_point_full_reference(
    expb_vk: torch.Tensor,    # [V, K] exp(log beta)^T
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
    blocks freeze.  Returns (gamma [B, K], phi_c [B, L, K], docll [B],
    ass [B], iters [B // block] int32)."""
    b, l = counts.shape
    k = expb_vk.shape[1]
    nb = b // block
    dev = counts.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    slab = expb_vk[word_idx.long()]                       # [B, L, K]
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
    phic = slab * (ratio[:, :, None] * exp_et[:, None, :])
    return gamma, phic, docll, ass, it


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _launch_cuda(expb_vk, alpha, word_idx, counts, doc_mask, var_max_iters,
                 var_tol, block, gamma_in, warm):
    global launch_count
    b, l = word_idx.shape
    k = expb_vk.shape[1]
    dev = word_idx.device
    for name, t, dtype, shape in (
        ("expb_vk", expb_vk, torch.float32, (expb_vk.shape[0], k)),
        ("word_idx", word_idx, torch.int32, (b, l)),
        ("counts", counts, torch.float32, (b, l)),
        ("doc_mask", doc_mask, torch.float32, (b,)),
        ("gamma_in", gamma_in, torch.float32, (b, k)),
        ("alpha", alpha, torch.float32, ()),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, word_idx on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k > MAX_TOPICS:
        raise ValueError(f"K={k} exceeds the kernel's {MAX_TOPICS} topics")
    if block > MAX_BLOCK_DOCS or block & (block - 1):
        raise ValueError(f"doc block {block} must be a power of two "
                         f"<= {MAX_BLOCK_DOCS}")
    gamma = torch.empty((b, k), dtype=torch.float32, device=dev)
    phic = torch.empty((b, l, k), dtype=torch.float32, device=dev)
    docll = torch.empty((b,), dtype=torch.float32, device=dev)
    ass = torch.empty((b,), dtype=torch.float32, device=dev)
    iters = torch.empty((b // block,), dtype=torch.int32, device=dev)
    lib, fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            expb_vk.data_ptr(), word_idx.data_ptr(), counts.data_ptr(),
            doc_mask.data_ptr(), gamma_in.data_ptr(), alpha.data_ptr(),
            int(warm), b, l, k, block, int(var_max_iters), float(var_tol),
            gamma.data_ptr(), phic.data_ptr(), docll.data_ptr(),
            ass.data_ptr(), iters.data_ptr(), stream,
        )
    _cuda.check(lib, err, "sparse_estep launch")
    launch_count += 1
    return gamma, phic, docll, ass, iters


def fixed_point_blocks(
    expb_vk: torch.Tensor,    # [V, K] exp(log beta)^T, f32
    alpha: torch.Tensor,      # scalar f32 tensor on the batch's device
    word_idx: torch.Tensor,   # [B, L] int32
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    block: "int | None" = None,
    gamma_prev=None,          # [B, K] warm start (None = fresh init)
    warm=None,                # gates gamma_prev: 0 fresh, nonzero warm
):
    """Fused sparse E-step core -> (gamma [B, K], phi_c [B, L, K],
    docll [B], ass [B], iters per block [B // block] int32).  docll is
    the per-doc ELBO without the alpha-prior constant."""
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
                        warm_i)


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
    live: "tuple[torch.Tensor, torch.Tensor] | None" = None,
) -> estep.EStepResult:
    """The whole E-step of one batch: kernel (or its plain version on
    the CPU), [V, K] scatter of phi_c over the live tokens, alpha-prior
    constant.  Pass `expb_vk` (exp_beta_table(log_beta)) to share the
    table across the batches of an EM iteration, and `live`
    (live_tokens(word_idx, counts)) to reuse the batch's live tokens."""
    k, v = log_beta.shape
    dev = word_idx.device
    if expb_vk is None:
        expb_vk = exp_beta_table(log_beta)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    gamma, phic, docll, ass, iters = fixed_point_blocks(
        expb_vk, alpha, word_idx, counts, doc_mask, var_max_iters, var_tol,
        block=block, gamma_prev=gamma_prev, warm=warm,
    )
    b, l = word_idx.shape
    pos, words = live if live is not None else live_tokens(word_idx, counts)
    suff = torch.zeros((v, k), dtype=torch.float32, device=dev)
    suff.index_add_(0, words, phic.reshape(b * l, k).index_select(0, pos))
    alpha_const = torch.lgamma(k * alpha) - k * torch.lgamma(alpha)
    likelihood = docll.sum() + doc_mask.sum() * alpha_const
    return estep.EStepResult(gamma, suff, ass.sum(), likelihood, iters.max())

