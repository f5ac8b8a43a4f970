"""The gamma fixed point over a gathered beta slab: the port of the
Pallas fixed point (oni_ml_tpu/ops/pallas_estep.py), whose TPU kernel
`_fixed_point_kernel` becomes `csrc/fixed_point_estep.cu`.

`e_step` is the drop-in for `estep.e_step` that the per-batch dispatch
calls for backend "pallas": it gathers the slab exp(log beta)[:, word_idx]
[K, B, L] from the port's flushed exp(log beta)^T table
(sparse_estep.exp_beta_table), converges gamma in the kernel, and leaves
phi, the [V, K] scatter and the ELBO to plain ops (ops/estep.py) — as the
JAX package leaves them to XLA.  On the card the scatter is the
position-ordered `sparse_scatter` kernel over the batch's live tokens,
so the sums are the same bits on every run; on the CPU it is
`index_add_`.

`fixed_point_blocks` has two implementations: CUDA tensors launch the
kernel (its header gives the design and what bounds it) and count the
launch in `launch_count` (the kernel itself counts the launches that ran
past the chunk driver's stop: `executed_count`); CPU tensors run
`fixed_point_reference`, the same arithmetic in PyTorch ops with the same
per-block stop, vectorised over blocks.  There is no fallback between
them: a CUDA tensor launches the kernel or raises.

Block semantics: every document of a block of `block` documents iterates
until the block's max relative delta says stop (ops/stop.py), the Pallas
kernel's per-grid-step rule, so the two agree in their stop decisions at
equal blocks (the tests pass the port's block to the JAX kernel).  The
TPU's block rule (`pick_block` there: up to 128 documents, sized by a
12 MiB VMEM model, none past L of about 9.7k at K=20) does not apply on
the card: `pick_block` here spreads a batch over the card's SMs, and
`launch_geometry` picks how the kernel runs each block: docs per CTA,
warps per document, a thread-block cluster per document for long
documents, and the shared-memory tile that stages the slab (or none,
where a tile cannot fit: the kernel then reads the slab from device
memory).  The kernel runs any L; it refuses only K above MAX_TOPICS.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, estep
from .special import digamma_pos
from .stop import fp_continue

KERNEL = "fixed_point_estep"
# Largest doc block (the stop group): one CTA takes the whole block.
MAX_BLOCK_DOCS = 8
# H100 SXM streaming multiprocessors: the block pick aims for at least
# one CTA per SM.
NUM_SMS = 132
# Topics the kernel holds in registers (the largest compiled bound).
MAX_TOPICS = 64
# Shared memory one CTA may take on the H100 (227 KB, opt-in above 48 KB),
# less the kernel's static arrays (4,736 bytes at MAX_THREADS and K <= 64,
# rounded up): the most a staged slab tile may hold.
SMEM_PER_CTA = 232_448
SMEM_STATIC = 5_120
# Thread-block clusters: the portable size limit.
MAX_CLUSTER = 8
# Threads a CTA may have: csrc/fixed_point_estep.cu kMaxThreads, the same
# number.
MAX_THREADS = 256
# Live tokens per warp the geometry aims for (4 per lane), and the least
# a CTA of a cluster should hold.  torch_kernel_sweep.py on an H100 at
# 700 W: at the flow day's B 1024, L 128 one warp per document (128) ran
# 0.246 ms, two (64) 0.30 ms; at B 8, L 4,096 four warps a CTA of a
# cluster of 8 (128) 0.090 ms, eight (64) 0.093 ms, two (256) 0.101 ms.
TOKENS_PER_WARP = 128
MIN_TOKENS_PER_CTA = 128

launch_count = 0
# Device counter of the launches that ran past the stop check.
_EXECUTED = _cuda.ExecutedCounters(1)
_FN = None   # (library, oni_fixed_point_estep), typed once


def _kernel():
    global _FN
    if _FN is None:
        lib = _cuda.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.oni_fixed_point_estep
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p, p, p]
        fn.restype = i
        _FN = (lib, fn)
    return _FN


def reset_launch_count() -> None:
    """Zero the launch count and the executed counter."""
    global launch_count
    launch_count = 0
    _EXECUTED.reset()


def executed_count() -> int:
    """Launches that ran past the stop check, counted by the kernel on
    the card since the last reset (a host sync)."""
    return _EXECUTED.read()[0]


def pick_block(b: int) -> int:
    """Doc block for a batch of `b` docs on the card, the sparse
    kernel's rule: the largest power of two <= MAX_BLOCK_DOCS dividing
    `b` that still gives at least NUM_SMS blocks, else 1.  The JAX rule
    (up to 128 docs under a VMEM model of 12 MiB) does not apply: the
    block only groups the stop decisions, and launch_geometry sizes what
    the kernel keeps in shared memory."""
    if b <= 0:
        raise ValueError(f"batch size must be positive, got {b}")
    bb = MAX_BLOCK_DOCS
    while bb > 1 and (b % bb or b // bb < NUM_SMS):
        bb //= 2
    return bb


def _tile_len(l: int, cluster: int) -> int:
    """Tokens of a document one CTA of a `cluster` stages: its share of
    L, rounded up to 4 (16-byte rows)."""
    return (-(-l // cluster) + 3) // 4 * 4


def launch_geometry(b: int, l: int, k: int, block: "int | None" = None) -> dict:
    """How the kernel runs a [K, B, L] slab on the card, a pure function
    of (B, L, K) and the card's 132 SMs:

    - `block`: documents per stop group, pick_block(B) unless given; one
      CTA (or one cluster) takes one block, so `docs_per_cta` = block;
    - `cluster`: CTAs per document, only for a block of one document:
      doubled (up to 8) while the batch leaves SMs idle and each CTA
      keeps at least MIN_TOKENS_PER_CTA tokens, then while a CTA's share
      of the slab does not fit in its shared memory;
    - `tile_len`, `smem_bytes`, `staged`: each CTA stages tile_len tokens
      (K slab rows and the counts) per document in shared memory where
      block * (K + 1) * 4 * tile_len bytes fit, else `staged` is False
      and the slab is read from device memory;
    - `warps_per_doc`: doubled while a warp would hold more than
      TOKENS_PER_WARP of the tile and the CTA stays within MAX_THREADS."""
    if b <= 0 or l <= 0 or not 0 < k <= MAX_TOPICS:
        raise ValueError(f"no launch geometry for B={b}, L={l}, K={k}")
    block = block or pick_block(b)
    if b % block:
        raise ValueError(f"doc block {block} does not divide batch size {b}")
    nb = b // block
    row = 4 * (k + 1)
    cap = SMEM_PER_CTA - SMEM_STATIC
    cluster = 1
    if block == 1:
        while (cluster < MAX_CLUSTER and nb * cluster * 2 <= NUM_SMS
               and -(-l // (cluster * 2)) >= MIN_TOKENS_PER_CTA):
            cluster *= 2
        while cluster < MAX_CLUSTER and row * _tile_len(l, cluster) > cap:
            cluster *= 2
    tile = _tile_len(l, cluster)
    smem = block * row * tile
    staged = smem <= cap
    wpd, limit = 1, MAX_THREADS // (32 * block)
    while wpd * 2 <= limit and wpd * TOKENS_PER_WARP < tile:
        wpd *= 2
    return {"block": block, "docs_per_cta": block, "warps_per_doc": wpd,
            "cluster": cluster, "ctas": nb * cluster,
            "threads": 32 * block * wpd, "tile_len": tile,
            "smem_bytes": smem if staged else 0, "staged": staged}


def available(b: int, l: int, k: int, device, precision: str = "f32") -> bool:
    """True where the per-batch dispatch may take this kernel: a CUDA
    device, K within the compiled bound, float32 slabs.  B and L do not
    enter (pick_block always finds a block; nothing is sized by L)."""
    return (torch.device(device).type == "cuda" and 0 < k <= MAX_TOPICS
            and precision == "f32")


def gather_slab(expb_vk: torch.Tensor, word_idx: torch.Tensor) -> torch.Tensor:
    """[V, K] exp(log beta)^T table + [B, L] word ids -> the contiguous
    [K, B, L] slab (one gather; subnormals already zero in the table)."""
    return expb_vk.t()[:, word_idx.long()].contiguous()


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fixed_point_reference(
    slab_kbl: torch.Tensor,   # [K, B, L]
    alpha: torch.Tensor,      # scalar
    counts: torch.Tensor,     # [B, L]
    doc_mask: torch.Tensor,   # [B]
    var_max_iters: int,
    var_tol: float,
    block: int,
    gamma_prev=None,          # [B, K] warm start
    warm=None,
):
    """The kernel's arithmetic in PyTorch ops, vectorised over doc
    blocks: each block stops on its own max relative delta, converged
    blocks freeze.  Returns (gamma [B, K], iters [B // block] int32)."""
    k, b, _ = slab_kbl.shape
    nb = b // block
    dev = counts.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    slab = slab_kbl.float()
    counts = counts.float()
    mask = doc_mask.float()
    mean0 = alpha + counts.sum(1, keepdim=True) / k       # [B, 1]
    inv_scale = 1.0 / mean0[:, 0]

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
        exp_et = torch.exp(digamma_pos(gamma)
                           - digamma_pos(gamma.sum(1, keepdim=True)))
        phinorm = torch.zeros_like(counts)
        for kk in range(k):                       # K-unrolled, as in Pallas
            phinorm = phinorm + slab[kk] * exp_et[:, kk:kk + 1]
        ratio = counts / (phinorm + 1e-30)
        gamma_new = alpha + exp_et * torch.stack(
            [(ratio * slab[kk]).sum(1) for kk in range(k)], 1)
        d_doc = (gamma_new - gamma).abs().mean(1) * inv_scale * mask
        d_blk = d_doc.view(nb, block).max(1).values
        act_doc = active.repeat_interleave(block)[:, None]
        gamma = torch.where(act_doc, gamma_new, gamma)
        prev = torch.where(active, delta, prev)
        delta = torch.where(active, d_blk, delta)
        it = it + active.to(torch.int32)
    return gamma, it


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _launch_cuda(slab_kbl, alpha, counts, doc_mask, var_max_iters, var_tol,
                 block, gamma_in, warm, stop):
    global launch_count
    k, b, l = slab_kbl.shape
    dev = counts.device
    operands = [
        ("slab_kbl", slab_kbl, torch.float32, (k, b, l)),
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
    iters = torch.empty((b // block,), dtype=torch.int32, device=dev)
    lib, fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(slab_kbl.data_ptr(), counts.data_ptr(), doc_mask.data_ptr(),
                 gamma_in.data_ptr(), alpha.data_ptr(), _cuda.ptr(stop),
                 _EXECUTED.slot(dev, 0), int(warm), b, l, k, block,
                 geom["warps_per_doc"], geom["cluster"], geom["tile_len"],
                 int(geom["staged"]), int(var_max_iters), float(var_tol),
                 gamma.data_ptr(), iters.data_ptr(), stream)
    # A refused launch (a cluster the card cannot place, too much shared
    # memory) raises with its geometry; nothing retries on plain ops.
    _cuda.check(lib, err, f"fixed_point_estep launch, geometry {geom}")
    launch_count += 1
    return gamma, iters


def fixed_point_blocks(
    slab_kbl: torch.Tensor,   # [K, B, L] f32
    alpha: torch.Tensor,      # scalar f32 tensor on the batch's device
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    block: "int | None" = None,
    gamma_prev=None,          # [B, K] warm start (None = fresh init)
    warm=None,                # gates gamma_prev: 0 fresh, nonzero warm
    stop: "torch.Tensor | None" = None,   # int32 scalar stop flag
):
    """-> (gamma [B, K], iters per block [B // block] int32).

    `stop` is the chunk driver's device-resident flag (models/fused.py):
    once it is nonzero the kernel returns at once and the outputs hold
    no values (the driver discards them).  The plain version computes
    them all the same; the driver discards them there too."""
    k, b, _ = slab_kbl.shape
    bb = block or pick_block(b)
    if b % bb:
        raise ValueError(f"doc block {bb} does not divide batch size {b}")
    if gamma_prev is not None:
        estep.check_warm_pair(gamma_prev, warm)
    dev = counts.device
    if dev.type == "cpu":
        return fixed_point_reference(slab_kbl, alpha, counts, doc_mask,
                                     var_max_iters, var_tol, bb,
                                     gamma_prev=gamma_prev, warm=warm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if gamma_prev is None or int(warm) == 0:
        gamma_in, warm_i = torch.zeros((b, k), dtype=torch.float32,
                                       device=dev), 0
    else:
        gamma_in, warm_i = gamma_prev, 1
    return _launch_cuda(slab_kbl, torch.as_tensor(alpha), counts, doc_mask,
                        var_max_iters, var_tol, bb, gamma_in, warm_i, stop)


def fixed_point(slab_kbl, alpha, counts, doc_mask, var_max_iters, var_tol,
                block=None, gamma_prev=None, warm=None, stop=None):
    """The JAX contract: (gamma [B, K], iters = max over blocks)."""
    gamma, iters = fixed_point_blocks(
        slab_kbl, alpha, counts, doc_mask, var_max_iters, var_tol,
        block=block, gamma_prev=gamma_prev, warm=warm, stop=stop)
    return gamma, iters.max()


def e_step(
    log_beta: torch.Tensor,   # [K, V]
    alpha: torch.Tensor,      # scalar
    word_idx: torch.Tensor,   # [B, L] int
    counts: torch.Tensor,     # [B, L] f32
    doc_mask: torch.Tensor,   # [B] f32
    var_max_iters: int,
    var_tol: float,
    gamma_prev=None,
    warm=None,
    block: "int | None" = None,
    expb_vk: "torch.Tensor | None" = None,
    live=None,
    stop: "torch.Tensor | None" = None,
) -> estep.EStepResult:
    """Drop-in for estep.e_step with the fixed point in the kernel (the
    JAX `pallas_estep.e_step`).  `block` defaults to pick_block(B).
    Pass `expb_vk` (sparse_estep.exp_beta_table) to share the table
    across the batches of an EM iteration, and on the card `live`
    (sparse_estep.live_tokens) to reuse the batch's scatter plan and
    `stop` under the chunk driver."""
    v = log_beta.shape[1]
    dev = word_idx.device
    if expb_vk is None:
        from .sparse_estep import exp_beta_table

        expb_vk = exp_beta_table(log_beta)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    slab = gather_slab(expb_vk, word_idx)                 # [K, B, L]
    gamma, iters = fixed_point(slab, alpha, counts, doc_mask, var_max_iters,
                               var_tol, block=block, gamma_prev=gamma_prev,
                               warm=warm, stop=stop)
    beta_bt = slab.permute(1, 2, 0)                        # [B, L, K]
    return estep.batch_tail(beta_bt, gamma, alpha, word_idx, counts,
                            doc_mask, v, iters, live=live, stop=stop)


# Takes gamma_prev/warm (the drivers warm-start it).
e_step._oni_warm_capable = True
