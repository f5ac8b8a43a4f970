"""Shared stop rule for the variational fixed point (port of
oni_ml_tpu/ops/stop.py).

Every E-step path of the port — the plain PyTorch fixed points and the
CUDA kernel (csrc/sparse_estep.cu spells the same predicate in C++) —
stops the gamma iteration with:

continue while  it < var_max_iters
          and  (it == 0
                or (delta > var_tol                       # not converged
                    and (delta >= STALL_GATE              # still far out
                         or delta < prev)))               # still shrinking

where `delta` is the block max over docs of mean_k |gamma_new - gamma|
RELATIVE to the doc's mean gamma (alpha + N_d/K, an exact iteration
invariant).  The stagnation exit only fires below STALL_GATE, where a
growing delta means the iterate sits at its arithmetic's noise floor.
"""

from __future__ import annotations

import torch

STALL_GATE = 1e-2


def fp_continue(it, delta, prev, var_max_iters: int, var_tol: float):
    """Continue-predicate on tensors (any broadcastable shapes: a scalar
    per batch, or one entry per doc block)."""
    it = torch.as_tensor(it)
    delta = torch.as_tensor(delta)
    prev = torch.as_tensor(prev)
    return torch.logical_and(
        it < var_max_iters,
        torch.logical_or(
            it == 0,
            torch.logical_and(
                delta > var_tol,
                torch.logical_or(delta >= STALL_GATE, delta < prev),
            ),
        ),
    )
