"""digamma and log-Gamma for strictly positive float32 arguments, with
the JAX kernels' own recurrence and series (oni_ml_tpu/ops/
pallas_estep.py digamma_pos / gammaln_pos) rather than torch.special,
so that the CUDA kernel (csrc/sparse_estep.cu) and its plain PyTorch
version do the same arithmetic.

The recurrence psi(x) = psi(x+1) - 1/x (resp. the product
Gamma(x+n)/Gamma(x)) pushes x above 6 in at most 7 branchless steps,
then the asymptotic series finishes; its truncation error at x >= 6 is
below float32 resolution.  The TPU kernels' approximate reciprocal plus
Newton step is an exact divide here.
"""

from __future__ import annotations

import torch


def digamma_pos(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x)
    for _ in range(7):
        small = x < 6.0
        acc = acc - torch.where(small, 1.0 / x, torch.zeros_like(x))
        x = x + small.to(x.dtype)
    inv = 1.0 / x
    inv2 = inv * inv
    series = (
        torch.log(x)
        - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    )
    return series + acc


def gammaln_pos(x: torch.Tensor) -> torch.Tensor:
    prod = torch.ones_like(x)
    for _ in range(7):
        small = x < 6.0
        prod = prod * torch.where(small, x, torch.ones_like(x))
        x = x + small.to(x.dtype)
    inv = 1.0 / x
    inv2 = inv * inv
    # 0.9189385332046727 = 0.5*log(2*pi)
    series = (
        (x - 0.5) * torch.log(x)
        - x
        + 0.9189385332046727
        + inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 / 1260.0))
    )
    return series - torch.log(prod)
