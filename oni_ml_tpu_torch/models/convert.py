"""Carry LDA model state between the JAX package and the port.

The JAX package hands its model around as numpy arrays (an `LDAResult`'s
`log_beta` [K, V] / `gamma` [D, K] / `alpha`, or `final.beta` /
`final.gamma` / `final.other` on disk); the port trains on float32
tensors on its device.  The JAX initial beta is drawn with threefry and
cannot be reproduced from a torch seed, so a test that starts both
trainers from the same beta draws it in JAX and carries it across here.
The chunk driver's state between dispatches (log beta, alpha, ll_prev
and the per-group gammas) crosses the same way (`chunk_state_from_reference`),
so a test can start both chunk runners from one state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ModelState:
    log_beta: torch.Tensor               # [K, V] float32
    alpha: torch.Tensor                  # scalar float32
    gamma: "torch.Tensor | None" = None  # [D, K] float32


def from_reference(log_beta, alpha, gamma=None,
                   device: "str | torch.device" = "cpu") -> ModelState:
    """numpy (or anything array-like) -> the port's float32 tensors."""
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return ModelState(t(log_beta), t(alpha), None if gamma is None else t(gamma))


def to_reference(state: ModelState):
    """The port's tensors -> (log_beta float64, alpha float, gamma
    float64 or None), the JAX LDAResult's host types."""
    def a(x):
        return x.detach().to("cpu", torch.float64).numpy()

    return (a(state.log_beta), float(state.alpha),
            None if state.gamma is None else a(state.gamma))


@dataclass
class ChunkState:
    """What one chunk dispatch hands the next (models/fused.py)."""

    log_beta: torch.Tensor   # [K, V] float32
    alpha: torch.Tensor      # scalar float32
    ll_prev: torch.Tensor    # scalar float32; nan before the first iteration
    gammas: tuple            # per group: [NB, B, K] float32


def chunk_state_from_reference(log_beta, alpha, ll_prev, gammas,
                               device: "str | torch.device" = "cpu"
                               ) -> ChunkState:
    """The JAX chunk runner's state (its arrays, or a ChunkResult's
    fields) -> the port's float32 tensors on `device`."""
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return ChunkState(t(log_beta), t(alpha), t(ll_prev),
                      tuple(t(g) for g in gammas))
