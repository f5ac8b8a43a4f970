"""Carry LDA model state between the JAX package and the port.

The JAX package hands its model around as numpy arrays (an `LDAResult`'s
`log_beta` [K, V] / `gamma` [D, K] / `alpha`, or `final.beta` /
`final.gamma` / `final.other` on disk); the port trains on float32
tensors on its device.  The JAX initial beta is drawn with threefry and
cannot be reproduced from a torch seed, so a test that starts both
trainers from the same beta draws it in JAX and carries it across here.
The chunk driver's state between dispatches (log beta, alpha, ll_prev
and the per-group gammas) crosses the same way (`chunk_state_from_reference`),
so a test can start both chunk runners from one state.  So does the
online trainer's lambda (`lam_from_reference`): the JAX trainer draws
its initial lambda as `jax.random.gamma(PRNGKey(seed), 100, (K, V)) /
100`, the port from a torch.Generator, so a parity test passes the JAX
draw as the port's `initial_lam`.  A serving model crosses too: the JAX
package's `ScoringModel` and the fleet's `StackedSnapshot` are numpy
arrays and index maps (`scoring_model_from_reference`,
`stacked_snapshot_from_reference`), so a test gives both packages the
same tenants.
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


def lam_from_reference(lam, device: "str | torch.device" = "cpu"
                       ) -> torch.Tensor:
    """A JAX online trainer's lambda [K, V] (numpy or array-like) -> the
    port's float32 tensor on `device` (OnlineLDATrainer's
    `initial_lam`)."""
    return torch.as_tensor(np.array(lam, dtype=np.float32), device=device)


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


def scoring_model_from_reference(model):
    """A JAX package ScoringModel (index maps, float64 theta [D+1, K]
    and p [V+1, K]) -> the port's, copied; a bfloat16 storage marker
    crosses with it."""
    from ..scoring import ScoringModel

    out = ScoringModel(ip_index=dict(model.ip_index),
                       theta=np.array(model.theta, np.float64),
                       word_index=dict(model.word_index),
                       p=np.array(model.p, np.float64))
    if getattr(model, "_device_dtype", None) == "bfloat16":
        out._device_dtype = "bfloat16"
    return out


def stacked_snapshot_from_reference(stack):
    """A JAX package StackedSnapshot -> the port's: the stacked model,
    each member's snapshot (model, version, source, publish stamp), the
    base offsets, the build counter, the capacity tier and the
    precision."""
    from ..serving.fleet import StackedSnapshot
    from ..serving.registry import ModelSnapshot

    members = {
        t: ModelSnapshot(model=scoring_model_from_reference(s.model),
                         version=s.version, source=s.source,
                         published_at=s.published_at)
        for t, s in stack.members.items()}
    return StackedSnapshot(
        k=int(stack.k), tenants=tuple(stack.tenants),
        model=scoring_model_from_reference(stack.model), members=members,
        ip_base=dict(stack.ip_base), word_base=dict(stack.word_base),
        stack_version=int(stack.stack_version),
        capacity=int(stack.capacity), precision=stack.precision)
