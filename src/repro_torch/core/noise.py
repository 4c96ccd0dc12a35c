"""Activation defects (paper §3.5): per-neuron deformed sigmoids.

f_k(a) = α_k·σ(β_k·(a − a_k)) + b_k.  The defect tensors are part of the
device, handed in by the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ActivationDefects(NamedTuple):
    """Static per-neuron logistic-function defects (one entry per neuron)."""

    alpha: torch.Tensor  # output scaling,  N(1, σ_a)
    beta: torch.Tensor   # input slope,     N(1, σ_a)
    a0: torch.Tensor     # input offset,    N(0, σ_a)
    b0: torch.Tensor     # output offset,   N(0, σ_a)


def defective_sigmoid(a: torch.Tensor, d: ActivationDefects) -> torch.Tensor:
    """α·σ(β·(a − a₀)) + b₀ with neurons on the last axis."""
    return d.alpha * torch.sigmoid(d.beta * (a - d.a0)) + d.b0
