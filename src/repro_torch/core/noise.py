"""Activation defects (paper §3.5): per-neuron deformed sigmoids.

f_k(a) = α_k·σ(β_k·(a − a_k)) + b_k with α_k, β_k ~ N(1, σ_a) and
a_k, b_k ~ N(0, σ_a).  The defect pattern is part of the device, drawn
from a counter-based key (``core.rng``, the reference's threefry), so one
seed is one chip in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from . import rng
from .utils import f32


class ActivationDefects(NamedTuple):
    """Static per-neuron logistic-function defects (one entry per neuron)."""

    alpha: torch.Tensor  # output scaling,  N(1, σ_a)
    beta: torch.Tensor   # input slope,     N(1, σ_a)
    a0: torch.Tensor     # input offset,    N(0, σ_a)
    b0: torch.Tensor     # output offset,   N(0, σ_a)


def sample_defects(seed: int, n_neurons: int, sigma_a: float,
                   device=None) -> ActivationDefects:
    """Defects of ``n_neurons`` neurons from ``PRNGKey(seed)`` split four
    ways, as the reference draws them (normals within
    ``rng.NORMAL_ULPS``), on the CUDA card unless ``device="cpu"``."""
    device = resolve_device(device)
    ka, kb, kc, kd = rng.split(rng.prng_key(seed), 4)
    shape = (n_neurons,)
    sig = f32(sigma_a)
    one = f32(1.0)
    return ActivationDefects(
        alpha=one + sig * rng.normal(ka, shape, device),
        beta=one + sig * rng.normal(kb, shape, device),
        a0=sig * rng.normal(kc, shape, device),
        b0=sig * rng.normal(kd, shape, device),
    )


def ideal_defects(n_neurons: int, device=None) -> ActivationDefects:
    """σ_a = 0: α = β = 1, a₀ = b₀ = 0, on the CUDA card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    one = torch.ones((n_neurons,), device=device)
    zero = torch.zeros((n_neurons,), device=device)
    return ActivationDefects(one, one, zero, zero)


def defective_sigmoid(a: torch.Tensor, d: ActivationDefects) -> torch.Tensor:
    """α·σ(β·(a − a₀)) + b₀ with neurons on the last axis."""
    return d.alpha * torch.sigmoid(d.beta * (a - d.a0)) + d.b0
