"""Plain SGD (+ optional momentum): the backprop baseline's optimizer.

The paper compares MGD against backprop + SGD without momentum (§3.6).
Both steps compute in f32 and cast back to each leaf's dtype, as the
reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core.utils import f32, tree_map


def sgd_init(params, momentum: float = 0.0):
    if momentum:
        return {"m": tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params)}
    return {}


@torch.no_grad()
def sgd_step(params, grads, state, *, eta: float, momentum: float = 0.0):
    """``p − η·g`` (or ``p − η·m`` with ``m ← μ·m + g``) leaf by leaf."""
    eta = f32(eta)
    if momentum:
        mu = f32(momentum)
        m = tree_map(lambda mi, gi: mu * mi + gi.float(), state["m"], grads)
        new_params = tree_map(
            lambda p, mi: (p.float() - eta * mi).to(p.dtype), params, m)
        return new_params, {"m": m}
    new_params = tree_map(
        lambda p, g: (p.float() - eta * g.float()).to(p.dtype),
        params, grads)
    return new_params, state
