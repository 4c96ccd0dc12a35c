"""Forward-gradient oracle: the Δθ→0, T→∞ limit of MGD.

For one Rademacher probe s the MGD estimate C̃·s/Δθ tends to the forward
gradient (∇C·s)·s (Baydin et al., paper ref [26]); ``torch.func.jvp``
computes ∇C·s without finite-difference bias.

* ``forward_gradient``: (∇C·s)·s from one jvp;
* ``true_gradient``: the backprop gradient (``torch.autograd``);
* ``gradient_angle``: the paper's Fig. 5 angle between two gradients.
"""
from __future__ import annotations

from typing import Any

import torch

from . import perturbations as pert
from .utils import (f32, tree_dot, tree_flatten, tree_map, tree_norm,
                    tree_scale, tree_unflatten)

Pytree = Any


def forward_gradient(loss_fn, params, batch, *, step, seed, total=None):
    """Single-probe forward gradient (∇C·s)·s with a Rademacher tangent."""
    signs = pert.generate_signs_only(params, step=step, seed=seed)
    tangent = tree_map(lambda s, p: s.to(p.dtype), signs, params)
    leaves, treedef = tree_flatten(params)
    _, jvp_val = torch.func.jvp(
        lambda *xs: loss_fn(tree_unflatten(treedef, list(xs)), batch),
        tuple(leaves), tuple(tree_flatten(tangent)[0]))
    return tree_scale(signs, jvp_val)


def true_gradient(loss_fn, params, batch):
    """∇C by backprop, one tensor per leaf."""
    leaves, treedef = tree_flatten(params)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    loss = loss_fn(tree_unflatten(treedef, xs), batch)
    return tree_unflatten(treedef, list(torch.autograd.grad(loss, xs)))


def gradient_angle(g_approx: Pytree, g_true: Pytree) -> torch.Tensor:
    """Angle (radians) between two gradient pytrees."""
    num = tree_dot(g_approx, g_true)
    den = tree_norm(g_approx) * tree_norm(g_true) + f32(1e-30)
    return torch.arccos(torch.clamp(num / den, -1.0, 1.0))
