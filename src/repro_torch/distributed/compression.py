"""Gradient compression for the backprop baseline's all-reduce.

The twin of the reference's ``distributed/compression.py``: int8
stochastic quantization with error feedback (a residual carried between
steps) — the standard distributed-optimization trick for shrinking the
O(P) gradient all-reduce that backprop needs at pod scale.

MGD needs none of this: its entire feedback channel is ONE scalar per
step (the cost), which is the point the roofline report makes when it
compares collective bytes.  This module exists so the baseline is a
fair, production-grade strawman.  As in the reference, it issues no
collective itself: the int8 payload is what an all-reduce would move.

The noise is the reference's draw, ``core.rng.uniform`` on
``fold_in(prng_key(17 + i), seed_step)`` for leaf i, so codes, scale and
residual are bitwise the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng
from repro_torch.core.utils import f32, tree_flatten, tree_map, \
    tree_unflatten


def compress_init(params):
    """A zero f32 residual per leaf."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def quantize_int8(g, residual, key):
    """g + residual → (int8 codes, scale, new residual).  Stochastic
    rounding keeps the quantizer unbiased."""
    gf = g.float() + residual
    scale = torch.maximum(torch.max(torch.abs(gf)),
                          f32(1e-12).to(gf.device)) / f32(127.0)
    scaled = gf / scale
    noise = rng.uniform(key, tuple(gf.shape), -0.5, 0.5, device=gf.device)
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    new_residual = gf - q.float() * scale
    return q, scale, new_residual


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_gradients(grads, residuals, seed_step: int):
    """Tree-wise int8 + error-feedback round trip: (the dequantized
    gradients in each leaf's dtype, the new residuals)."""
    leaves, treedef = tree_flatten(grads)
    res_leaves = tree_flatten(residuals)[0]
    out_g, out_r = [], []
    for i, (g, r) in enumerate(zip(leaves, res_leaves)):
        key = rng.fold_in(rng.prng_key(17 + i), seed_step)
        q, scale, nr = quantize_int8(g, r, key)
        out_g.append(dequantize_int8(q, scale).to(g.dtype))
        out_r.append(nr)
    return (tree_unflatten(treedef, out_g), tree_unflatten(treedef, out_r))
