"""Dense building blocks (plain functions on dicts of tensors).

Parameters keep the JAX package's layout: ``{"w": [d_in, d_out],
"b": [d_out]}``, so leaf ids and sign indices match it.

``pdense`` is the perturbable counterpart of ``dense`` on the fused probe
path: the weight matmul goes through the perturbed-matmul kernels, which
regenerate the Rademacher signs next to the multiply, so θ̃ of a weight
never exists in device memory; an antithetic central pair (signs
(+1, −1)) uses the pair kernel and reads W once per pair.  Biases are
O(d) and take a materialized θ̃.  Perturbable ops take and return a tuple
of activation streams, one per probe sign, plus the leaf-id subtree that
anchors every leaf to the global hash.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import perturbations as pert
from repro_torch.core.perturbations import MASK
from repro_torch.kernels import ops as kops


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias=False,
               dtype=torch.float32, scale=None, device=None):
    """W ~ N(0, 1)·scale (default 1/sqrt(d_in)) drawn from ``gen`` on the
    CPU, then placed on ``device``; zero bias."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale
    p = {"w": w.to(dtype).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _stream_offset(layer: int, nelem: int) -> int:
    """Element offset of layer ``layer``'s slice in a stacked leaf (uint32
    wraparound, as the generator's uint32 iota)."""
    return (int(layer) * (int(nelem) & MASK)) & MASK


def pleaf(leaf, leaf_id, probe, *, layer=None):
    """Per-stream perturbed values of a non-matmul leaf (or its layer
    slice), in the materializing optimizer's float order."""
    offset = 0 if layer is None else _stream_offset(layer, leaf.numel())
    theta = probe.leaf_theta(leaf.shape, leaf.dtype, leaf_id, offset=offset,
                             device=leaf.device)
    return tuple(pert.apply_signed(leaf, theta, s) for s in probe.ctx.signs)


def pdense(p, xs, ids, probe, *, layer=None):
    """Perturbable dense: xs (tuple of per-sign streams) @ (W ± θ̃) + (b ± θ̃_b).

    ``ids`` is the leaf-id subtree aligned with ``p``; ``layer`` the
    stacked-bank slice index (or None).
    """
    ctx = probe.ctx
    w = p["w"]
    lseed = probe.lseed(ids["w"])
    if layer is not None:
        lseed = pert.shifted_leaf_seed(
            lseed, _stream_offset(layer, w.shape[-2] * w.shape[-1]))
    if ctx.is_pair:
        ys = kops.perturbed_matmul_pair(
            xs[0], xs[1], w, lseed, dtheta=ctx.dtheta, impl=ctx.impl)
    else:
        ys = tuple(
            kops.perturbed_matmul(
                x, w, lseed, dtheta=ctx.dtheta, sign=s, impl=ctx.impl)
            for x, s in zip(xs, ctx.signs))
    if "b" in p:
        bs = pleaf(p["b"], ids["b"], probe, layer=layer)
        ys = tuple(y + b for y, b in zip(ys, bs))
    return tuple(ys)
