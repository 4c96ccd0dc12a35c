"""Plain PyTorch versions of the CUDA kernels.

They materialize θ̃ (the thing the kernels avoid) with the same counter
hash and row-major linear indexing, in the float order of
``repro.kernels.ref``.  The CPU path runs them; ``chip_smoke.py`` holds
each kernel against them on the card.  Like the kernels they take the
signs' row stride ``n_cols`` (default: the leaf's N): the sign of element
(r, c) is hashed at r·n_cols + c, which is a column block's index in a
wider leaf once its offset is folded into the seed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.perturbations import MASK, rademacher_signs
from repro_torch.core.utils import f32
from .perturbed_matmul import check_n_cols


SIGN_CHUNK = 1 << 24   # elements per pass of the int64 hash


def leaf_signs(lseed, shape, device=None, n_cols=None) -> torch.Tensor:
    """±1 float32 signs for a whole leaf of ``shape`` (row-major indexing
    with row stride ``n_cols``, None: the last dim; uint32 index wrap past
    2³² elements).

    ``lseed`` is a host int or a 0-dim integer tensor holding the uint32
    bit pattern (int32 two's complement is accepted).  The int64 hash runs
    over ``SIGN_CHUNK`` elements at a time, so its temporaries stay small
    beside an LM-sized leaf; chunking changes no value."""
    n = math.prod(shape)
    cols = shape[-1] if len(shape) else 1
    out = torch.empty((n,), dtype=torch.float32, device=device)
    for start in range(0, n, SIGN_CHUNK):
        stop = min(n, start + SIGN_CHUNK)
        out[start:stop] = _signs_range(lseed, start, stop, device, cols,
                                       n_cols)
    return out.reshape(shape)


def _signs_range(lseed, start: int, stop: int, device, cols=1,
                 n_cols=None) -> torch.Tensor:
    """Signs of a leaf's row-major elements ``start .. stop − 1``, the leaf
    viewed as rows of ``cols`` whose signs' row stride is ``n_cols``."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    n_cols = check_n_cols(n_cols, cols)
    if n_cols != cols:
        idx = torch.div(idx, cols, rounding_mode="floor") * n_cols \
            + idx % cols
    return rademacher_signs(lseed, idx)


def perturbed_matmul_ref(x, w, lseed, *, dtheta, sign=1.0, out_dtype=None,
                         n_cols=None):
    """y = x @ (W + sign·Δθ·signs), θ̃ materialized."""
    signs = leaf_signs(lseed, w.shape, device=w.device, n_cols=n_cols)
    wp = w.float() + f32(sign * dtheta) * signs
    y = x.float() @ wp
    return y.to(out_dtype or x.dtype)


def perturbed_matmul_pair_ref(xp, xm, w, lseed, *, dtheta, out_dtype=None,
                              n_cols=None):
    """(xp @ (W+θ̃), xm @ (W−θ̃)), two materialized matmuls sharing θ̃."""
    yp = perturbed_matmul_ref(xp, w, lseed, dtheta=dtheta, sign=1.0,
                              out_dtype=out_dtype, n_cols=n_cols)
    ym = perturbed_matmul_ref(xm, w, lseed, dtheta=dtheta, sign=-1.0,
                              out_dtype=out_dtype, n_cols=n_cols)
    return yp, ym


def _seed_list(lseeds):
    if isinstance(lseeds, torch.Tensor):
        return list((lseeds.to(torch.int64) & MASK).unbind(0))
    return [int(s) & MASK for s in lseeds]


def mgd_update_ref(w, lseeds, coefs, *, eta, dtheta, n_cols=None):
    """W − (η/Δθ)·Σ_j coefs[j]·signs_j, every window sign materialized."""
    acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for j, ls in enumerate(_seed_list(lseeds)):
        acc = acc + coefs[j] * leaf_signs(ls, w.shape, device=w.device,
                                          n_cols=n_cols)
    return (w.float() - f32(float(eta) / float(dtheta)) * acc).to(w.dtype)


def mgd_update_window_ref(w, lseeds, coefs, *, alpha, dtheta, n_cols=None):
    """Sequential-axpy window update in the kernel's association:
    W ← W + α·((Δθ·sign_j)·coefs[j]) for j = 0..J−1 in order.  Elementwise,
    so it runs in passes of ``SIGN_CHUNK`` elements: no f32 copy of a whole
    leaf exists (an expert bank of 1.34 G elements would need 5.4 GB for
    each temporary)."""
    seeds = _seed_list(lseeds)
    flat = w.reshape(-1)
    out = torch.empty_like(flat)
    for start in range(0, flat.numel(), SIGN_CHUNK):
        stop = min(flat.numel(), start + SIGN_CHUNK)
        w32 = flat[start:stop].float()
        for j, ls in enumerate(seeds):
            sgn = _signs_range(ls, start, stop, w.device, w.shape[-1],
                               n_cols)
            w32 = w32 + f32(alpha) * ((f32(dtheta) * sgn) * coefs[j])
        out[start:stop] = w32.to(w.dtype)
    return out.reshape(w.shape)
