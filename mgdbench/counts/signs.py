"""The Rademacher sign hash of MGD's perturbations, and the leaf-id rule.

A frozen copy of the hash the port regenerates in its kernels and plain
versions (``repro_torch.core.perturbations``): murmur3's 32-bit finalizer
over ``idx·0x9E3779B9 + leaf_seed``, the sign the top bit.  The leaf seed
hashes (run seed, perturbation step, leaf id); the leaf id is the leaf's
position in the parameter tree flattened with dict keys sorted at every
level (JAX's order), which for nested dicts of string keys is the order
of the sorted key paths.  The element index is row-major over the whole
leaf, a stacked layer's slice starting at ``layer · slice size``, wrapped
to uint32.  Tensors compute in int64 masked to 32 bits, with the 32-bit
product split in 16-bit halves so no int64 product overflows.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35


def _mul32(a, b: int):
    """``(a · b) mod 2³²`` for 0 ≤ a, b < 2³² (host int or int64 tensor)."""
    if not isinstance(a, torch.Tensor):
        return (a * b) & MASK
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & MASK


def fmix32(x):
    """murmur3's 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def leaf_seed(seed: int, step: int, leaf_id: int) -> int:
    """The 32-bit seed of one leaf's signs at one perturbation step."""
    s = (_mul32(int(seed) & MASK, GOLDEN) + (int(leaf_id) & MASK)) & MASK
    s = fmix32(s)
    s = (s + _mul32(int(step) & MASK, M1)) & MASK
    return fmix32(s)


def signs(lseed: int, start: int, stop: int, device=None) -> torch.Tensor:
    """±1 float32 signs of a leaf's row-major elements start .. stop − 1."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device) & MASK
    h = fmix32((_mul32(idx, GOLDEN) + (int(lseed) & MASK)) & MASK)
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)


def leaf_ids(paths):
    """{path: leaf id} for key paths (tuples of strings) of a nested dict."""
    return {p: i for i, p in enumerate(sorted(paths))}
