"""The benchmark's random weights, drawn on the device from ``--seed``.

Each leaf of a configuration's ``leaf_specs`` (its reference module) is
drawn from a ``torch.Generator`` of its own on the card, seeded from the
run's seed and the leaf's position; a stacked leaf is drawn a layer slice
at a time from that generator, in float32, scaled and cast to the stored
type.  So any leaf can be drawn again, bit for bit, a slice at a time:
``leaf_slices`` is how the check and the reference get θ₀ back without
keeping a copy beside the program.
"""
from __future__ import annotations

import math

import torch

from mgdbench.counts.signs import leaf_ids

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
_MIX = 0x9E3779B97F4A7C15


def mix64(*values: int) -> int:
    """A 63-bit seed from whole numbers (splitmix64 over each)."""
    z = 0
    for v in values:
        z = (z ^ (int(v) & 0xFFFFFFFFFFFFFFFF)) + _MIX & 0xFFFFFFFFFFFFFFFF
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
    return z >> 1


def _draws(spec, seed: int, index: int, device):
    """The leaf's values as (float32 part, first flat index), a layer
    slice at a time for a stacked leaf."""
    path, shape, dtype, law = spec
    dt = DTYPES[dtype]
    stacked = path[0] == "layers"
    parts = shape[0] if stacked else 1
    part_shape = tuple(shape[1:]) if stacked else tuple(shape)
    n = math.prod(part_shape)
    gen = None
    if law[0] in ("normal", "uniform"):
        gen = torch.Generator(device=device)
        gen.manual_seed(mix64(seed, 0x5EED, index))
    for i in range(parts):
        if law[0] == "normal":
            x = torch.randn(part_shape, generator=gen, device=device) \
                * law[1]
        elif law[0] == "uniform":
            x = torch.rand(part_shape, generator=gen, device=device)
        elif law[0] == "ones":
            x = torch.ones(part_shape, device=device)
        elif law[0] == "zeros":
            x = torch.zeros(part_shape, device=device)
        else:
            raise ValueError(f"unknown init law {law!r} of {path}")
        yield x.to(dt), i * n


def make(specs, seed: int, device):
    """{path: tensor} of every leaf, drawn on ``device``."""
    ids = leaf_ids([s[0] for s in specs])
    out = {}
    for spec in specs:
        path, shape, dtype, _ = spec
        leaf = torch.empty(shape, dtype=DTYPES[dtype], device=device)
        flat = leaf.reshape(-1)
        for part, start in _draws(spec, seed, ids[path], device):
            flat[start:start + part.numel()] = part.reshape(-1)
        out[path] = leaf
    return out


def leaf_slices(specs, seed: int, device):
    """``f(path)`` → the leaf's θ₀ again as (part, first flat index)."""
    by_path = {s[0]: s for s in specs}
    ids = leaf_ids(by_path)

    def slices(path):
        return _draws(by_path[path], seed, ids[path], device)

    return slices


def nest(flat):
    """A flat {path: tensor} as the nested dict the program takes."""
    tree = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def flatten(tree, prefix=()):
    """A nested dict of tensors as {path: tensor}."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out
