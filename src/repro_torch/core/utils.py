"""Pytree utilities over nested lists, tuples and dicts of tensors.

The flatten order is JAX's: lists and tuples in order, dict keys
**sorted**, ``None`` an empty subtree.  Leaf ids (the integers the
perturbation hash consumes) are positions in this order, so keeping it
identical to ``jax.tree_util`` keeps every sign identical to the JAX
package's.  For the 49-4-4 MLP ``[{"w", "b"}, {"w", "b"}]`` the ids are
``[{"b": 0, "w": 1}, {"b": 2, "w": 3}]``: the bias precedes the weight.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tracing


def f32(x) -> torch.Tensor:
    """A 0-dim float32 CPU tensor holding ``x`` rounded to f32.

    Scalar constants enter tensor arithmetic through this, so every
    product and sum rounds exactly where the reference's f32 program
    does; a 0-dim CPU tensor combines with CUDA tensors without a copy.
    """
    return torch.tensor(x, dtype=torch.float32)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, leaves):
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), None, [_walk(c, leaves) for c in node])
    leaves.append(node)
    return ("leaf",)


def _build(d, it):
    kind = d[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    children = [_build(c, it) for c in d[2]]
    if kind == "dict":
        return dict(zip(d[1], children))
    if issubclass(kind, tuple) and hasattr(kind, "_fields"):
        return kind(*children)
    return kind(children)


# Module-level recursion, not nested closures: a closure that calls itself
# is a reference cycle, and one holding the leaves list would keep every
# flattened tensor alive until the cyclic garbage collector runs.


def tree_flatten(tree):
    """``(leaves, treedef)`` in JAX order; ``tree_unflatten`` inverts it."""
    leaves = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def tensors_of(tree):
    """The tensor leaves of ``tree`` (an op's args or outputs)."""
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (a tensor placed on
    a device mesh), without importing torch.distributed."""
    return type(x) is not torch.Tensor and hasattr(x, "placements")


def tree_paths(tree, prefix=()):
    """``[(path tuple, leaf)]`` in flatten order (dict keys sorted,
    sequences by index: ``jax.tree_util.tree_flatten_with_path``'s)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, c in enumerate(tree)
                for pl in tree_paths(c, prefix + (i,))]
    return [(prefix, tree)]


def path_str(path) -> str:
    """A path as the reference's '/'-joined keys."""
    return "/".join(str(k) for k in path)


def tree_size(tree) -> int:
    """Total number of scalar parameters in a pytree."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def leaf_meta(tree):
    """Per-leaf ``(leaf_id, global_offset, size)`` in flatten order."""
    metas = []
    offset = 0
    for i, leaf in enumerate(tree_leaves(tree)):
        n = math.prod(leaf.shape)
        metas.append((i, offset, n))
        offset += n
    return metas


def leaf_id_tree(tree):
    """Same-structure tree whose leaves are their int leaf ids."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, list(range(len(leaves))))


def _scalar(a):
    return a if isinstance(a, torch.Tensor) else f32(a)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    s = _scalar(s)
    return tree_map(lambda x: (x.float() * s).to(x.dtype), tree)


def tree_axpy(a, x, y):
    """``y + a * x``, computed in f32 then cast back to ``y.dtype``."""
    a = _scalar(a)
    return tree_map(lambda xi, yi: (yi.float() + a * xi.float()).to(yi.dtype),
                    x, y)


def tree_dot(a, b) -> torch.Tensor:
    """Sum of elementwise products over the whole pytree, in f32, leaf
    sums added in flatten order."""
    total = f32(0.0)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        total = total.to(x.device) + torch.sum(x.float() * y.float())
    return total


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_cast(tree, dtype):
    """Every leaf cast to ``dtype``."""
    return tree_map(lambda x: x.to(dtype), tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)


def tree_select(pred: bool, a, b):
    """``a`` if the host predicate holds, else ``b``."""
    return a if pred else b


def epoch_loop(step_fn, steps_per_call: int, sample_fn, sample_index):
    """``run(params, state) -> (params, state, stacked)`` making
    ``steps_per_call`` calls of ``step_fn(params, state, batch) ->
    (params, state, metrics)``, each on ``sample_fn(sample_index(state))``;
    ``stacked`` holds every call's metrics stacked along a new first axis."""
    def run(params, state):
        metrics = []
        for _ in range(steps_per_call):
            with tracing.span("mgd.data"):
                batch = sample_fn(sample_index(state))
            params, state, m = step_fn(params, state, batch)
            metrics.append(m)
        stacked = ({k: torch.stack([m[k] for m in metrics])
                    for k in metrics[0]} if metrics else {})
        return params, state, stacked

    return run
