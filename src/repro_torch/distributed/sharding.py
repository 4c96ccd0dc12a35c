"""Logical-axis sharding: one vocabulary, any mesh.

The twin of the reference's ``distributed/sharding.py``.  Models annotate
activations with *logical* axis names ("batch", "seq", "model",
"expert", "fsdp"); this module translates them to whatever mesh is
active — (16, 16) ("data", "model") single-pod, (2, 16, 16) ("pod",
"data", "model") multi-pod, or no mesh at all (one card, the CPU tests:
a no-op).  Translation drops axes the mesh does not have and axes that
do not divide the dimension, so the same model code runs everywhere.

Logical vocabulary:
    batch  → ("pod", "data")   data parallelism (outer "pod" included)
    seq    → ("data",)         sequence parallelism (long-context KV/state)
    model  → ("model",)        tensor parallelism
    expert → ("model",)        expert parallelism (MoE banks)
    fsdp   → ("data",)         parameter sharding on the DP axis (ZeRO-3
                               style; MGD has no optimizer state to shard —
                               this shards the weights themselves)
    pod    → ("pod",)          explicit pod axis (probe parallelism)

A spec is a ``P``: a tuple with one entry per tensor dim — ``None``
(replicated), one mesh axis name, or a tuple of names.  The translation
(``logical_spec``, ``param_specs``) is arithmetic on axis names and sizes
and takes anything with ``axis_names`` and a ``shape`` mapping (a
``DeviceMesh`` through ``mesh_axes``, ``core.probe_parallel.LocalMesh``,
a test's stand-in).  Placing a tensor needs a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``: an
entry sharded over several mesh axes, such as ("pod", "data"), becomes
``Shard(d)`` on each of those mesh dims, outer mesh dim first — the
reference's pod-major device order.
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional

import torch

from repro_torch.core.utils import is_dtensor, path_str, tree_paths

LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "seq": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "fsdp": ("data",),
    "pod": ("pod",),
    # sequence parallelism: residual-stream seq dim sharded over the TP
    # axis between blocks (Megatron-SP)
    "sp": ("model",),
    # decode KV/latent caches: sequence dim sharded over every axis the
    # batch dim didn't consume (the spec builder dedups used axes) — B=128
    # decode gets seq→model, B=1 long-context gets seq→data×model.
    "kvseq": ("data", "model"),
}

# pure data parallelism: for models too small to feed a 16-wide TP axis,
# spend the "model" axis on batch too.  MGD makes this unusually cheap:
# no gradient all-reduce, no optimizer state — the only sync is the
# scalar cost reduction.
PURE_DP_RULES = {
    **LOGICAL_RULES,
    "batch": ("pod", "data", "model"),
    "model": (),
    "expert": (),
    "fsdp": (),
    "sp": (),
}

# FSDP-only: every device computes the full model on its batch shard;
# weights are sharded across ALL axes and all-gathered per layer.
DP_FSDP_RULES = {
    **LOGICAL_RULES,
    "batch": ("pod", "data", "model"),
    "model": (),
    "expert": (),
    "sp": (),
    "fsdp": ("pod", "data", "model"),
}

# MoE-EP: experts keep expert parallelism over "model"; the dense parts
# drop tensor parallelism and run FSDP-style over "data" instead.
MOE_EP_RULES = {
    **LOGICAL_RULES,
    "model": (),
    "sp": (),
    "expert": ("model",),
    "fsdp": ("data", "model"),
}

RULE_SETS = {"default": LOGICAL_RULES, "pure_dp": PURE_DP_RULES,
             "dp_fsdp": DP_FSDP_RULES, "moe_ep": MOE_EP_RULES}


class P:
    """A partition spec: one entry per tensor dim (``None``, an axis
    name, or a tuple of axis names).  It iterates and compares as the
    tuple of its entries, and is a leaf of a pytree (not a node)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


_ACTIVE_MESH = None
_ACTIVE_RULES: dict = LOGICAL_RULES


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh (+ optional logical-rule table) for the code run
    inside: ``shard`` places activations on it and the spec builders
    default to it."""
    global _ACTIVE_MESH, _ACTIVE_RULES
    prev, prev_rules = _ACTIVE_MESH, _ACTIVE_RULES
    _ACTIVE_MESH = mesh
    _ACTIVE_RULES = rules or LOGICAL_RULES
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev
        _ACTIVE_RULES = prev_rules


def active_mesh():
    return _ACTIVE_MESH


def fsdp_axes(mesh=None):
    """The mesh axes the active rules give to "fsdp" (the weights' FSDP
    split) that ``mesh`` (default: the active one) has."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    if mesh is None:
        return ()
    names, _ = mesh_axes(mesh)
    return tuple(a for a in _ACTIVE_RULES.get("fsdp", ()) if a in names)


def is_device_mesh(mesh) -> bool:
    """True for a ``torch.distributed`` DeviceMesh (the kind that places
    tensors), False for an arithmetic stand-in."""
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def mesh_axes(mesh):
    """(axis names, {axis: size}) of a DeviceMesh or a stand-in."""
    if is_device_mesh(mesh):
        names = tuple(mesh.mesh_dim_names or ())
        return names, dict(zip(names, tuple(mesh.shape)))
    return tuple(mesh.axis_names), dict(mesh.shape)


def _translate(name, dim_size, mesh, rules=None) -> Optional[tuple]:
    """Logical name → tuple of mesh axes (or None = replicated)."""
    if name is None:
        return None
    rules = rules or _ACTIVE_RULES
    names, shape = mesh_axes(mesh)
    axes = tuple(a for a in rules.get(name, ()) if a in names)
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= shape[a]
    if dim_size is not None and dim_size % total != 0:
        # drop trailing axes until one divides (e.g. kv-heads smaller than
        # the model axis → replicate)
        while axes:
            axes = axes[:-1]
            total = 1
            for a in axes:
                total *= shape[a]
            if axes and dim_size % total == 0:
                return axes
        return None
    return axes


def logical_spec(shape, names, mesh=None, *, align="left") -> P:
    """Build a ``P`` for ``shape`` from logical ``names``.

    ``align="right"`` pads names on the left (stacked-layer leading dims).
    A mesh axis is used at most once per spec — later dims that would reuse
    an axis are replicated (e.g. a [B, S, ...] cache asking for "batch" and
    "seq" on a mesh where both map to "data" shards only the batch dim).
    """
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        return P()
    _, sizes = mesh_axes(mesh)
    names = list(names)
    if len(names) < len(shape):
        pad = [None] * (len(shape) - len(names))
        names = (pad + names) if align == "right" else (names + pad)
    entries = []
    used = set()
    for dim, name in zip(shape, names):
        axes = _translate(name, dim, mesh)
        if axes is not None:
            axes = tuple(a for a in axes if a not in used)
            total = 1
            for a in axes:
                total *= sizes[a]
            if not axes or dim % total != 0:
                axes = None
        if axes is None:
            entries.append(None)
        elif len(axes) == 1:
            used.add(axes[0])
            entries.append(axes[0])
        else:
            used.update(axes)
            entries.append(axes)
    return P(*entries)


def placements(spec, mesh):
    """DTensor placements of ``spec`` on the DeviceMesh ``mesh``: one per
    mesh dim, ``Shard(d)`` where tensor dim d's entry names that mesh
    axis, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A spec on a DeviceMesh: the reference's ``NamedSharding``, a leaf
    of a pytree.  ``placements`` are its DTensor placements."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    @property
    def placements(self):
        return placements(self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def place(x, spec, mesh):
    """``x`` (a full tensor, or a DTensor) on ``mesh`` under ``spec``:
    a full tensor present on every rank is sliced locally, no
    communication; a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, Replicate

    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep if all(isinstance(p, Replicate) for p in pl) \
        else rep.redistribute(mesh, pl)


def shard(x, *names):
    """Activation placement in logical names on the active DeviceMesh;
    ``x`` untouched without one, so every one-card path stays bitwise as
    it is.  Mesh axes of one rank are left out of the placement: a split
    into one block changes no data, and DTensor would refuse to merge
    such a dim in a later view."""
    mesh = _ACTIVE_MESH
    if mesh is None or not is_device_mesh(mesh):
        return x
    _, sizes = mesh_axes(mesh)
    spec = []
    for entry in logical_spec(x.shape, names, mesh):
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else tuple(entry))
        axes = tuple(a for a in axes if sizes[a] > 1)
        spec.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return place(x, P(*spec), mesh)


def mesh_ops():
    """Context for model code under the active DeviceMesh: a plain tensor
    made inside the model (positions, masks, constants) meets DTensors as
    a replicated one — every rank holds all of it.  A null context
    without a mesh."""
    if _ACTIVE_MESH is None or not is_device_mesh(_ACTIVE_MESH):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def settle(x):
    """A DTensor with its pending reductions (``Partial`` placements)
    done, every other placement kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def replicate(x, mesh=None):
    """A tensor made inside the model, as a replicated DTensor on ``mesh``
    (default: the active DeviceMesh; untouched without one), so it
    combines with sharded activations."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    if mesh is None or not is_device_mesh(mesh) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


_LOCAL_SCALE = [0]


@contextlib.contextmanager
def _local_work(n_blocks: int):
    """Marks plain-tensor work on local shards that stands for
    ``n_blocks`` distinct blocks of a global op (``launch.op_cost``
    counts it that many times)."""
    prev = _LOCAL_SCALE[0]
    _LOCAL_SCALE[0] = n_blocks
    try:
        yield
    finally:
        _LOCAL_SCALE[0] = prev


def block_work(mesh, placements):
    """Context for plain-tensor work on this rank's block of a global op
    laid out by ``placements`` on ``mesh`` (``launch.op_cost`` counts it
    once a block)."""
    return _local_work(_n_blocks(mesh, placements))


def local_work_scale() -> int:
    """0 outside ``per_shard``/``decode_per_shard``, else the number of
    distinct blocks the local work is one of."""
    return _LOCAL_SCALE[0]


def _n_blocks(mesh, placements) -> int:
    n = 1
    for size, pl in zip(tuple(mesh.shape), placements):
        if getattr(pl, "dim", None) is not None and pl.is_shard():
            n *= size
    return n


def per_shard(fn, *xs):
    """``fn(*xs)`` for an op that is independent along every sharded dim
    (attention over (batch, head) shards): on DTensors of one placement
    it runs on the local shards, no communication, and the result takes
    the first argument's placements; plain tensors go straight in."""
    if not any(is_dtensor(x) for x in xs):
        return fn(*xs)
    for x in xs[1:]:
        if tuple(x.placements) != tuple(xs[0].placements):
            raise ValueError(f"per_shard: placements {x.placements} and "
                             f"{xs[0].placements} differ")
    return local_apply(fn, *xs)


def _like(out, ref, fn=None):
    """The local result ``out`` as a DTensor with ``ref``'s placements:
    dims that ``ref`` splits keep its global size, others take the local
    result's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.perturbations import local_layout
    shape = list(ref.shape)
    local_shape, _ = local_layout(tuple(ref.shape), ref.device_mesh,
                                  tuple(ref.placements))
    for d, (n_out, n_in) in enumerate(zip(out.shape, local_shape)):
        if n_out != n_in:
            if any(getattr(p, "dim", None) == d for p in ref.placements):
                raise ValueError(f"{fn} changed sharded dim {d}")
            shape[d] = n_out
    shape = tuple(shape[:out.dim()]) + tuple(out.shape[len(shape):])
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(out.contiguous(), ref.device_mesh,
                              ref.placements, run_check=False, shape=shape,
                              stride=stride)


def local_apply(fn, *args, like=(0,)):
    """``fn(*args)`` on the local shards of the DTensor arguments (others
    go in as they are), for an op that is independent along every split
    dim, the caller having placed the arguments so that each rank's
    blocks belong together (the recurrences' (batch, head) shards).
    Output i comes back with the placements of argument ``like[i]``
    (``_like``).  No communication; plain arguments run ``fn`` as it is."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    ref = next(a for a in args if is_dtensor(a))
    with _local_work(_n_blocks(ref.device_mesh, ref.placements)):
        out = fn(*(a.to_local() if is_dtensor(a) else a for a in args))
    if isinstance(out, tuple):
        return tuple(_like(o, args[i], fn) for o, i in zip(out, like))
    return _like(out, args[like[0]], fn)


def copy_into(dst, src):
    """``dst.copy_(src)`` in place, for a DTensor ``dst`` (a view of a
    cache, say) whatever ``src``'s placements: ``src`` is settled and
    laid out as ``dst``, then copied shard to shard."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return dst
    src = settle(replicate(src, dst.device_mesh)).redistribute(
        dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())
    return dst


def seq_per_shard(attend, queries, caches, length, shape):
    """Single-token attention ``attend(*queries, *caches, length,
    seq_offset=, combine=)`` against DTensor caches [B, S, ...] (all of
    the first one's placements) on their local shards: the queries take
    the caches' placements but the sequence's (their dim i where the
    cache splits its dim i), each rank attends to its block of the
    sequence, and where the caches shard the sequence the softmax is
    combined over those mesh dims (a max and two sums).  Returns the
    result, of global ``shape``, with the queries' placements."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core.perturbations import local_layout
    first = caches[0]
    mesh = first.device_mesh
    seq_all = [i for i, pl in enumerate(first.placements)
               if isinstance(pl, Shard) and pl.dim == 1]
    want = tuple(Replicate() if i in seq_all else pl
                 for i, pl in enumerate(first.placements))
    # a mesh dim of one rank splits nothing: no combine over it, so a
    # one-rank mesh attends as one card does
    seq_dims = [i for i in seq_all if mesh.size(i) > 1]
    queries = tuple(settle(replicate(q, mesh)).redistribute(mesh, want)
                    for q in queries)
    caches = (first,) + tuple(
        c if tuple(c.placements) == tuple(first.placements)
        else c.redistribute(mesh, first.placements) for c in caches[1:])
    _, offset = local_layout(tuple(first.shape), mesh,
                             tuple(first.placements))

    def combine(x, op):
        for i in seq_dims:
            x = funcol.all_reduce(x, op, (mesh, i))
            x = funcol.wait_tensor(x) if hasattr(x, "wait") else x
        return x

    with _local_work(_n_blocks(mesh, first.placements)):
        out = attend(*(q.to_local() for q in queries),
                     *(c.to_local() for c in caches), length,
                     seq_offset=offset[1],
                     combine=combine if seq_dims else None)
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(out, mesh, want, run_check=False, shape=shape,
                              stride=stride)


def vocab_parallel_nll(logits, labels):
    """Per-token softmax cross-entropy ``logsumexp(logits) −
    logits[label]`` of DTensor logits [..., V] whose vocabulary may be
    sharded, without gathering the vocabulary (Megatron's vocab-parallel
    cross-entropy): each rank reduces its block — max, sum of exp and the
    gold logit where the label falls in it — and the blocks combine over
    the vocabulary's mesh dims.  Labels < 0 read class 0 (the caller
    masks them).  Returns [...] f32 with the logits' other placements."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core.perturbations import local_layout
    logits = settle(logits)
    mesh = logits.device_mesh
    last = logits.dim() - 1
    vdims = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    want = tuple(Replicate() if i in vdims else p
                 for i, p in enumerate(logits.placements))
    if not is_dtensor(labels):
        labels = replicate(labels)
    labels = labels.redistribute(mesh, want)
    local = logits.to_local().float()
    _, offset = local_layout(tuple(logits.shape), mesh,
                             tuple(logits.placements))
    n_local = local.shape[-1]

    def combine(x, op):
        for i in vdims:
            x = funcol.all_reduce(x, op, (mesh, i))
            x = funcol.wait_tensor(x) if hasattr(x, "wait") else x
        return x

    lab = labels.to_local().long().clamp(min=0) - offset[last]
    inside = (lab >= 0) & (lab < n_local)
    m = combine(local.amax(dim=-1), "max")
    se = combine(torch.exp(local - m[..., None]).sum(dim=-1), "sum")
    gold = torch.gather(local, -1, lab.clamp(0, n_local - 1)[..., None])
    gold = combine(torch.where(inside, gold[..., 0], 0.0), "sum")
    nll = m + torch.log(se) - gold
    shape = tuple(logits.shape[:-1])
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(nll, mesh, want, run_check=False, shape=shape,
                              stride=stride)


def write_at(cache, dim: int, pos: int, value):
    """``cache[(:,)*dim, pos] = value`` in place, for a DTensor ``cache``
    (any Shard/Replicate placements): the rank whose shard holds ``pos``
    writes its block of ``value``, redistributed to match; the others
    write nothing.  A plain cache takes the plain write."""
    if not is_dtensor(cache):
        cache.select(dim, pos).copy_(value.to(cache.dtype))
        return cache
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core.perturbations import shard_layout
    want = []
    for pl in cache.placements:
        if isinstance(pl, Shard) and pl.dim == dim:
            want.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > dim:
            want.append(Shard(pl.dim - 1))
        else:
            want.append(pl)
    if not is_dtensor(value):
        value = replicate(value)
    value = value.redistribute(cache.device_mesh, want).to_local()
    local_shape, offset = shard_layout(cache)
    if offset[dim] <= pos < offset[dim] + local_shape[dim]:
        cache.to_local().select(dim, pos - offset[dim]).copy_(
            value.to(cache.dtype))
    return cache


def local(x):
    """The local shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """The whole tensor of a DTensor (gathered); a plain tensor as it
    is."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# Parameter shardings from path-pattern rules
# ---------------------------------------------------------------------------


def param_specs(params_shape, rules, mesh=None):
    """Map a params tree (anything with ``.shape`` leaves) to a tree of
    ``P``.

    ``rules`` is an ordered list of (regex, logical-names) — first match on
    the '/'-joined tree path wins; unmatched leaves are replicated.  Names
    are RIGHT-aligned to the leaf shape, so one rule covers both a stacked
    [L, d, f] bank and an unstacked [d, f] matrix.
    """
    from repro_torch.core.utils import tree_flatten, tree_unflatten

    mesh = mesh or _ACTIVE_MESH

    def one(path, leaf):
        pstr = path_str(path)
        for pat, names in rules:
            if re.search(pat, pstr):
                return logical_spec(tuple(leaf.shape), names, mesh,
                                    align="right")
        return P()

    _, treedef = tree_flatten(params_shape)
    return tree_unflatten(treedef, [one(p, leaf) for p, leaf
                                    in tree_paths(params_shape)])


def named_shardings(params_shape, rules, mesh):
    """A ``NamedSharding`` for every leaf under ``rules`` on the
    DeviceMesh ``mesh``."""
    from repro_torch.core.utils import tree_map

    return tree_map(lambda s: NamedSharding(mesh, s),
                    param_specs(params_shape, rules, mesh))


def from_block(block, sharding, shape):
    """A DTensor of global ``shape`` under ``sharding`` (a
    ``NamedSharding``) whose local shard is this rank's ``block``."""
    from torch.distributed.tensor import DTensor
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(block, sharding.mesh, sharding.placements,
                              run_check=False, shape=tuple(shape),
                              stride=stride)


def local_block(x, sharding):
    """The full tensor ``x``, present on every rank, placed under
    ``sharding`` as ``place`` places it, but as a copy of this rank's
    block alone, so nothing keeps ``x`` alive."""
    from repro_torch.core.perturbations import local_layout
    local_shape, offset = local_layout(tuple(x.shape), sharding.mesh,
                                       sharding.placements)
    block = x[tuple(slice(o, o + n) for o, n in zip(offset, local_shape))]
    return from_block(block.clone(memory_format=torch.contiguous_format),
                      sharding, x.shape)


def device_put(tree, shardings):
    """Every leaf of ``tree`` placed under its ``NamedSharding`` (the
    reference's ``jax.device_put(tree, shardings)``)."""
    from repro_torch.core.utils import tree_map

    return tree_map(lambda x, s: place(x, s.spec, s.mesh), tree, shardings)
