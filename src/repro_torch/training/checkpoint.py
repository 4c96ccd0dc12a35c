"""Atomic, deterministic checkpoints in the reference's on-disk layout.

The layout is ``repro.training.checkpoint``'s, so a checkpoint written by
either package restores into the other:

* ``<dir>/step_%012d/manifest.json``: step, a description of the tree,
  ``n_leaves``, the JSON ``extra`` and each leaf's shape and dtype;
* ``<dir>/step_%012d/leaf_%05d.npy``: the leaves in JAX flatten order
  (dict keys sorted, ``None`` fields left out).

A save writes into ``<dir>/.tmp-<step>`` and renames it, so a crash
mid-write never corrupts the newest checkpoint; ``keep`` bounds how many
are retained.

bfloat16 leaves: the reference saves ``ml_dtypes``' bfloat16 arrays,
which ``np.save`` writes with the descr ``'<V2'`` (raw 16-bit records)
and the manifest names ``"bfloat16"``.  The port writes the same bytes
under the same header and reads any such leaf back as its 16-bit pattern,
keyed on the manifest's dtype, so neither side needs ``ml_dtypes``.
(The reference itself cannot load these files: numpy has no cast from
``V2`` to bfloat16; ROADMAP queue C.)

Checkpoints carry no topology.  A DTensor leaf (params placed on a
device mesh) is saved as its full tensor, in the same bytes as an
unsharded save; in a multi-rank world every rank gathers, rank 0 writes,
and the ranks meet at a barrier.  ``restore(shardings=...)`` places each
leaf on its target placements — any mesh, or none (elastic restore).

Host scalars in the tree (the port's ``MGDState.step``, an int; the
analog state's ``primed``, a bool) are written as the reference's 0-d
int32 / bool leaves and come back as host values.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.core.utils import is_dtensor, tree_flatten, tree_unflatten


class CheckpointMismatch(AssertionError):
    """The checkpoint's leaves do not fit the tree it is restored into
    (an ``AssertionError``, as the reference raises, but raised by a
    check that ``python -O`` keeps)."""


def _describe(tree) -> str:
    """A readable description of the tree's structure (the reference
    writes ``str(PyTreeDef)`` here; neither package reads it back)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(c) for c in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _to_numpy(leaf):
    """(array to save, manifest dtype name) for one leaf."""
    if isinstance(leaf, bool):
        return np.asarray(leaf, np.bool_), "bool"
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()       # the whole tensor
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_leaf(path, arr, dtype_name):
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    # the reference's bytes: ml_dtypes' bfloat16 saves as '<V2' records
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.array(arr, order="C").tobytes())


def save(ckpt_dir: str, step: int, params, extra: Optional[dict] = None,
         keep: int = 3):
    """Atomically save ``params`` (+ JSON-serializable ``extra``) at
    ``step``; returns the checkpoint's directory."""
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    leaves, _ = tree_flatten(params)
    distributed = any(is_dtensor(x) for x in leaves) \
        and torch.distributed.is_initialized()
    if distributed and torch.distributed.get_rank() != 0:
        for leaf in leaves:
            _to_numpy(leaf)             # the gathers are collective
        torch.distributed.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {
        "step": int(step),
        "treedef": _describe(params),
        "n_leaves": len(leaves),
        "extra": extra or {},
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        arr, dtype_name = _to_numpy(leaf)
        _save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr, dtype_name)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    if distributed:
        torch.distributed.barrier()
    return final


def _retain(ckpt_dir: str, keep: int):
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:012d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name[5:]) for name in os.listdir(ckpt_dir)
                  if name.startswith("step_"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_leaf(arr, dtype_name, ref):
    """A loaded array in the form of ``ref``'s leaf (host scalar, or a
    tensor of ref's dtype on ref's device)."""
    if isinstance(ref, bool):
        return bool(arr)
    if isinstance(ref, int):
        return int(arr)
    arr = np.array(arr, order="C")   # keeps 0-d leaves 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=ref.device, dtype=ref.dtype)


def restore(ckpt_dir: str, params_like, step: Optional[int] = None,
            mesh=None, shardings=None):
    """Load a checkpoint into the structure of ``params_like``.

    Returns ``(params, extra, step)``; each leaf takes the dtype and
    device of ``params_like``'s leaf.  With ``shardings`` (a tree of
    ``distributed.sharding.NamedSharding``, e.g.
    ``launch.specs.param_shardings(cfg, mesh)``) each leaf is placed on
    its mesh instead — the elastic-resharding path: the checkpoint
    carries no topology, so any compatible mesh works.  ``mesh`` is
    taken for the reference's signature; the shardings name the mesh.
    A leaf count or shape that does not match raises
    ``CheckpointMismatch`` (the training loop falls back through the
    older layouts on it).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:012d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    ref_leaves, treedef = tree_flatten(params_like)
    if len(ref_leaves) != manifest["n_leaves"]:
        raise CheckpointMismatch(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"model expects {len(ref_leaves)}")
    loaded = []
    shard_leaves = (tree_flatten(shardings)[0] if shardings is not None
                    else [None] * len(ref_leaves))
    for i, (ref, sharding) in enumerate(zip(ref_leaves, shard_leaves)):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        ref_shape = () if isinstance(ref, (bool, int)) else tuple(ref.shape)
        if tuple(arr.shape) != ref_shape:
            raise CheckpointMismatch(
                f"leaf {i}: checkpoint shape {arr.shape}, model {ref_shape}")
        leaf = _to_leaf(arr, manifest["leaves"][i]["dtype"], ref)
        if sharding is not None:
            from repro_torch.distributed.sharding import place
            leaf = place(leaf.to(sharding.mesh.device_type), sharding.spec,
                         sharding.mesh)
        loaded.append(leaf)
    return tree_unflatten(treedef, loaded), manifest["extra"], step
