"""τ_x-aware sample feeds: ``sample_fn(sample_index) -> batch``.

MGD's τ_x (input-sample change time) is the data pipeline's job: the
driver asks for index n // τ_x at step n.  Every sampler is a pure
function of the index, so a run is deterministic across restarts.
Batch i of a procedural sampler is ``batch_fn(fold_in(prng_key(seed), i),
B)`` on ``core.rng``'s threefry keys: the reference's batch i.

``shard_batch`` places a batch on a device mesh (batch dim → "batch");
``shard_chip_batch`` cuts a host batch into the contiguous per-chip
slices a chip farm consumes.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import rng
from repro_torch.core.utils import path_str, tree_map, tree_paths
from repro_torch.device import resolve_device
from . import tasks


def dataset_sampler(x: torch.Tensor, y: torch.Tensor, batch_size: int, *,
                    wrap=True):
    """Cycle deterministically through a fixed dataset (XOR/parity).
    ``batch_size >= len(x)`` presents the whole set every time."""
    n = x.shape[0]

    def sample_fn(i: int):
        if batch_size >= n:
            return {"x": x, "y": y}
        start = (i * batch_size) % n if wrap else i * batch_size
        idx = (start + torch.arange(batch_size, device=x.device)) % n
        return {"x": x.index_select(0, idx), "y": y.index_select(0, idx)}

    return sample_fn


def generator_sampler(batch_fn: Callable, batch_size: int, *, seed=0,
                      as_dict_keys=("x", "y"), device=None):
    """Index-seeded procedural sampler: ``sample_fn(i) =
    batch_fn(fold_in(prng_key(seed), i), batch_size, device=device)``."""
    dev = resolve_device(device)
    base = rng.prng_key(seed)

    def sample_fn(i: int):
        out = batch_fn(rng.fold_in(base, i), batch_size, device=dev)
        if isinstance(out, dict):
            return out
        return dict(zip(as_dict_keys, out))

    return sample_fn


def lm_sampler(batch_size: int, seq_len: int, vocab: int, *, seed=0,
               device=None):
    """Index-seeded Zipf-Markov LM batches (``tasks.lm_batch``)."""
    return generator_sampler(
        lambda k, b, device: tasks.lm_batch(k, b, seq_len, vocab,
                                            device=device),
        batch_size, seed=seed, device=device)


def shard_batch(batch, mesh):
    """Place a batch onto the DeviceMesh ``mesh``, batch dim →
    ("pod", "data"): every rank holds the whole batch and keeps its
    block (no communication)."""
    from repro_torch.distributed.sharding import logical_spec, place

    return tree_map(lambda x: place(
        x, logical_spec(tuple(x.shape), ["batch"], mesh), mesh), batch)


def shard_chip_batch(batch, n_chips: int, chip: int):
    """Chip ``chip``'s contiguous leading-dim shard out of ``n_chips``:
    chip i consumes the rows pod i of an equal-k mesh would.  Pure
    indexing on tensors or numpy leaves."""

    def one(x):
        per = x.shape[0] // n_chips
        return x[chip * per:(chip + 1) * per]

    return tree_map(one, batch)


def check_chip_shardable(batch, n_chips: int) -> None:
    """Raise unless every batch leaf's leading dim splits evenly into
    ``n_chips`` contiguous shards."""
    for path, leaf in tree_paths(batch):
        shape = getattr(leaf, "shape", ())
        if not shape or shape[0] % n_chips:
            name = path_str(path)
            raise ValueError(
                f"batch leaf {name!r} with shape {tuple(shape)} cannot be "
                f"sharded over {n_chips} chips — its leading dim must be a "
                f"multiple of the farm size")
