"""τ_x-aware sample feeds: ``sample_fn(sample_index) -> batch``.

MGD's τ_x (input-sample change time) is the data pipeline's job: the
driver asks for index n // τ_x at step n.  Every sampler is a pure
function of the index, so a run is deterministic across restarts.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.perturbations import leaf_seed
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


def sample_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` keyed on (seed, index)."""
    hi = leaf_seed(seed, index, 1)
    lo = leaf_seed(seed, index, 2)
    gen = torch.Generator(device=device)
    gen.manual_seed((hi << 32) | lo)
    return gen


def generator_sampler(batch_fn: Callable, batch_size: int, *, seed=0,
                      as_dict_keys=("x", "y"), device=None):
    """Index-seeded procedural sampler:
    ``sample_fn(i) = batch_fn(generator keyed on (seed, i), batch_size)``."""
    dev = resolve_device(device)

    def sample_fn(i: int):
        out = batch_fn(sample_generator(seed, i, dev), batch_size)
        if isinstance(out, dict):
            return out
        return dict(zip(as_dict_keys, out))

    return sample_fn


def lm_sampler(batch_size: int, seq_len: int, vocab: int, *, seed=0,
               device=None):
    """Index-seeded Zipf-Markov LM batches (``tasks.lm_batch``)."""
    return generator_sampler(
        lambda g, b: tasks.lm_batch(g, b, seq_len, vocab), batch_size,
        seed=seed, device=device)
