"""Batched serving: prefill a prompt batch, then step the decoder.

The twin of the reference's ``serving/decode.py``.  Static-batch
decoding: the prompt is prefilled into a KV cache of ``S_prompt +
max_new`` positions, and each decode step writes one position of that
cache in place.  Greedy and temperature sampling (``core.rng``'s Gumbel
draws, keyed as the reference keys them: the first tokens from
``prng_key(seed)``, then ``key = fold_in(key, t)`` for t ≥ 1);
per-request stop handling via an ``alive`` mask, so a finished request
keeps emitting ``eos_id`` while its slot keeps cycling.  Generation runs
where the params live.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import rng
from repro_torch.core.utils import f32, tree_leaves
from repro_torch.models.transformer import model_decode, model_prefill


def _sample(logits, key, temperature):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return rng.categorical(key, logits.float() / f32(temperature),
                           axis=-1).to(torch.int32)


@torch.no_grad()
def greedy_generate(params, cfg, prompts, max_new: int, *,
                    temperature: float = 0.0, seed: int = 0,
                    eos_id: Optional[int] = None):
    """prompts: [B, S_prompt] int → generated [B, max_new] int32."""
    b, s_prompt = prompts.shape
    logits, cache = model_prefill(params, cfg, {"tokens": prompts},
                                  s_prompt + max_new)
    key = rng.prng_key(seed)
    toks = _sample(logits[:, -1], key, temperature)
    del logits
    out = [toks]
    alive = torch.ones((b,), dtype=torch.bool, device=toks.device)
    for t in range(1, max_new):
        key = rng.fold_in(key, t)
        logits, cache = model_decode(params, cfg, toks, cache)
        toks = _sample(logits, key, temperature)
        if eos_id is not None:
            alive = alive & (out[-1] != eos_id)
            toks = torch.where(alive, toks, eos_id)
        out.append(toks)
    return torch.stack(out, dim=1)


def serve_batch(params, cfg, requests, max_new: int, **kw):
    """Pad a ragged request list to a rectangular batch and generate.

    requests: list of 1-D int tensors or arrays.  Left-pads with 0
    (positions still causal), on the params' device."""
    dev = tree_leaves(params)[0].device
    b = len(requests)
    s = max(int(r.shape[0]) for r in requests)
    batch = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i, r in enumerate(requests):
        batch[i, s - r.shape[0]:] = torch.as_tensor(r, dtype=torch.int32)
    return greedy_generate(params, cfg, batch, max_new, **kw)
