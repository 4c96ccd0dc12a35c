"""Blockwise (flash-style) causal attention in plain PyTorch.

PyTorch counterpart of ``repro.models.attention`` (plain JAX there, not a
Pallas kernel).  Grouped-query attention is computed in grouped layout:
KV heads are never repeated to the Q-head count.  The online-softmax
accumulation is f32 ``einsum`` in the reference's order of operations.

Two exact implementations, equal bit for bit:

* ``masked``   — Q blocks × KV blocks with causal masking.  A KV block
  wholly above the diagonal changes nothing (its probabilities are
  exactly 0 and the rescale exactly 1), so it is skipped.
* ``balanced`` — pairs Q block i with Q block n−1−i so every pair does a
  constant n+1 KV-block visits.

``decode_attention`` is single-token attention against a KV cache, the
serving path's (``models.transformer.model_decode``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.utils import f32

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def _block_scores(qb, kb, scale):
    """qb: [B, bq, KVH, G, D], kb: [B, bk, KVH, D] → [B, KVH, G, bq, bk] f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float()) * scale


def _block_values(p, vb):
    """p: [B, KVH, G, bq, bk] f32, vb: [B, bk, KVH, D] → [B, bq, KVH, G, D]."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p, vb.float())


def _to_bqhgd(x):
    """[B, KVH, G, bq] → [B, bq, KVH, G] (align stats with value layout)."""
    return x.permute(0, 3, 1, 2)


def _online_update(carry, qb, kb, vb, mask, scale):
    """One online-softmax accumulation step (all f32)."""
    m, l, acc = carry
    s = _block_scores(qb, kb, scale)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * _to_bqhgd(corr)[..., None] + _block_values(p, vb)
    return m_new, l_new, acc_new


def _finish(carry, dtype):
    _, l, acc = carry
    return (acc / _to_bqhgd(l)[..., None]).to(dtype)


def _init_carry(b, kvh, g, blk, dv, device):
    return (torch.full((b, kvh, g, blk), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, kvh, g, blk), dtype=torch.float32, device=device),
            torch.zeros((b, blk, kvh, g, dv), dtype=torch.float32,
                        device=device))


def _causal_mask(iq, j, q_block, kv_block, device):
    qpos = iq * q_block + torch.arange(q_block, device=device)
    kpos = j * kv_block + torch.arange(kv_block, device=device)
    return (kpos[None, :] <= qpos[:, None])[None, None, None]


def chunked_causal_attention(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S, KVH, D]
    v: torch.Tensor,   # [B, S, KVH, D]
    *,
    q_block: int = 512,
    kv_block: int = 512,
    impl: str = "masked",
) -> torch.Tensor:
    """Exact causal attention, O(S·block) memory.  Returns [B, S, H, Dv]."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    scale = f32(1.0 / np.sqrt(d))
    q_block = min(q_block, s)
    kv_block = min(kv_block, s)
    if s % q_block or s % kv_block:
        # end-padding is exact under the causal mask: padded keys sit at
        # positions after every real query; padded query rows are dropped.
        blk = max(q_block, kv_block)
        pad = blk - s % blk
        padded = [F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v)]
        out = chunked_causal_attention(
            *padded, q_block=q_block, kv_block=kv_block, impl=impl)
        return out[:, :s]
    qg = q.reshape(b, s, kvh, g, d)
    if impl == "balanced":
        return _balanced(qg, k, v, q_block, scale).reshape(b, s, h, dv)
    if impl != "masked":
        raise ValueError(f"unknown attention impl {impl!r}")
    nq = s // q_block
    outs = []
    for iq in range(nq):
        qb = qg[:, iq * q_block:(iq + 1) * q_block]
        carry = _init_carry(b, kvh, g, q_block, dv, q.device)
        last = ((iq + 1) * q_block - 1) // kv_block   # last KV block in reach
        for j in range(last + 1):
            kb = k[:, j * kv_block:(j + 1) * kv_block]
            vb = v[:, j * kv_block:(j + 1) * kv_block]
            mask = _causal_mask(iq, j, q_block, kv_block, q.device)
            carry = _online_update(carry, qb, kb, vb, mask, scale)
        outs.append(_finish(carry, q.dtype))
    return torch.cat(outs, dim=1).reshape(b, s, h, dv)


def _balanced(qg, k, v, blk, scale):
    """Load-balanced exact causal attention (q_block == kv_block == blk):
    Q block i pairs with Q block n−1−i and each pair visits n+1 KV blocks."""
    b, s, kvh, g, d = qg.shape
    dv = v.shape[-1]
    n = s // blk
    if n % 2:
        raise ValueError(f"balanced impl needs an even number of blocks, "
                         f"got {n}")
    outs = [None] * n
    for p in range(n // 2):
        halves = {p: _init_carry(b, kvh, g, blk, dv, qg.device),
                  n - 1 - p: _init_carry(b, kvh, g, blk, dv, qg.device)}
        for t in range(n + 1):
            iq, j = (p, t) if t <= p else (n - 1 - p, t - (p + 1))
            qb = qg[:, iq * blk:(iq + 1) * blk]
            kb = k[:, j * blk:(j + 1) * blk]
            vb = v[:, j * blk:(j + 1) * blk]
            mask = _causal_mask(iq, j, blk, blk, qg.device)
            halves[iq] = _online_update(halves[iq], qb, kb, vb, mask, scale)
        for iq, carry in halves.items():
            outs[iq] = _finish(carry, qg.dtype)
    return torch.cat(outs, dim=1)


def decode_attention(
    q1: torch.Tensor,        # [B, 1, H, D] — the new token's query
    k_cache: torch.Tensor,   # [B, S_max, KVH, D]
    v_cache: torch.Tensor,   # [B, S_max, KVH, D]
    length,                  # valid cache length (new token included)
    *,
    seq_offset: int = 0,
    combine=None,
) -> torch.Tensor:
    """Single-token attention against the cache.  Returns [B, 1, H, Dv].

    Grouped layout (``bhgd,bshd->bhgs``): the KV heads are never repeated.
    Scores and probabilities are f32; positions ≥ ``length`` (a host int
    or a 0-d tensor) are masked with ``NEG_INF``.

    A cache sharded along its sequence (``sharding.seq_per_shard``)
    passes the block's first position as ``seq_offset`` and
    ``combine(x, op)``, the reduction (``"max"``/``"sum"``) over the
    sequence shards: the softmax is then taken flash-decoding style,
    from the shards' partial max, sum and values."""
    b, _, h, d = q1.shape
    kvh = k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = h // kvh
    scale = f32(1.0 / np.sqrt(d))
    qg = q1.reshape(b, kvh, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=k_cache.device) + seq_offset
    s = torch.where(pos[None, None, None, :] < length, s, NEG_INF)
    if combine is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    else:
        m = combine(s.amax(dim=-1), "max")
        e = torch.exp(s - m[..., None])
        den = combine(e.sum(dim=-1), "sum")
        out = combine(torch.einsum("bhgs,bshd->bhgd", e, v_cache.float()),
                      "sum") / den[..., None]
    return out.reshape(b, 1, h, dv).to(q1.dtype)
