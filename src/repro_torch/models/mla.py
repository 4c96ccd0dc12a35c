"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

PyTorch counterpart of ``repro.models.mla``.  Queries and KV are low-rank
compressed; only the compressed latent c_kv (kv_lora_rank) and the shared
decoupled-RoPE key k_rope are cached.  Two forms:

* expand form (train, prefill): decompress K and V at every position and
  run causal attention (``chunked_causal_attention``);
* absorbed form (decode): fold W_UK into the query and W_UV into the
  output, so attention runs against the compressed cache in f32 (TF32
  off), positions at or past ``length`` masked with ``NEG_INF``.

The two forms agree (``tests/test_torch_mla.py``).  ``length`` is a host
int; the cache update writes the new token's entries in place at
``length − 1``.

On a DeviceMesh the expand form attends per (batch, head) shard
(``sharding.per_shard``); the latent caches lie (None, "batch", "kvseq")
as the reference places them, the update writes on the shard that holds
the position (``sharding.write_at``), and the absorbed decode attends to
each rank's block of the sequence and combines the blocks' softmax
(``sharding.seq_per_shard``), flash-decoding style.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.utils import f32, is_dtensor
from repro_torch.distributed.sharding import (per_shard, seq_per_shard,
                                              shard, write_at)
from .attention import NEG_INF, chunked_causal_attention
from .layers import dense, dense_init, full_f32_matmul, rmsnorm, rmsnorm_init
from .rope import apply_rope


def mla_init(gen: torch.Generator, cfg, dtype, device=None):
    """cfg needs: d_model, n_heads, q_lora_rank, kv_lora_rank,
    qk_nope_head_dim, qk_rope_head_dim, v_head_dim."""
    h = cfg.n_heads
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = {
        "wkv_a": dense_init(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                            dtype=dtype, device=device),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, dtype, device),
        "wkv_b": dense_init(gen, cfg.kv_lora_rank,
                            h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                            dtype=dtype, device=device),
        "wo": dense_init(gen, h * cfg.v_head_dim, cfg.d_model, dtype=dtype,
                         device=device),
    }
    if cfg.q_lora_rank:
        p["wq_a"] = dense_init(gen, cfg.d_model, cfg.q_lora_rank,
                               dtype=dtype, device=device)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, device)
        p["wq_b"] = dense_init(gen, cfg.q_lora_rank, h * qd, dtype=dtype,
                               device=device)
    else:
        p["wq"] = dense_init(gen, cfg.d_model, h * qd, dtype=dtype,
                             device=device)
    return p


def _queries(p, x, cfg):
    """(q_nope [B,S,H,dn], q_rope [B,S,H,dr]), the q-LoRA path with its
    RMSNorm when ``cfg.q_lora_rank``."""
    b, s, _ = x.shape
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q = dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x)))
    else:
        q = dense(p["wq"], x)
    q = q.reshape(b, s, cfg.n_heads, qd)
    return q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]


def _kv_latent(p, x, cfg, positions):
    """(c_kv [B,S,r] normalized, k_rope [B,S,1,dr] rotated)."""
    ckv_full = dense(p["wkv_a"], x)
    c_kv = rmsnorm(p["kv_norm"], ckv_full[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(ckv_full[:, :, None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def mla_attention(p, x, positions, cfg, *, q_block=512, kv_block=512,
                  impl="masked"):
    """Expand-form causal MLA over a full sequence.  Returns (y [B,S,d],
    cache payload (c_kv [B,S,r], k_rope [B,S,dr]))."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    q_nope, q_rope = _queries(p, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _kv_latent(p, x, cfg, positions)

    kv = dense(p["wkv_b"], c_kv).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    q, k, v = (shard(t, "batch", None, "model", None) for t in (q, k, v))

    def attend(q, k, v):
        return chunked_causal_attention(q, k, v, q_block=q_block,
                                        kv_block=kv_block, impl=impl)

    # under a mesh each (batch, head) shard attends on its own rank
    attn = per_shard(attend, q, k, v)
    y = dense(p["wo"], attn.reshape(b, s, h * dv))
    return y, (c_kv, k_rope[:, :, 0, :])


def _absorb_weights(p, cfg):
    """wkv_b split into per-head W_UK [r,H,dn] and W_UV [r,H,dv]."""
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    wkv_b = p["wkv_b"]["w"].reshape(cfg.kv_lora_rank, cfg.n_heads, dn + dv)
    return wkv_b[..., :dn], wkv_b[..., dn:]


def mla_decode(p, x1, cache, length: int, cfg):
    """Absorbed-form single-token decode.

    x1: [B, 1, d]; cache = (c_kv [B,S_max,r], k_rope [B,S_max,dr]), already
    holding this token's entries at ``length − 1``."""
    b = x1.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    c_cache, r_cache = cache
    pos = torch.full((b, 1), length - 1, dtype=torch.int32, device=x1.device)

    q_nope, q_rope = _queries(p, x1, cfg)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)         # [B,1,H,dr]
    w_uk, w_uv = _absorb_weights(p, cfg)
    with full_f32_matmul():
        # fold W_UK into the query: q_eff [B,H,r]
        q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                             w_uk.float())
        q_r = q_rope[:, 0].float()
        attend = functools.partial(_latent_attend,
                                   root=f32(np.sqrt(dn + dr)))
        if is_dtensor(c_cache):
            ctx = seq_per_shard(attend, (q_eff, q_r), (c_cache, r_cache),
                                length, tuple(q_eff.shape))
        else:
            ctx = attend(q_eff, q_r, c_cache, r_cache, length)
        attn = torch.einsum("bhr,rhv->bhv", ctx, w_uv.float())
    return dense(p["wo"], attn.reshape(b, 1, -1).to(x1.dtype))


def _latent_attend(q_eff, q_rope, c_cache, r_cache, length, *, root,
                   seq_offset: int = 0, combine=None):
    """The absorbed form's attention against the latent caches, f32 →
    ctx [B, H, r], the scores divided by ``root`` (√(dn + dr)).  A cache block of a sequence-sharded cache passes its
    first position as ``seq_offset`` and ``combine(x, op)``, the reduction
    over the blocks: the softmax then comes from the blocks' partial max,
    sum and values (``sharding.seq_per_shard``)."""
    c32 = c_cache.float()
    scores = (torch.einsum("bhr,bsr->bhs", q_eff, c32)
              + torch.einsum("bhd,bsd->bhs", q_rope, r_cache.float())
              ) / root
    idx = torch.arange(c_cache.shape[1], device=c_cache.device) + seq_offset
    scores = torch.where(idx[None, None, :] < length, scores, NEG_INF)
    if combine is None:
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhs,bsr->bhr", probs, c32)
    m = combine(scores.amax(dim=-1), "max")
    e = torch.exp(scores - m[..., None])
    den = combine(e.sum(dim=-1), "sum")
    return combine(torch.einsum("bhs,bsr->bhr", e, c32), "sum") \
        / den[..., None]


def mla_cache_update(p, x1, cache, length: int, cfg):
    """This token's (c_kv, k_rope), written in place at ``length − 1`` of
    the caches; returns the caches."""
    b = x1.shape[0]
    pos = torch.full((b, 1), length - 1, dtype=torch.int32, device=x1.device)
    c_kv, k_rope = _kv_latent(p, x1, cfg, pos)
    c_cache, r_cache = cache
    write_at(c_cache, 1, length - 1, c_kv[:, 0])
    write_at(r_cache, 1, length - 1, k_rope[:, 0, 0])
    return c_cache, r_cache
