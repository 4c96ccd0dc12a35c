"""Dense GQA decoder transformer, plain forward and fused MGD probe path.

PyTorch counterpart of ``repro.models.transformer`` for the ``dense``
family (Qwen3-style: GQA, optional qk-norm and QKV bias, SwiGLU MLP,
RMSNorm, RoPE or M-RoPE):

    model_init(cfg, seed, device=...)     → params (stacked-layer pytree)
    model_forward(params, cfg, batch)     → logits [B, S, V]
    model_loss(params, cfg, batch)        → scalar xent (MGD's loss_fn)
    make_transformer_probe_fn(cfg)        → probe_fn for the fused path
    model_prefill(params, cfg, batch, L)  → (logits, KV cache of length L)
    model_decode(params, cfg, tokens, c)  → (next logits [B, V], cache)

Layers are stacked on a leading L dim, as in the reference, so leaf ids
and sign indices match it; the reference's ``lax.scan`` over layers is a
Python loop here, with a host-int layer index.  Sharding annotations are
dropped (one card).  Other families (ssm, hybrid, MoE, MLA), stub-frontend
inputs (``embeds``, codebooks) raise and name ROADMAP A14, in the serving
entry points too.

The KV cache keeps the reference's layout, ``{"k", "v": [L, B, S_max,
KVH, dh], "length": int32}``.  Where the reference donates the cache into
a jitted decode, ``model_decode`` writes the new token's K and V into the
preallocated cache in place, at ``length − 1``.  ``length`` is a 0-d int32
tensor kept on the host, so a decode step reads it without waiting for
the card.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.perturbations import leaf_seed
from repro_torch.core.utils import (leaf_id_tree, tree_flatten, tree_map,
                                    tree_unflatten)
from repro_torch.device import resolve_device
from .attention import chunked_causal_attention, decode_attention
from .config import ArchConfig
from .layers import (dense, dense_init, embed, embedding_init, glu_mlp,
                     glu_mlp_init, pdense, pembed, pleaf, prmsnorm, rmsnorm,
                     rmsnorm_init)
from .rope import apply_mrope, apply_rope

_INIT_TAG = 0x7F4A
_EMBED_LAYER = 0xFFFF   # generator key of the embedding/head parameters


def supports_fused_probe(cfg: ArchConfig) -> bool:
    """Dense GQA decoders have the fully fused probe path; they are the
    only family the port runs."""
    return (cfg.family in ("dense", "vlm", "audio")
            and not cfg.use_mla and not cfg.n_experts)


def _check_family(cfg: ArchConfig) -> None:
    if not supports_fused_probe(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family"
            f"{' with MLA' if cfg.use_mla else ''}"
            f"{' with MoE' if cfg.n_experts else ''} is not ported to "
            f"repro_torch yet (ROADMAP A14); the port runs dense GQA "
            f"decoders")
    if cfg.n_codebooks:
        raise NotImplementedError(
            f"{cfg.name}: codebook token inputs are not ported yet "
            f"(ROADMAP A14)")
    if cfg.fsdp or cfg.seq_parallel:
        raise NotImplementedError(
            f"{cfg.name}: fsdp/seq_parallel shard over a mesh; the port runs "
            f"on one card (ROADMAP A15)")


# ---------------------------------------------------------------------------
# GQA attention sub-layer
# ---------------------------------------------------------------------------


def attn_init(gen, cfg: ArchConfig, dtype, device=None):
    h, kvh, dh, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": dense_init(gen, d, h * dh, bias=cfg.qkv_bias, dtype=dtype,
                         device=device),
        "wk": dense_init(gen, d, kvh * dh, bias=cfg.qkv_bias, dtype=dtype,
                         device=device),
        "wv": dense_init(gen, d, kvh * dh, bias=cfg.qkv_bias, dtype=dtype,
                         device=device),
        "wo": dense_init(gen, h * dh, d, dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, dtype, device)
        p["k_norm"] = rmsnorm_init(dh, dtype, device)
    return p


def _rope(cfg, x, positions):
    if cfg.mrope_sections is not None and positions.dim() == 3:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _qkv(p, x, positions, cfg):
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(b, s, h, dh)
    k = dense(p["wk"], x).reshape(b, s, kvh, dh)
    v = dense(p["wv"], x).reshape(b, s, kvh, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return _rope(cfg, q, positions), _rope(cfg, k, positions), v


def _attend(cfg, q, k, v):
    b, s = q.shape[:2]
    y = chunked_causal_attention(
        q, k, v, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
        impl=cfg.attn_impl)
    return y.reshape(b, s, -1)


def attn_apply(p, x, positions, cfg: ArchConfig):
    """Full-sequence causal attention.  Returns (y, (k, v))."""
    q, k, v = _qkv(p, x, positions, cfg)
    return dense(p["wo"], _attend(cfg, q, k, v)), (k, v)


def attn_decode_step(p, x1, positions, kcache, vcache, length: int,
                     cfg: ArchConfig):
    """x1: [B, 1, d].  Caches [B, S_max, KVH, dh]; the new entry is
    written in place at ``length − 1``.  Returns (y, kcache, vcache)."""
    b = x1.shape[0]
    q, k, v = _qkv(p, x1, positions, cfg)
    kcache[:, length - 1] = k[:, 0].to(kcache.dtype)
    vcache[:, length - 1] = v[:, 0].to(vcache.dtype)
    y = decode_attention(q, kcache, vcache, length)
    return dense(p["wo"], y.reshape(b, 1, -1)), kcache, vcache


# ---------------------------------------------------------------------------
# One decoder layer
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ArchConfig, dtype, device=None):
    _check_family(cfg)
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
            "ln2": rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn_init(gen, cfg, dtype, device),
            "mlp": glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def block_apply(p, x, positions, cfg: ArchConfig):
    """Pre-norm residual block.  Returns (x', (k, v))."""
    att, cache = attn_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                            positions, cfg)
    x = x + att
    x = x + glu_mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, cache


def block_decode(p, x1, positions, layer_cache, length: int,
                 cfg: ArchConfig):
    """One layer of one decode step.  Returns (x1', (kcache, vcache))."""
    kc, vc = layer_cache
    att, kc, vc = attn_decode_step(
        p["attn"], rmsnorm(p["ln1"], x1, cfg.norm_eps), positions, kc, vc,
        length, cfg)
    x1 = x1 + att
    x1 = x1 + glu_mlp(p["mlp"], rmsnorm(p["ln2"], x1, cfg.norm_eps))
    return x1, (kc, vc)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_init(gen, cfg: ArchConfig, dtype, device=None):
    p = {"tok": embedding_init(gen, cfg.vocab, cfg.d_model, dtype, device),
         "ln_f": rmsnorm_init(cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype,
                               device=device)
    return p


def _embed_tokens(p, cfg: ArchConfig, batch):
    """Tokens → [B, S, d]."""
    if "embeds" in batch:
        raise NotImplementedError("stub-frontend embeds inputs are not "
                                  "ported yet (ROADMAP A14)")
    _check_family(cfg)
    return embed(p["tok"], batch["tokens"])


def _logits(p, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        return x @ p["tok"]["table"].T
    return dense(p["head"], x)


def _positions(cfg: ArchConfig, batch, s, b, device=None):
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(b, s, 3)
    return pos


# ---------------------------------------------------------------------------
# Model: init / forward / loss
# ---------------------------------------------------------------------------


def _generator(seed: int, layer: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, layer, _INIT_TAG))
    return gen


def model_init(cfg: ArchConfig, seed: int, *, device=None):
    """Random params from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), drawn there: layer l from a generator keyed on
    (seed, l).  Stacked banks are filled one layer at a time, so the
    peak is the params plus one layer.  The draws match neither the JAX
    package's threefry nor another device's; parity tests carry the
    reference's params with ``repro_torch.convert``."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    params: Dict[str, Any] = {
        "embed": _embed_init(_generator(seed, _EMBED_LAYER, dev), cfg, dtype,
                             dev)}
    leaves, treedef = tree_flatten(
        block_init(_generator(seed, 0, dev), cfg, dtype, dev))
    stacked = [torch.empty((cfg.n_layers,) + tuple(a.shape), dtype=a.dtype,
                           device=dev) for a in leaves]
    for layer in range(cfg.n_layers):
        if layer:
            leaves = tree_flatten(block_init(_generator(seed, layer, dev),
                                             cfg, dtype, dev))[0]
        for dst, src in zip(stacked, leaves):
            dst[layer].copy_(src)
        del leaves
    params["layers"] = tree_unflatten(treedef, stacked)
    return params


def _layer_params(layers, layer: int):
    return tree_map(lambda a: a[layer], layers)


def model_forward(params, cfg: ArchConfig, batch, *, return_state=False):
    """Full-sequence forward → logits [B, S, V].  With ``return_state``
    also the per-layer (k, v), each stacked [L, B, S, KVH, dh] (the
    prefill path)."""
    x = _embed_tokens(params["embed"], cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, batch, s, b, x.device)
    kvs = []
    for layer in range(cfg.n_layers):
        x, kv = block_apply(_layer_params(params["layers"], layer), x,
                            positions, cfg)
        if return_state:
            kvs.append(kv)
        del kv
    x = rmsnorm(params["embed"]["ln_f"], x, cfg.norm_eps)
    logits = _logits(params["embed"], cfg, x)
    if return_state:
        return logits, (torch.stack([k for k, _ in kvs]),
                        torch.stack([v for _, v in kvs]))
    return logits


def _loss_from_logits(logits, labels):
    logits = logits.float()
    labels = labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def model_loss(params, cfg: ArchConfig, batch):
    """Token-mean softmax cross-entropy — MGD's scalar cost."""
    return _loss_from_logits(model_forward(params, cfg, batch),
                             batch["labels"])


# ---------------------------------------------------------------------------
# Fused probe path (MGD): forward under θ ± θ̃ without materializing θ̃
# ---------------------------------------------------------------------------
#
# The GQA/MLP weight matmuls and the untied head route through the
# perturbed-matmul kernels (signs regenerated next to the multiply; the
# antithetic central pair reads each W once).  Norm scales and biases take
# a materialized θ̃ (O(d)); the embedding table's θ̃ is generated for the
# gathered rows only (``pembed``).  Stacked banks are addressed through
# the per-layer seed shift, so every sign equals the host generator's.


def _pqkv(p, xs, positions, cfg, ids, probe, layer):
    b, s, _ = xs[0].shape
    h, kvh, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    qs = tuple(q.reshape(b, s, h, dh)
               for q in pdense(p["wq"], xs, ids["wq"], probe, layer=layer))
    ks = tuple(k.reshape(b, s, kvh, dh)
               for k in pdense(p["wk"], xs, ids["wk"], probe, layer=layer))
    vs = tuple(v.reshape(b, s, kvh, dh)
               for v in pdense(p["wv"], xs, ids["wv"], probe, layer=layer))
    if cfg.qk_norm:
        qs = prmsnorm(p["q_norm"], qs, ids["q_norm"], probe, layer=layer,
                      eps=cfg.norm_eps)
        ks = prmsnorm(p["k_norm"], ks, ids["k_norm"], probe, layer=layer,
                      eps=cfg.norm_eps)
    qs = tuple(_rope(cfg, q, positions) for q in qs)
    ks = tuple(_rope(cfg, k, positions) for k in ks)
    return qs, ks, vs


def _pattn_apply(p, xs, positions, cfg: ArchConfig, ids, probe, layer):
    qs, ks, vs = _pqkv(p, xs, positions, cfg, ids, probe, layer)
    ys = tuple(_attend(cfg, q, k, v) for q, k, v in zip(qs, ks, vs))
    return pdense(p["wo"], ys, ids["wo"], probe, layer=layer)


def _pglu_mlp(p, xs, ids, probe, layer):
    gs = pdense(p["gate"], xs, ids["gate"], probe, layer=layer)
    us = pdense(p["up"], xs, ids["up"], probe, layer=layer)
    hs = tuple(torch.nn.functional.silu(g.float()).to(x.dtype) * u
               for g, u, x in zip(gs, us, xs))
    return pdense(p["down"], hs, ids["down"], probe, layer=layer)


def _pblock_apply(p, xs, positions, cfg: ArchConfig, ids, probe, layer):
    xn = prmsnorm(p["ln1"], xs, ids["ln1"], probe, layer=layer,
                  eps=cfg.norm_eps)
    att = _pattn_apply(p["attn"], xn, positions, cfg, ids["attn"], probe,
                       layer)
    xs = tuple(x + a for x, a in zip(xs, att))
    ys = _pglu_mlp(
        p["mlp"],
        prmsnorm(p["ln2"], xs, ids["ln2"], probe, layer=layer,
                 eps=cfg.norm_eps),
        ids["mlp"], probe, layer)
    return tuple(x + y for x, y in zip(xs, ys))


def model_forward_perturbed(params, cfg: ArchConfig, batch, probe):
    """Per-sign perturbed logits, θ̃ fused into the weight matmuls: a tuple
    with one logits tensor per ``probe.ctx.signs`` entry."""
    _check_family(cfg)
    if "embeds" in batch:
        raise NotImplementedError("stub-frontend embeds inputs are not "
                                  "ported yet (ROADMAP A14)")
    ids = leaf_id_tree(params)
    emb, eids = params["embed"], ids["embed"]
    tokens = batch["tokens"]
    if cfg.tie_embeddings:
        # the head reads the whole perturbed table, so it is materialized
        tables = pleaf(emb["tok"]["table"], eids["tok"]["table"], probe)
        xs = tuple(t[tokens.long()] for t in tables)
    else:
        xs = pembed(emb["tok"], tokens, eids["tok"], probe)
    b, s, _ = xs[0].shape
    positions = _positions(cfg, batch, s, b, xs[0].device)
    for layer in range(cfg.n_layers):
        xs = _pblock_apply(_layer_params(params["layers"], layer), xs,
                           positions, cfg, ids["layers"], probe, layer)
    xs = prmsnorm(emb["ln_f"], xs, eids["ln_f"], probe, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return tuple(x @ t.T for x, t in zip(xs, tables))
    return pdense(emb["head"], xs, eids["head"], probe)


def model_probe_costs(params, cfg: ArchConfig, batch, probe):
    """probe_fn for ``MGDConfig(fused=True)``: [n_signs] xent costs.

    Fused for every family the port runs.  The reference's branch that
    materializes θ̃ per sign serves the families that raise here (A14).
    """
    logits = model_forward_perturbed(params, cfg, batch, probe)
    return torch.stack(
        [_loss_from_logits(lg, batch["labels"]) for lg in logits])


def make_transformer_probe_fn(cfg: ArchConfig):
    """Bind ``cfg`` → probe_fn(params, batch, probe) for build_mgd_step."""

    def probe_fn(params, batch, probe):
        return model_probe_costs(params, cfg, batch, probe)

    return probe_fn


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               device=None):
    """An empty KV cache on ``device`` (the card unless ``device="cpu"``):
    ``{"k", "v": [L, B, max_len, KVH, dh]`` zeros in the model's dtype,
    ``"length"``: a 0-d int32 host tensor}."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "length": torch.zeros((), dtype=torch.int32)}


def model_prefill(params, cfg: ArchConfig, batch, max_len: int):
    """Run the prompt; returns (full-seq logits, ready-to-decode cache)
    on the tokens' device."""
    logits, (k, v) = model_forward(params, cfg, batch, return_state=True)
    b, s = batch["tokens"].shape[0], batch["tokens"].shape[-1]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, device=logits.device)
    cache["k"][:, :, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :, :s] = v.to(cache["v"].dtype)
    cache["length"] = torch.tensor(s, dtype=torch.int32)
    return logits, cache


def model_decode(params, cfg: ArchConfig, tokens, cache, embeds=None):
    """One decode step.  tokens: [B] int.  Returns (logits [B, V], cache):
    the cache's K and V are written in place (the caller's dict keeps
    its old ``length``; use the returned one)."""
    if embeds is not None:
        raise NotImplementedError("stub-frontend embeds inputs are not "
                                  "ported yet (ROADMAP A14)")
    _check_family(cfg)
    x1 = embed(params["embed"]["tok"], tokens)[:, None, :]
    b = x1.shape[0]
    length = int(cache["length"]) + 1
    if length > cache["k"].shape[2]:
        raise ValueError(f"KV cache full: decoding position {length - 1} "
                         f"of a cache of {cache['k'].shape[2]}")
    pos = torch.full((b, 1), length - 1, dtype=torch.int32,
                     device=x1.device)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(b, 1, 3)
    for layer in range(cfg.n_layers):
        x1, _ = block_decode(_layer_params(params["layers"], layer), x1, pos,
                             (cache["k"][layer], cache["v"][layer]), length,
                             cfg)
    x1 = rmsnorm(params["embed"]["ln_f"], x1, cfg.norm_eps)
    logits = _logits(params["embed"], cfg, x1)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": torch.tensor(length, dtype=torch.int32)}
