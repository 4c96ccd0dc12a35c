"""Decoder assembly for every family: plain forward, fused MGD probe
path, and serving.

PyTorch counterpart of ``repro.models.transformer``.  The attention
families (``dense``, ``vlm``, ``audio``, ``moe``): GQA attention (optional
qk-norm and QKV bias, RoPE or M-RoPE) or MLA (DeepSeek-V3), a SwiGLU MLP
or a mixture of experts, RMSNorm.  The recurrent ones: ``ssm`` (RWKV-6
blocks) and ``hybrid`` (zamba2: groups of ``attn_every`` Mamba-2 blocks,
each group followed by one call of a single shared attention + MLP
block):

    model_init(cfg, seed, device=...)     → params (stacked-layer pytree)
    model_forward(params, cfg, batch)     → logits [B, S, V] ([B, S, nq, V]
                                            with codebooks)
    model_loss(params, cfg, batch)        → scalar xent (MGD's loss_fn)
    make_transformer_probe_fn(cfg)        → probe_fn for the fused path
    model_prefill(params, cfg, batch, L)  → (logits, cache of length L)
    model_decode(params, cfg, tokens, c)  → (next logits [B, V], cache)

A batch holds ``tokens`` [B, S] (with ``n_codebooks``: [B, nq, S], the
codebook embeddings summed), or stub-frontend ``embeds`` [B, S, d] in
place of the embedding, and optional ``positions`` ([B, S, 3] for
M-RoPE).  Layers are stacked on a leading L dim, as in the reference, so
leaf ids and sign indices match it; the reference's ``lax.scan`` over
layers is a Python loop here, with a host-int layer index.  The
reference's sharding annotations stand at its sites as
``distributed.sharding.shard``: a no-op without an active DeviceMesh;
under one (``sharding.use_mesh``, params placed by
``launch.specs.param_shardings``) every family's forward, loss,
prefill and decode run on DTensors (MoE, MLA and the recurrent blocks
place their own tensors: ``moe.py``, ``mla.py``, ``rwkv6.py``,
``mamba2.py``), and the fused probe's kernels take the local shards
(``layers.pdense``).  There, tensors made inside the
model (positions, masks, constants) count as replicated
(``sharding.mesh_ops``), heads are viewed only on shards that keep
whole head groups (``_heads``), attention runs on each (batch, head)
shard (``sharding.per_shard``), decode attention over a
sequence-sharded cache combines its shards' softmax
(``sharding.seq_per_shard``), and the loss is vocab-parallel
(``sharding.vocab_parallel_nll``).

Dense GQA decoders (incl. the vlm/audio backbones) probe through the
perturbed-matmul kernels (``supports_fused_probe``); MoE, MLA and the
recurrent families probe by materializing θ ± θ̃ leaf by leaf
(``perturbations.perturbed_tree``), as the reference does, and their
update still runs in the window-update kernel.

The cache keeps the reference's layout: ``{"k", "v": [L, B, S_max, KVH,
dh]}``, or for MLA ``{"c_kv": [L, B, S_max, r], "k_rope": [L, B, S_max,
dr]}``; for ``ssm`` ``{"state"}`` (each layer's RWKV-6 state stacked on
L); for ``hybrid`` ``{"state", "k", "v": [G, B, S_max, KVH, dh]}`` (the
Mamba-2 states stacked on the 54 blocks, one K/V cache a group); and
``"length"``.  Where the reference donates the cache into a jitted
decode, ``model_decode`` writes the new token's entries (K/V at ``length
− 1``, the recurrent states whole) into the cache in place.  ``length`` is
a 0-d int32 tensor kept on the host, so a decode step reads it without
waiting for the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tracing
from repro_torch.core import perturbations as pert
from repro_torch.core.perturbations import leaf_seed
from repro_torch.core.utils import (is_dtensor, leaf_id_tree, tree_flatten,
                                    tree_leaves, tree_map, tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (active_mesh, copy_into,
                                              from_block, full, local_block,
                                              logical_spec, mesh_ops,
                                              per_shard, seq_per_shard,
                                              settle, shard,
                                              vocab_parallel_nll, write_at)
from .attention import chunked_causal_attention, decode_attention
from .config import ArchConfig
from .layers import (dense, dense_init, embed, embedding_init, glu_mlp,
                     glu_mlp_init, pdense, pembed, pleaf, prmsnorm, rmsnorm,
                     rmsnorm_init)
from .mamba2 import (mamba2_block, mamba2_block_init, mamba2_block_step,
                     mamba2_state_init)
from .mla import mla_attention, mla_cache_update, mla_decode, mla_init
from .moe import moe_apply, moe_init
from .rope import apply_mrope, apply_rope
from .rwkv6 import (rwkv6_block, rwkv6_block_init, rwkv6_block_step,
                    rwkv6_state_init)

_INIT_TAG = 0x7F4A
_EMBED_LAYER = 0xFFFF   # generator key of the embedding/head parameters
_SHARED_LAYER = 0xFFFE  # generator key of the hybrid's shared block


def supports_fused_probe(cfg: ArchConfig) -> bool:
    """Dense GQA decoders (incl. the vlm/audio stub frontends) have the
    fully fused probe path; MoE, MLA, ssm and hybrid models materialize
    θ ± θ̃."""
    return (cfg.family in ("dense", "vlm", "audio")
            and not cfg.use_mla and not cfg.n_experts)


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


def _heads(y, n: int, cfg: ArchConfig):
    """[B, S, n·dh] → [B, S, n, dh].  Under a mesh the projection's
    shards are first made to hold whole KV-head groups (sharded over
    "model" only where the KV-head count divides it, else replicated):
    DTensor cannot view a shard that splits a head, where GSPMD would
    pad."""
    b, s, _ = y.shape
    if active_mesh() is not None:
        y = shard(y, "batch", None,
                  "model" if _kv_heads_shard(cfg) else None)
    return y.reshape(b, s, n, cfg.head_dim)


def _kv_heads_shard(cfg: ArchConfig) -> bool:
    """True under a mesh whose "model" axes divide the KV-head count."""
    return (active_mesh() is not None
            and logical_spec((cfg.kv_heads,), ["model"])[0] is not None)


def _qkv(p, x, positions, cfg):
    h, kvh = cfg.n_heads, cfg.kv_heads
    q = _heads(dense(p["wq"], x), h, cfg)
    k = _heads(dense(p["wk"], x), kvh, cfg)
    v = _heads(dense(p["wv"], x), kvh, cfg)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return _rope(cfg, q, positions), _rope(cfg, k, positions), v


def _attend(cfg, q, k, v):
    b, s = q.shape[:2]

    def attend(q, k, v):
        return chunked_causal_attention(
            q, k, v, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
            impl=cfg.attn_impl)

    # under a mesh each (batch, head) shard attends on its own rank
    with tracing.span("attn.core"):
        y = per_shard(attend, q, k, v)
        return y.reshape(b, s, -1)


def _shard_heads(cfg, *xs):
    """The reference's ``shard(x, "batch", None, "model", None)`` on
    q/k/v, with the head dim sharded only where ``_heads`` kept it."""
    heads = "model" if _kv_heads_shard(cfg) else None
    return tuple(shard(x, "batch", None, heads, None) for x in xs)


def attn_apply(p, x, positions, cfg: ArchConfig):
    """Full-sequence causal attention.  Returns (y, (k, v))."""
    q, k, v = _shard_heads(cfg, *_qkv(p, x, positions, cfg))
    return dense(p["wo"], _attend(cfg, q, k, v)), (k, v)


def attn_decode_step(p, x1, positions, kcache, vcache, length: int,
                     cfg: ArchConfig):
    """x1: [B, 1, d].  Caches [B, S_max, KVH, dh]; the new entry is
    written in place at ``length − 1``.  Returns (y, kcache, vcache)."""
    b = x1.shape[0]
    q, k, v = _qkv(p, x1, positions, cfg)
    write_at(kcache, 1, length - 1, k[:, 0])
    write_at(vcache, 1, length - 1, v[:, 0])
    if is_dtensor(kcache):
        y = seq_per_shard(decode_attention, (q,), (kcache, vcache), length,
                          tuple(q.shape[:3]) + (vcache.shape[-1],))
    else:
        y = decode_attention(q, kcache, vcache, length)
    return dense(p["wo"], y.reshape(b, 1, -1)), kcache, vcache


# ---------------------------------------------------------------------------
# One decoder layer
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ArchConfig, dtype, device=None):
    p = {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
         "ln2": rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.use_mla:
        p["attn"] = mla_init(gen, cfg, dtype, device)
    else:
        p["attn"] = attn_init(gen, cfg, dtype, device)
    if cfg.n_experts:
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _mlp_part(p, x, cfg: ArchConfig):
    if cfg.n_experts:
        return moe_apply(p["moe"], x, cfg, group_size=cfg.moe_group_size,
                         capacity_factor=cfg.moe_capacity_factor)
    return glu_mlp(p["mlp"], x)


def block_apply(p, x, positions, cfg: ArchConfig):
    """Pre-norm residual block.  Returns (x', cache payload): (k, v), or
    for MLA (c_kv, k_rope)."""
    seq_ax = "sp" if cfg.seq_parallel else None
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        att, cache = mla_attention(
            p["attn"], xn, positions, cfg, q_block=cfg.attn_q_block,
            kv_block=cfg.attn_kv_block, impl=cfg.attn_impl)
    else:
        att, cache = attn_apply(p["attn"], xn, positions, cfg)
    x = shard(x + att, "batch", seq_ax, None)
    x = x + _mlp_part(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return shard(x, "batch", seq_ax, None), cache


def block_decode(p, x1, positions, layer_cache, length: int,
                 cfg: ArchConfig):
    """One layer of one decode step; the layer's caches (kcache, vcache)
    or, for MLA, (c_kv, k_rope) are written in place.  Returns (x1',
    layer caches)."""
    xn = rmsnorm(p["ln1"], x1, cfg.norm_eps)
    if cfg.use_mla:
        cache = mla_cache_update(p["attn"], xn, layer_cache, length, cfg)
        att = mla_decode(p["attn"], xn, cache, length, cfg)
    else:
        kc, vc = layer_cache
        att, kc, vc = attn_decode_step(p["attn"], xn, positions, kc, vc,
                                       length, cfg)
        cache = (kc, vc)
    x1 = x1 + att
    x1 = x1 + _mlp_part(p, rmsnorm(p["ln2"], x1, cfg.norm_eps), cfg)
    return x1, cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_init(gen, cfg: ArchConfig, dtype, device=None):
    n_tables = max(cfg.n_codebooks, 1)
    p = {"tok": embedding_init(gen, cfg.vocab * n_tables, cfg.d_model, dtype,
                               device),
         "ln_f": rmsnorm_init(cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab * n_tables,
                               dtype=dtype, device=device)
    return p


def _codebook_ids(cfg: ArchConfig, tokens):
    """Codebook tokens [B, nq, ...] → rows of the stacked tables: codebook
    i reads table slice i."""
    nq = tokens.shape[1]
    offs = torch.arange(nq, dtype=tokens.dtype, device=tokens.device) \
        * cfg.vocab
    return tokens + offs.reshape((1, nq) + (1,) * (tokens.dim() - 2))


def _embed_tokens(p, cfg: ArchConfig, batch):
    """Tokens or stub-frontend embeddings → [B, S, d]."""
    if "embeds" in batch:
        x = batch["embeds"]
    elif cfg.n_codebooks:
        x = embed(p["tok"], _codebook_ids(cfg, batch["tokens"])).sum(1)
    else:
        x = embed(p["tok"], batch["tokens"])
    return shard(x, "batch", "sp" if cfg.seq_parallel else None, None)


def _logits(p, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        logits = x @ p["tok"]["table"].T
    else:
        logits = dense(p["head"], x)
    logits = shard(logits, "batch", None, "model")
    if cfg.n_codebooks:
        b, s, _ = logits.shape
        if active_mesh() is not None:
            # the codebook view splits the sharded vocabulary dim
            logits = shard(logits, "batch", None, None)
        logits = logits.reshape(b, s, cfg.n_codebooks, cfg.vocab)
    return logits


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


def _generator(seed: int, layer: int, device) -> Optional[torch.Generator]:
    """The generator of (seed, layer) on ``device``; ``None`` on the meta
    device, which has none (the init functions then draw nothing)."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, layer, _INIT_TAG))
    return gen


def _init_device(device) -> torch.device:
    """``resolve_device``, plus ``"meta"``: shapes and dtypes with nothing
    allocated (``launch/specs.py``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _hybrid_plan(cfg: ArchConfig):
    """zamba2: ``n_layers`` counts Mamba blocks and shared-block calls,
    in groups of ``attn_every`` Mamba blocks + 1 call.  Returns (Mamba
    blocks, groups)."""
    k = cfg.attn_every
    n_groups = cfg.n_layers // (k + 1)
    return n_groups * k, n_groups


def _stack_init(cfg: ArchConfig):
    """(init of one stacked layer, number of stacked layers)."""
    if cfg.family == "ssm":
        return rwkv6_block_init, cfg.n_layers
    if cfg.family == "hybrid":
        return mamba2_block_init, _hybrid_plan(cfg)[0]
    return block_init, cfg.n_layers


def init_part(cfg: ArchConfig, seed: int, part, *, device=None):
    """One part of ``model_init``'s tree, drawn as ``model_init`` draws
    it: stacked layer ``part`` (an int; that layer's leaves, unstacked),
    ``"embed"`` (the embedding, final norm and head) or the hybrid's
    ``"shared_attn"``.  A sharded init draws the model a part at a time,
    and a check can redraw any part without holding the model."""
    dev = _init_device(device)
    dtype = cfg.torch_dtype
    if part == "embed":
        return _embed_init(_generator(seed, _EMBED_LAYER, dev), cfg, dtype,
                           dev)
    if part == "shared_attn":
        return block_init(_generator(seed, _SHARED_LAYER, dev), cfg, dtype,
                          dev)
    init_one, _ = _stack_init(cfg)
    return init_one(_generator(seed, int(part), dev), cfg, dtype, dev)


def model_init(cfg: ArchConfig, seed: int, *, device=None, shardings=None):
    """Random params from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), drawn there: stacked layer l from a generator keyed
    on (seed, l), the hybrid's shared block from a key of its own.  Stacked
    banks are filled one layer at a time, so the peak is the params plus
    one layer.  The draws match neither the JAX package's threefry nor
    another device's; parity tests carry the reference's params with
    ``repro_torch.convert``.  ``device="meta"`` gives the tree's shapes and
    dtypes, nothing drawn or allocated.

    With ``shardings`` (a ``sharding.NamedSharding`` per leaf, e.g.
    ``launch.specs.param_shardings``) every part is drawn whole on
    ``device`` and only this rank's block of it kept: bitwise
    ``sharding.device_put(model_init(cfg, seed, device=device),
    shardings)``, at a peak of the rank's shards plus one part's draw."""
    dev = _init_device(device)
    if shardings is not None:
        return _sharded_init(cfg, seed, dev, shardings)
    params: Dict[str, Any] = {"embed": init_part(cfg, seed, "embed",
                                                 device=dev)}
    _, n_layers = _stack_init(cfg)
    leaves, treedef = tree_flatten(init_part(cfg, seed, 0, device=dev))
    if cfg.family == "hybrid":
        params["shared_attn"] = init_part(cfg, seed, "shared_attn",
                                          device=dev)
    if n_layers == 1:
        # the layer's leaves, viewed [1, ...]: one copy of a layer that may
        # be half the card (DeepSeek-V3's 23 GB)
        params["layers"] = tree_unflatten(treedef, [a[None] for a in leaves])
        return params
    stacked = [torch.empty((n_layers,) + tuple(a.shape), dtype=a.dtype,
                           device=dev) for a in leaves]
    # on the meta device every copy is a no-op: the shapes are all there is
    for layer in range(n_layers if dev.type != "meta" else 0):
        if layer:
            leaves = tree_flatten(init_part(cfg, seed, layer, device=dev))[0]
        for dst, src in zip(stacked, leaves):
            dst[layer].copy_(src)
        del leaves
    params["layers"] = tree_unflatten(treedef, stacked)
    return params


def _sharded_init(cfg: ArchConfig, seed: int, dev, shardings):
    """``model_init`` under ``shardings``: the embedding (and the hybrid's
    shared block) drawn whole and cut to this rank's blocks first, then
    the stacked layers' local blocks allocated and filled one drawn layer
    at a time (only the layers this rank holds a block of)."""
    params: Dict[str, Any] = {}
    for part in ("embed",) + (("shared_attn",) if cfg.family == "hybrid"
                              else ()):
        params[part] = tree_map(local_block,
                                init_part(cfg, seed, part, device=dev),
                                shardings[part])
    _, n_layers = _stack_init(cfg)
    metas, treedef = tree_flatten(init_part(cfg, seed, 0, device="meta"))
    blocks = []
    for meta, sh in zip(metas, tree_leaves(shardings["layers"])):
        shape = (n_layers,) + tuple(meta.shape)
        local_shape, offset = pert.local_layout(shape, sh.mesh,
                                                sh.placements)
        blocks.append((torch.empty(local_shape, dtype=meta.dtype,
                                   device=dev), offset, shape, sh))
    held = sorted({layer for buf, offset, _, _ in blocks
                   for layer in range(offset[0], offset[0] + buf.shape[0])})
    for layer in held:
        leaves = tree_flatten(init_part(cfg, seed, layer, device=dev))[0]
        for (buf, offset, _, _), leaf in zip(blocks, leaves):
            i = layer - offset[0]
            if 0 <= i < buf.shape[0]:
                buf[i].copy_(leaf[tuple(
                    slice(o, o + n) for o, n in zip(offset[1:],
                                                    buf.shape[1:]))])
        del leaves
    params["layers"] = tree_unflatten(treedef, [
        from_block(buf, sh, shape) for buf, _, shape, sh in blocks])
    return params


def _layer_params(layers, layer: int):
    return tree_map(lambda a: a[layer], layers)


def _stack_states(states):
    """Per-layer state dicts → one dict of tensors stacked on L (on a
    mesh each with its pending reductions done, so decode can write
    into it)."""
    return {key: torch.stack([settle(st[key]) for st in states])
            for key in states[0]}


def _ssm_forward(params, cfg: ArchConfig, x, state, return_state):
    states = []
    for layer in range(cfg.n_layers):
        st = (rwkv6_state_init(cfg, x.shape[0], device=x.device)
              if state is None else _layer_params(state, layer))
        x, st = rwkv6_block(_layer_params(params["layers"], layer), x, st,
                            cfg, chunk=cfg.la_chunk)
        if return_state:
            states.append(st)
        del st
    return x, _stack_states(states) if return_state else None


def _hybrid_forward(params, cfg: ArchConfig, x, positions, state,
                    return_state):
    """Mamba layer g·k + j for j < k, then the shared block, for each
    group g; the shared block keeps its K/V per group."""
    _, n_groups = _hybrid_plan(cfg)
    k = cfg.attn_every
    states, kvs = [], []
    for g in range(n_groups):
        for layer in range(g * k, (g + 1) * k):
            st = (mamba2_state_init(cfg, x.shape[0], device=x.device)
                  if state is None else _layer_params(state["mamba"], layer))
            x, st = mamba2_block(_layer_params(params["layers"], layer), x,
                                 st, cfg, chunk=cfg.la_chunk)
            if return_state:
                states.append(st)
            del st
        x, kv = block_apply(params["shared_attn"], x, positions, cfg)
        if return_state:
            kvs.append(kv)
        del kv
    if not return_state:
        return x, None
    return x, {"mamba": _stack_states(states),
               "attn_kv": tuple(torch.stack(parts) for parts in zip(*kvs))}


def model_forward(params, cfg: ArchConfig, batch, *, return_state=False,
                  state=None):
    """Full-sequence forward → logits [B, S, V].  With ``return_state``
    also what a decode continues from (the prefill path): the per-layer
    cache payloads stacked on L, (k, v) [L, B, S, KVH, dh], or for MLA
    (c_kv [L, B, S, r], k_rope [L, B, S, dr]); for ``ssm`` the RWKV-6
    states stacked on L; for ``hybrid`` ``{"mamba": the Mamba-2 states
    stacked on the blocks, "attn_kv": (k, v) [G, B, S, KVH, dh]}``.  A
    recurrent model starts from ``state`` (that structure; zeros when
    None)."""
    with mesh_ops():
        return _model_forward(params, cfg, batch, return_state, state)


def _model_forward(params, cfg: ArchConfig, batch, return_state, state):
    x = _embed_tokens(params["embed"], cfg, batch)
    b, s, _ = x.shape
    positions = _positions(cfg, batch, s, b, x.device)
    if cfg.family == "ssm":
        x, new_state = _ssm_forward(params, cfg, x, state, return_state)
    elif cfg.family == "hybrid":
        x, new_state = _hybrid_forward(params, cfg, x, positions, state,
                                       return_state)
    else:
        states = []
        for layer in range(cfg.n_layers):
            x, st = block_apply(_layer_params(params["layers"], layer), x,
                                positions, cfg)
            if return_state:
                states.append(st)
            del st
        new_state = (tuple(torch.stack(parts) for parts in zip(*states))
                     if return_state else None)
    x = rmsnorm(params["embed"]["ln_f"], x, cfg.norm_eps)
    logits = _logits(params["embed"], cfg, x)
    if return_state:
        return logits, new_state
    return logits


def _loss_from_logits(logits, labels):
    with tracing.span("lm.loss"):
        if is_dtensor(logits):
            nll = vocab_parallel_nll(logits, labels)
            labels = labels.long()
        else:
            logits = logits.float()
            labels = labels.long()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                labels.clamp(min=0)[..., None])[..., 0]
            nll = logz - gold
        mask = (labels >= 0).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def model_loss(params, cfg: ArchConfig, batch):
    """Token-mean softmax cross-entropy — MGD's scalar cost.  Under a
    mesh the cost is the plain replicated scalar (``full``): the one
    number every rank's update reads."""
    logits = model_forward(params, cfg, batch)
    with mesh_ops():
        return full(_loss_from_logits(logits, batch["labels"]))


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
    h, kvh = cfg.n_heads, cfg.kv_heads
    qs = tuple(_heads(q, h, cfg)
               for q in pdense(p["wq"], xs, ids["wq"], probe, layer=layer))
    ks = tuple(_heads(k, kvh, cfg)
               for k in pdense(p["wk"], xs, ids["wk"], probe, layer=layer))
    vs = tuple(_heads(v, kvh, cfg)
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
    ys = tuple(_attend(cfg, *_shard_heads(cfg, q, k, v))
               for q, k, v in zip(qs, ks, vs))
    return pdense(p["wo"], ys, ids["wo"], probe, layer=layer)


def _pglu_mlp(p, xs, ids, probe, layer):
    gs = pdense(p["gate"], xs, ids["gate"], probe, layer=layer)
    us = pdense(p["up"], xs, ids["up"], probe, layer=layer)
    hs = tuple(torch.nn.functional.silu(g.float()).to(x.dtype) * u
               for g, u, x in zip(gs, us, xs))
    return pdense(p["down"], hs, ids["down"], probe, layer=layer)


def _pblock_apply(p, xs, positions, cfg: ArchConfig, ids, probe, layer):
    seq_ax = "sp" if cfg.seq_parallel else None
    xn = prmsnorm(p["ln1"], xs, ids["ln1"], probe, layer=layer,
                  eps=cfg.norm_eps)
    att = _pattn_apply(p["attn"], xn, positions, cfg, ids["attn"], probe,
                       layer)
    xs = tuple(shard(x + a, "batch", seq_ax, None) for x, a in zip(xs, att))
    ys = _pglu_mlp(
        p["mlp"],
        prmsnorm(p["ln2"], xs, ids["ln2"], probe, layer=layer,
                 eps=cfg.norm_eps),
        ids["mlp"], probe, layer)
    return tuple(shard(x + y, "batch", seq_ax, None) for x, y in zip(xs, ys))


def model_forward_perturbed(params, cfg: ArchConfig, batch, probe):
    """Per-sign perturbed logits, θ̃ fused into the weight matmuls: a tuple
    with one logits tensor per ``probe.ctx.signs`` entry.

    Stub-frontend ``embeds`` enter every stream as they are: the
    reference forms the perturbed table there too and reads nothing of
    it (XLA drops the unread work), so the port does not form it.
    Codebook tokens gather their rows of the perturbed stacked table and
    sum them, per stream."""
    if not supports_fused_probe(cfg):
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family"
                         f"{' with MLA' if cfg.use_mla else ''}"
                         f"{' with MoE' if cfg.n_experts else ''} has no "
                         f"fused probe path (model_probe_costs "
                         f"materializes θ ± θ̃ for it)")
    ids = leaf_id_tree(params)
    emb, eids = params["embed"], ids["embed"]
    tables = None
    if cfg.tie_embeddings:
        # the head reads the whole perturbed table, so it is materialized
        tables = pleaf(emb["tok"]["table"], eids["tok"]["table"], probe)
    if "embeds" in batch:
        xs = tuple(batch["embeds"] for _ in probe.ctx.signs)
    else:
        tokens = batch["tokens"]
        if cfg.n_codebooks:
            tokens = _codebook_ids(cfg, tokens)
        if tables is not None:
            xs = tuple(embed({"table": t}, tokens) for t in tables)
        else:
            xs = pembed(emb["tok"], tokens, eids["tok"], probe)
        if cfg.n_codebooks:
            xs = tuple(x.sum(1) for x in xs)
    xs = tuple(shard(x, "batch", "sp" if cfg.seq_parallel else None, None)
               for x in xs)
    b, s, _ = xs[0].shape
    positions = _positions(cfg, batch, s, b, xs[0].device)
    for layer in range(cfg.n_layers):
        xs = _pblock_apply(_layer_params(params["layers"], layer), xs,
                           positions, cfg, ids["layers"], probe, layer)
    xs = prmsnorm(emb["ln_f"], xs, eids["ln_f"], probe, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = tuple(x @ t.T for x, t in zip(xs, tables))
    else:
        logits = pdense(emb["head"], xs, eids["head"], probe)
    logits = tuple(shard(lg, "batch", None, "model") for lg in logits)
    if cfg.n_codebooks:
        logits = tuple(lg.reshape(b, s, cfg.n_codebooks, cfg.vocab)
                       for lg in logits)
    return logits


def model_probe_costs(params, cfg: ArchConfig, batch, probe):
    """probe_fn for ``MGDConfig(fused=True)``: [n_signs] xent costs.

    Fused for dense GQA decoders.  MoE and MLA models materialize θ ± θ̃
    for each sign in the unfused optimizer's float order
    (``tree_add``/``tree_axpy``), one perturbed tree at a time and each
    formed in bounded chunks (``perturbations.perturbed_tree``), then take
    ``model_loss``; their update still runs in the window-update kernel.
    """
    if supports_fused_probe(cfg):
        with mesh_ops():
            logits = model_forward_perturbed(params, cfg, batch, probe)
            return torch.stack([full(_loss_from_logits(lg, batch["labels"]))
                                for lg in logits])
    costs = []
    for sign in probe.ctx.signs:
        p_s = pert.perturbed_tree(
            params, step=probe.step, seed=probe.seed,
            dtheta=probe.ctx.dtheta, tau_p=probe.ctx.tau_p, sign=sign)
        costs.append(model_loss(p_s, cfg, batch))
        del p_s
    return torch.stack(costs)


def make_transformer_probe_fn(cfg: ArchConfig):
    """Bind ``cfg`` → probe_fn(params, batch, probe) for build_mgd_step."""

    def probe_fn(params, batch, probe):
        return model_probe_costs(params, cfg, batch, probe)

    return probe_fn


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _cache_keys(cfg: ArchConfig):
    if cfg.family == "ssm":
        return ()
    return ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")


def _zero_states(state_init, cfg: ArchConfig, n: int, batch_size: int,
                 dev):
    """A recurrent state of ``n`` layers, zeros stacked on L."""
    return {key: torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                             device=dev)
            for key, t in state_init(cfg, batch_size, device="meta").items()}


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               device=None):
    """An empty cache on ``device`` (the card unless ``device="cpu"``),
    zeros: ``{"k", "v": [L, B, max_len, KVH, dh]}`` in the model's dtype,
    or for MLA ``{"c_kv": [L, B, max_len, r], "k_rope": [L, B, max_len,
    dr]}``; for ``ssm`` ``{"state"}`` (RWKV-6's, f32, stacked on L); for
    ``hybrid`` ``{"state"}`` (Mamba-2's, f32, stacked on the blocks) and
    ``{"k", "v": [G, B, max_len, KVH, dh]}``; with ``"length"``: a 0-d
    int32 host tensor.  ``device="meta"`` allocates nothing."""
    dev = _init_device(device)
    n_kv = cfg.n_layers
    cache = {}
    if cfg.family == "ssm":
        cache["state"] = _zero_states(rwkv6_state_init, cfg, cfg.n_layers,
                                      batch_size, dev)
    elif cfg.family == "hybrid":
        n_mamba, n_kv = _hybrid_plan(cfg)
        cache["state"] = _zero_states(mamba2_state_init, cfg, n_mamba,
                                      batch_size, dev)
    lead = (n_kv, batch_size, max_len)
    if cfg.use_mla:
        shapes = (lead + (cfg.kv_lora_rank,), lead + (cfg.qk_rope_head_dim,))
    else:
        shapes = (lead + (cfg.kv_heads, cfg.head_dim),) * 2
    for key, shape in zip(_cache_keys(cfg), shapes):
        cache[key] = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
    cache["length"] = torch.zeros((), dtype=torch.int32)
    return cache


def model_prefill(params, cfg: ArchConfig, batch, max_len: int):
    """Run the prompt (``tokens``, or stub-frontend ``embeds``); returns
    (full-seq logits, ready-to-decode cache) on the logits' device.  An
    ssm model's cache is its state alone, whatever ``max_len``.  Under a
    mesh the K/V cache is formed whole and placed (None, "batch",
    "kvseq") over the mesh."""
    with mesh_ops():
        return _model_prefill(params, cfg, batch, max_len)


def _model_prefill(params, cfg: ArchConfig, batch, max_len: int):
    logits, states = model_forward(params, cfg, batch, return_state=True)
    if "tokens" in batch:
        b, s = batch["tokens"].shape[0], batch["tokens"].shape[-1]
    else:
        b, s = batch["embeds"].shape[:2]
    length = torch.tensor(s, dtype=torch.int32)
    if cfg.family == "ssm":
        return logits, {"state": states, "length": length}
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    if active_mesh() is not None:
        # on a mesh: each K/V (or latent) cache whole, placed (None,
        # "batch", "kvseq"), its padding made shard by shard; the
        # hybrid's Mamba-2 states as the forward placed them
        cache = {}
        if cfg.family == "hybrid":
            cache["state"] = states["mamba"]
            states = states["attn_kv"]
        for key, state in zip(_cache_keys(cfg), states):
            cache[key] = shard(_pad_seq(state.to(cfg.torch_dtype), max_len),
                               None, "batch", "kvseq")
        cache["length"] = length
        return logits, cache
    cache = init_cache(cfg, b, max_len, device=logits.device)
    if cfg.family == "hybrid":
        cache["state"] = states["mamba"]
        states = states["attn_kv"]
    for key, state in zip(_cache_keys(cfg), states):
        cache[key][:, :, :s] = state.to(cache[key].dtype)
    cache["length"] = length
    return logits, cache


def _pad_seq(state, max_len: int):
    """A DTensor [L, B, S, ...] zero-padded along S to ``max_len``, the
    zeros made on each rank's shard only."""
    n_pad = max_len - state.shape[2]
    if not n_pad:
        return state
    from torch.distributed.tensor import zeros
    shape = tuple(state.shape[:2]) + (n_pad,) + tuple(state.shape[3:])
    pad = zeros(shape, dtype=state.dtype, device_mesh=state.device_mesh,
                placements=state.placements)
    return torch.cat([state, pad], dim=2)


def _write_state(stacked, layer: int, new) -> None:
    """Layer ``layer``'s new recurrent state into the stacked cache, in
    place (in the cache's dtype; laid out as the cache on a mesh)."""
    for key, t in new.items():
        copy_into(stacked[key][layer], t)


def _decode_recurrent(params, cfg: ArchConfig, x1, cache, pos, length):
    """One token through the ssm or hybrid stack, every layer's state (and
    the hybrid's K/V at ``length − 1``) written into ``cache`` in place."""
    st = cache["state"]
    if cfg.family == "ssm":
        for layer in range(cfg.n_layers):
            y, new = rwkv6_block_step(_layer_params(params["layers"], layer),
                                      x1[:, 0], _layer_params(st, layer),
                                      cfg)
            _write_state(st, layer, new)
            x1 = y[:, None, :]
        return x1
    _, n_groups = _hybrid_plan(cfg)
    k = cfg.attn_every
    for g in range(n_groups):
        for layer in range(g * k, (g + 1) * k):
            y, new = mamba2_block_step(_layer_params(params["layers"], layer),
                                       x1[:, 0], _layer_params(st, layer),
                                       cfg)
            _write_state(st, layer, new)
            x1 = y[:, None, :]
        x1, _ = block_decode(params["shared_attn"], x1, pos,
                             (cache["k"][g], cache["v"][g]), length, cfg)
    return x1


def model_decode(params, cfg: ArchConfig, tokens, cache, embeds=None):
    """One decode step.  tokens: [B] int ([B, nq] with codebooks), or
    stub-frontend ``embeds`` [B, 1, d].  Returns (logits [B, V] ([B, nq,
    V] with codebooks), cache): the cache is written in place (the
    caller's dict keeps its old ``length``; use the returned one)."""
    with mesh_ops():
        return _model_decode(params, cfg, tokens, cache, embeds)


def _model_decode(params, cfg: ArchConfig, tokens, cache, embeds):
    if embeds is not None:
        x1 = embeds
    elif cfg.n_codebooks:
        x1 = embed(params["embed"]["tok"],
                   _codebook_ids(cfg, tokens)).sum(1)[:, None, :]
    else:
        x1 = embed(params["embed"]["tok"], tokens)[:, None, :]
    b = x1.shape[0]
    keys = _cache_keys(cfg)
    length = int(cache["length"]) + 1
    if keys and length > cache[keys[0]].shape[2]:
        raise ValueError(f"cache full: decoding position {length - 1} of a "
                         f"cache of {cache[keys[0]].shape[2]}")
    pos = torch.full((b, 1), length - 1, dtype=torch.int32,
                     device=x1.device)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(b, 1, 3)
    if cfg.family in ("ssm", "hybrid"):
        x1 = _decode_recurrent(params, cfg, x1, cache, pos, length)
    else:
        for layer in range(cfg.n_layers):
            x1, _ = block_decode(_layer_params(params["layers"], layer), x1,
                                 pos, tuple(cache[key][layer]
                                            for key in keys), length, cfg)
    x1 = rmsnorm(params["embed"]["ln_f"], x1, cfg.norm_eps)
    logits = _logits(params["embed"], cfg, x1)[:, 0]
    new = {key: t for key, t in cache.items() if key != "length"}
    new["length"] = torch.tensor(length, dtype=torch.int32)
    return logits, new
