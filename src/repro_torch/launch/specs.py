"""Shapes with no allocation: the parameter tree and the input specs of
every (arch × shape) cell, as tensors on the ``meta`` device.

The twin of the reference's ``launch/specs.py``.  Its ``jax.eval_shape``
becomes ``model_init``/``init_cache`` on the meta device, which draws and
allocates nothing, so DeepSeek-V3's 704 G parameters count in under a
second.  ``param_rules`` is the single ordered rule table translating
parameter-tree paths to logical axis names (right-aligned; see
``distributed/sharding.py``); the ``*_shardings`` functions give a
``sharding.NamedSharding`` per leaf, which ``sharding.device_put`` places
on a ``torch.distributed`` DeviceMesh.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.core.utils import (path_str, tree_flatten, tree_map,
                                    tree_paths, tree_unflatten)
from repro_torch.distributed import sharding as shd
from repro_torch.models import ArchConfig, init_cache, model_init

META = torch.device("meta")


def abstract_params(cfg: ArchConfig):
    """The parameter tree of ``cfg`` on the meta device: the reference's
    leaf paths, shapes and dtypes, nothing allocated."""
    return model_init(cfg, 0, device=META)


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    b, s = shape.global_batch, shape.seq_len
    if cfg.family in ("vlm", "audio"):
        batch = {"embeds": _spec((b, s, cfg.d_model), cfg.torch_dtype)}
        if cfg.n_codebooks:
            batch["labels"] = _spec((b, s, cfg.n_codebooks), torch.int32)
        else:
            batch["labels"] = _spec((b, s), torch.int32)
        if cfg.mrope_sections:
            batch["positions"] = _spec((b, s, 3), torch.int32)
        return batch
    return {"tokens": _spec((b, s), torch.int32),
            "labels": _spec((b, s), torch.int32)}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    batch = train_input_specs(cfg, shape)
    batch.pop("labels", None)
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh=None):
    """(token inputs, the cache at the shape's seq_len), on the meta
    device.  The shapes do not depend on ``mesh``; its placements are
    ``cache_shardings``'s."""
    b, s = shape.global_batch, shape.seq_len
    cache = tree_map(lambda t: t.to(META),
                     init_cache(cfg, b, s, device=META))
    if cfg.family in ("vlm", "audio"):
        tok = {"embeds": _spec((b, 1, cfg.d_model), cfg.torch_dtype)}
    elif cfg.n_codebooks:
        tok = {"tokens": _spec((b, cfg.n_codebooks), torch.int32)}
    else:
        tok = {"tokens": _spec((b,), torch.int32)}
    return tok, cache


# Ordered: first match wins.  "fsdp" resolves to nothing unless cfg.fsdp.
def param_rules(cfg: ArchConfig):
    fsdp = "fsdp" if cfg.fsdp else None
    rules = [
        # embeddings / head
        (r"embed/tok/table$", ("model", None)),          # vocab-sharded
        (r"embed/head/w$", (fsdp, "model")),
        # MoE
        (r"moe/router/w$", (None, "expert")),
        (r"moe/shared/(gate|up)/w$", (fsdp, "model")),
        (r"moe/shared/down/w$", ("model", fsdp)),
        (r"moe/(gate|up)$", ("expert", fsdp, None)),     # [E, d, f] banks
        (r"moe/down$", ("expert", None, fsdp)),          # [E, f, d]
        # dense MLP
        (r"mlp/(gate|up)/w$", (fsdp, "model")),
        (r"mlp/down/w$", ("model", fsdp)),
        # rwkv6 channel-mix (before the generic wk/wv rules)
        (r"ffn/wk/w$", (fsdp, "model")),
        (r"ffn/wv/w$", ("model", fsdp)),
        (r"ffn/wr/w$", (fsdp, "model")),
        # attention / rwkv time-mix / MLA projections
        (r"(wq|wk|wv|wg|wr|wq_b|wkv_b)/w$", (fsdp, "model")),
        (r"(wq_a|wkv_a|in_proj)/w$", (fsdp, "model")),
        (r"(wo|out_proj)/w$", ("model", fsdp)),
        (r"(wq|wk|wv|in_proj)/b$", ("model",)),
        # rwkv decay LoRA / bonus
        (r"w_lora_a$", (fsdp, None)),
        (r"w_lora_b$", (None, "model")),
        (r"att/u$", ("model", None)),
        (r"att/w0$", ("model",)),
        # mamba2 scalars / conv
        (r"(a_log|d_skip|dt_bias)$", ("model",)),
        (r"conv_w$", (None, "model")),
        (r"conv_b$", ("model",)),
        (r"norm_gate/scale$", ("model",)),
    ]
    return [(pat, names) for pat, names in rules]


def param_shardings(cfg: ArchConfig, mesh):
    """A ``NamedSharding`` per parameter leaf under ``param_rules``."""
    return shd.named_shardings(abstract_params(cfg), param_rules(cfg), mesh)


def batch_shardings(batch_specs, mesh):
    """``NamedSharding``s for a train/prefill batch: leading dim →
    "batch"."""
    return tree_map(lambda x: shd.NamedSharding(
        mesh, shd.logical_spec(tuple(x.shape), ["batch"], mesh)),
        batch_specs)


def cache_shardings(cfg: ArchConfig, cache_specs, mesh):
    """``NamedSharding``s for a decode cache.

    KV caches: [L, B, S, KVH, D] → (None, batch, kvseq, ...); SSM
    states: [L, B, H, ...] → (None, batch, model, ...); scalars replicated.
    The logical translator drops non-dividing/duplicate axes (B=1 long-
    context → sequence-sharded cache).
    """

    def one(path, x):
        pstr = path_str(path)
        shape = tuple(x.shape)
        if x.dim() == 0:
            spec = shd.P()
        elif pstr.endswith(("wkv", "ssd")) and x.dim() >= 4:
            spec = shd.logical_spec(shape, [None, "batch", "model"], mesh)
        elif pstr.endswith(("k", "v", "c_kv", "k_rope")) and x.dim() >= 3:
            spec = shd.logical_spec(shape, [None, "batch", "kvseq"], mesh)
        elif x.dim() >= 2:
            spec = shd.logical_spec(shape, [None, "batch"], mesh)
        else:
            spec = shd.P()
        return shd.NamedSharding(mesh, spec)

    _, treedef = tree_flatten(cache_specs)
    return tree_unflatten(treedef, [one(p, x) for p, x
                                    in tree_paths(cache_specs)])
