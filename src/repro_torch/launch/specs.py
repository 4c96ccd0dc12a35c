"""Shapes with no allocation: the parameter tree and the input specs of
every (arch × shape) cell, as tensors on the ``meta`` device.

The twin of the reference's ``launch/specs.py``.  Its ``jax.eval_shape``
becomes ``model_init``/``init_cache`` on the meta device, which draws and
allocates nothing, so DeepSeek-V3's 704 G parameters count in under a
second.  The sharding functions place trees on a device mesh, which is
not ported (ROADMAP A15): they raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.core.utils import tree_map
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
    device."""
    if mesh is not None:
        _no_mesh("decode_input_specs(mesh=...)")
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


def _no_mesh(name: str):
    raise NotImplementedError(
        f"{name} places tensors on a device mesh, which is not ported to "
        "repro_torch yet (ROADMAP A15, distribution)")


def param_rules(cfg: ArchConfig):
    """Mesh sharding rules: not ported (ROADMAP A15)."""
    _no_mesh("param_rules")


def param_shardings(cfg: ArchConfig, mesh):
    """Mesh placement of the params: not ported (ROADMAP A15)."""
    _no_mesh("param_shardings")


def batch_shardings(batch_specs, mesh):
    """Mesh placement of a batch: not ported (ROADMAP A15)."""
    _no_mesh("batch_shardings")


def cache_shardings(cfg: ArchConfig, cache_specs, mesh):
    """Mesh placement of a decode cache: not ported (ROADMAP A15)."""
    _no_mesh("cache_shardings")
