"""Logical cost of a step, read from the ATen ops it runs.

The twin of the reference's ``launch/jaxpr_cost.py`` (which walks a
jaxpr).  ``OpCost`` is a ``TorchDispatchMode`` over the real or fake
(``FakeTensorMode``) step.  On a DTensor op it reads the op's GLOBAL
shapes and then lets DTensor run (returning ``NotImplemented``), so the
count is global and logical — pre-partitioning, all ranks — whatever
the mesh; the local ops DTensor runs for it are not counted again.  On
a run without DTensors (one device) every op is read as it is.

Accounting, the reference's:

* flops: matmuls (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and
  convolutions, by ``torch.utils.flop_counter``'s formulas (2·M·N·K per
  product).  Elementwise ops and reductions are ignored (≪ matmul terms
  at LM scale).
* bytes: for every matmul and convolution, operand + result bytes (a
  streaming roofline estimate of HBM traffic); for gathers and scatters
  (embedding lookups, index/gather/scatter ops) the result bytes only.
  Treat as a ±2× estimate.
* Python loops run every layer and attention block, so nothing is
  counted once for many trips: ``unknown_while`` is always 0.  A cache
  update of one decode token is an in-place write on the local shard
  (``sharding.write_at``) and is not counted, where the reference's
  ``dynamic_update_slice`` counts its whole result.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.utils import is_dtensor, tensors_of
from repro_torch.distributed.sharding import local_work_scale

aten = torch.ops.aten

_MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
_CONV = {aten.convolution, aten._convolution, aten.convolution_overrideable}
# result bytes only: lookups, gathers, scatters
_GATHER = {aten.embedding, aten.index, aten.gather, aten.index_select,
           aten.take, aten.scatter, aten.scatter_add, aten.index_put,
           aten.index_put_, aten.index_copy, aten.slice_scatter,
           aten.select_scatter}


def _nbytes(t) -> int:
    return math.prod(t.shape) * t.element_size()


def _matmul_out_shape(func, args):
    a, b = (args[1], args[2]) if func in (aten.addmm, aten.baddbmm) \
        else (args[0], args[1])
    return tuple(a.shape[:-1]) + (b.shape[-1],), a


def _global_out(func, args, kwargs):
    """The op's result on meta tensors of the args' global shapes."""
    def meta(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
        if isinstance(x, (list, tuple)):
            return type(x)(meta(y) for y in x)
        return x
    return func(*meta(tuple(args)), **{k: meta(v) for k, v in kwargs.items()})


class OpCost(TorchDispatchMode):
    """Counts flops and streaming bytes of the ops run while active.

    ``sharded=True`` (a run on DTensors): DTensor ops are read at their
    global shapes; plain-tensor ops are the local work DTensor issues for
    them (or host-side scalars) and are not counted again — except the
    work of ``sharding.per_shard`` regions (attention on its (batch,
    head) shards), counted once for each distinct block.
    """

    def __init__(self, sharded: bool = False):
        super().__init__()
        self.sharded = sharded
        self.flops = 0
        self.bytes = 0

    def _count(self, packet, args, kwargs, out):
        if packet in _MATMUL:
            shape, a = _matmul_out_shape(packet, args)
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
            self.bytes += sum(_nbytes(x) for x in args
                              if isinstance(x, torch.Tensor))
            self.bytes += math.prod(shape) * a.element_size()
        elif packet in _CONV:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
            self.bytes += sum(_nbytes(x) for x in args
                              if isinstance(x, torch.Tensor))
            self.bytes += _nbytes(out)
        elif packet in _GATHER:
            outs = out if isinstance(out, (list, tuple)) else [out]
            self.bytes += sum(_nbytes(x) for x in outs
                              if isinstance(x, torch.Tensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = getattr(func, "_overloadpacket", None)
        if any(is_dtensor(a) for a in tensors_of((args, kwargs))):
            if packet in _CONV:
                raise NotImplementedError(
                    "op_cost counts no convolution on DTensors (no model "
                    "of the dense family has one)")
            if packet in _MATMUL or packet in _GATHER:
                self._count(packet, args, kwargs,
                            _global_out(func, args, kwargs)
                            if packet in _GATHER else None)
            return NotImplemented     # DTensor runs it; its local ops
            #                           come back here and are skipped
        out = func(*args, **kwargs)
        if packet in _MATMUL or packet in _CONV or packet in _GATHER:
            scale = local_work_scale()
            if not self.sharded:
                self._count(packet, args, kwargs, out)
            elif scale:
                # local work standing for ``scale`` blocks of a global op
                # (attention per (batch, head) shard)
                f, b = self.flops, self.bytes
                self._count(packet, args, kwargs, out)
                self.flops = f + (self.flops - f) * scale
                self.bytes = b + (self.bytes - b) * scale
        return out

    def result(self) -> Dict[str, Any]:
        return {"flops": int(self.flops), "bytes": int(self.bytes),
                "unknown_while": 0}


def op_cost(fn, *args, sharded: bool = False, **kwargs):
    """(``fn(*args, **kwargs)``, its cost dict: ``flops``, ``bytes``,
    ``unknown_while``)."""
    with OpCost(sharded=sharded) as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
