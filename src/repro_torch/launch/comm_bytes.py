"""Collective-byte accounting of the collectives DTensor issues.

The twin of the reference's ``launch/hlo_collectives.py``, which reads
the partitioned HLO text.  Here ``CollectiveBytes`` is a
``TorchDispatchMode``: it lets every DTensor op run (returning
``NotImplemented``, as ``CommDebugMode`` does), so the collectives that
DTensor desugars into reach it as ``c10d_functional`` (or ``c10d``) ops
on this rank's local tensors.  Python loops run every layer, so each
collective is seen as often as it runs: no loop multipliers.

Per-device wire bytes per collective, the reference's rules: the
result's bytes times ``TYPE_MULT`` — all-gather 1 (the gathered
result), reduce-scatter 1 (the scattered result), all-reduce 2 (RS +
AG), all-to-all 1, collective-permute 1 — the (n−1)/n ≈ 1 limit of ring
algorithms.  ``collective_bytes`` returns the reference's dict:
``total_bytes``, ``by_type`` and ``ops``.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.utils import is_dtensor, tensors_of

TYPE_MULT = {
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# op name (functional or c10d) → the reference's HLO collective type
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveBytes(TorchDispatchMode):
    """Counts this rank's collective wire bytes while active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor(a) for a in tensors_of((args, kwargs))):
            return NotImplemented          # let DTensor desugar first
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__ \
            if hasattr(func, "_overloadpacket") else str(func)
        kind = _KIND.get(name)
        if kind is not None:
            if func._overloadpacket.__name__.endswith("_"):
                # c10d in-place ops: the tensors they write are arg 0
                raw = sum(_nbytes(t) for t in tensors_of(args[0]))
            else:
                raw = sum(_nbytes(t) for t in tensors_of(out))
            self.ops.append({"op": kind, "bytes": raw, "mult": 1.0,
                             "comp": name})
        return out

    def result(self):
        by_type = defaultdict(float)
        total = 0.0
        for op in self.ops:
            wire = op["bytes"] * TYPE_MULT[op["op"]]
            by_type[op["op"]] += wire
            total += wire
        return {"total_bytes": total, "by_type": dict(by_type),
                "ops": list(self.ops)}


def collective_bytes(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, the collective-bytes dict of that
    call)."""
    with CollectiveBytes() as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
