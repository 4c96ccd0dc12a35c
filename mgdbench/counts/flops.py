"""Model flops of a training step: a frozen copy of the port's
``launch/dryrun.py::model_flops`` for training shapes.

Each forward costs 2 flops a matmul parameter a token (every parameter
but the embedding table, which is a gather; norms and biases count too,
as the original counts them) plus causal attention, ≈ 2·2·S²/2 flops a
token pair and head dimension in each attention layer.  A central MGD
step runs two forwards; the perturbation and the update are not counted.
"""
from __future__ import annotations


def model_flops(n_params: int, n_embed: int, batch: int, seq: int, *,
                attn_layers: int = 0, d_attn: int = 0,
                n_forwards: int = 2) -> float:
    tokens = batch * seq
    flops = 2.0 * (n_params - n_embed) * tokens
    flops += attn_layers * batch * seq * seq * d_attn * 2.0
    return flops * n_forwards
