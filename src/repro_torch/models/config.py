"""ArchConfig — one frozen dataclass describing every supported family.

The JAX package's ``repro.models.config.ArchConfig``, field for field;
``torch_dtype`` takes the place of its ``jdtype``.  The port runs every
family below.  ``fsdp`` and ``seq_parallel`` only place tensors on a
mesh, so on the port's one card they change no value, as in the
reference on a one-device mesh.  ``la_chunk`` is read only by the
linear-attention families (ssm, hybrid); ``scan_layers`` changes no
value, and the port always loops over layers.

Families:
    dense   — GQA decoder transformer (mistral-nemo, qwen3, granite, qwen2)
    moe     — dense attention (or MLA) + mixture-of-experts MLP
    ssm     — RWKV-6 (attention-free)
    hybrid  — Mamba-2 backbone + shared attention block (zamba2)
    vlm     — dense backbone + M-RoPE + stubbed patch-embedding frontend
    audio   — dense backbone over EnCodec codebook tokens (stub frontend)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0             # 0 → = n_heads
    d_head: int = 0                 # 0 → d_model // n_heads
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    moe_group_size: int = 256
    moe_capacity_factor: float = 1.25
    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0             # zamba2: shared attn after every k mamba
    # audio
    n_codebooks: int = 0            # musicgen EnCodec codebooks
    # numerics / execution
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    attn_q_block: int = 512
    attn_kv_block: int = 512
    attn_impl: str = "masked"       # masked | balanced
    la_chunk: int = 32              # linear-attention chunk length
    fsdp: bool = False              # shard weights on the DP axis too
    seq_parallel: bool = False      # Megatron-SP residual sharding
    scan_layers: bool = True
    # embedding tying
    tie_embeddings: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
