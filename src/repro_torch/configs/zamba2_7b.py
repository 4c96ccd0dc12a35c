"""zamba2-7b — Zamba2 7B hybrid [arXiv:2411.15242; unverified].

81 "layers" = 54 Mamba-2 blocks + 27 invocations of a single SHARED
attention+MLP block (applied after every 2 mamba blocks; weights reused).
d_model 3584, attn 32H (kv=32, head_dim 112), d_ff 14336, vocab 32000,
ssm_state 64, ssm head_dim 64 (→ 112 SSD heads at expand 2).
Simplification noted in DESIGN.md: the per-invocation LoRA adapters on the
shared block are omitted.  Runs long_500k (SSM state is O(1); the shared
blocks' KV caches are sequence-sharded).
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,               # 54 mamba + 27 shared-attn invocations
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_head=112,
        d_ff=14336,
        vocab=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        attn_every=2,
        rope_theta=1e4,
        la_chunk=64,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=6,                # 4 mamba + 2 shared-attn invocations
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
        vocab=128, ssm_state=16, ssm_head_dim=16, attn_every=2,
        dtype="float32", la_chunk=8,
        attn_q_block=16, attn_kv_block=16,
    )
