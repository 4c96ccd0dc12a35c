"""llama4-scout-17b-a16e — Llama-4 Scout 17B-active/16-expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L, d_model 5120, 40H (GQA kv=8, head_dim 128), expert d_ff 8192, vocab
202048; MoE 16 experts top-1 + 1 shared expert.  Treated as full attention
(iRoPE global layers) → long_500k skipped.
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202048,
        n_experts=16,
        n_experts_active=1,
        n_shared_experts=1,
        moe_group_size=512,
        rope_theta=5e5,
        fsdp=True,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, n_experts=4, n_experts_active=1,
        n_shared_experts=1, moe_group_size=32, dtype="float32", fsdp=False,
        attn_q_block=16, attn_kv_block=16,
    )
