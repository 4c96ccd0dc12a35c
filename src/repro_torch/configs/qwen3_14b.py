"""qwen3-14b — Qwen3 14B [hf:Qwen/Qwen3-14B family; hf].

40L, d_model 5120, 40H (GQA kv=8, head_dim 128), d_ff 17408, vocab 151936,
qk_norm (per-head RMSNorm on Q and K).
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=17408,
        vocab=151936,
        qk_norm=True,
        rope_theta=1e6,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, dtype="float32",
        attn_q_block=16, attn_kv_block=16,
    )
