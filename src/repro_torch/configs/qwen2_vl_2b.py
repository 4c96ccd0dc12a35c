"""qwen2-vl-2b — Qwen2-VL 2B backbone [arXiv:2409.12191; hf].

28L, d_model 1536, 12H (GQA kv=2, head_dim 128), d_ff 8960, vocab 151936.
M-RoPE sections (16, 24, 24) over the 64-dim rotary half.  The vision
frontend is a stub: a batch carries patch embeddings (``embeds`` [B, S,
d_model]) plus 3-D position ids (``positions`` [B, S, 3]).
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_head=128,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        rope_theta=1e6,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, mrope_sections=(2, 3, 3), dtype="float32",
        attn_q_block=16, attn_kv_block=16,
    )
