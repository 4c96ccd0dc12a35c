"""qwen2-72b — Qwen2 72B [arXiv:2407.10671; hf].

80L, d_model 8192, 64H (GQA kv=8, head_dim 128), d_ff 29568, vocab 152064,
QKV bias.  FSDP weight sharding on.
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1e6,
        fsdp=True,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, dtype="float32", fsdp=False,
        attn_q_block=16, attn_kv_block=16,
    )
