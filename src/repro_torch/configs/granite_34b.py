"""granite-34b — IBM Granite 34B Code [arXiv:2405.04324; hf].

88L, d_model 6144, 48H (MQA kv=1, head_dim 128), d_ff 24576, vocab 49152.
Llama-style architecture; deep-narrow, so FSDP weight sharding is on.
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab=49152,
        rope_theta=1e4,
        fsdp=True,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab=128, dtype="float32", fsdp=False,
        attn_q_block=16, attn_kv_block=16,
    )
