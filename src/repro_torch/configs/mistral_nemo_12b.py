"""mistral-nemo-12b — Mistral-Nemo-Base-2407 [hf:mistralai; hf].

40L, d_model 5120, 32H (GQA kv=8, head_dim 128), d_ff 14336, vocab 131072,
128k context (rope_theta 1e6).  long_500k skipped: full attention.
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=131072,
        rope_theta=1e6,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, dtype="float32",
        attn_q_block=16, attn_kv_block=16,
    )
