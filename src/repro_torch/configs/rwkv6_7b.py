"""rwkv6-7b — RWKV-6 "Finch" 7B [arXiv:2404.05892; hf].

32L, d_model 4096 (attention-free), d_ff 14336, vocab 65536; head size 64
→ 64 WKV heads.  Runs long_500k (O(1) recurrent state).
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,            # head_size 64
        d_ff=14336,
        vocab=65536,
        la_chunk=32,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128,
        dtype="float32", la_chunk=8,
    )
