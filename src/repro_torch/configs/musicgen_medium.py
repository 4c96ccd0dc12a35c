"""musicgen-medium — MusicGen medium decoder [arXiv:2306.05284; hf].

48L, d_model 1536, 24H (MHA kv=24, head_dim 64), d_ff 6144, vocab 2048 per
EnCodec codebook (4 codebooks, delay pattern handled by the frontend stub).
The EnCodec frontend is a stub: a batch carries precomputed frame
embeddings (``embeds``) or codebook tokens [B, 4, S] (the sum of 4
codebook embeddings in, a 4×2048 head out, labels [B, S, 4]).
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_head=64,
        d_ff=6144,
        vocab=2048,
        n_codebooks=4,
        rope_theta=1e4,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=64, n_codebooks=4, dtype="float32",
        attn_q_block=16, attn_kv_block=16,
    )
