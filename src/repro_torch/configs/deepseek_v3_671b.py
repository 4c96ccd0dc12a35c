"""deepseek-v3-671b — DeepSeek-V3 [arXiv:2412.19437; hf].

61L, d_model 7168, 128H MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), vocab 129280; MoE: 1 shared + 256 routed experts, top-8, expert
d_ff 2048.  Simplifications, as in the JAX package: softmax top-k routing
(no aux-loss-free bias term) and no MTP head; MGD trains the router with
the same scalar feedback as every other parameter.
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        d_ff=2048,                 # routed-expert inner dim
        vocab=129280,
        n_experts=256,
        n_experts_active=8,
        n_shared_experts=1,
        moe_group_size=128,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=1e4,
        fsdp=True,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, d_ff=64, vocab=128,
        n_experts=8, n_experts_active=2, n_shared_experts=1,
        moe_group_size=32,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, dtype="float32", fsdp=False,
        attn_q_block=16, attn_kv_block=16,
    )
