"""Models: the paper's sigmoid MLPs and CNNs, and the decoders of every
family (dense GQA, VLM, audio, MoE, MLA, RWKV-6, the Mamba-2 hybrid).
The building blocks live where the reference keeps them: ``models.moe``,
``models.mla``, ``models.rwkv6``, ``models.mamba2`` and
``models.linear_attention``."""
from .config import ArchConfig
from .simple import (cifar_cnn_apply, cifar_cnn_init, cnn_apply, cnn_init,
                     fashion_cnn_apply, fashion_cnn_init, linear_apply,
                     make_mlp_probe_fn, mlp_apply, mlp_apply_perturbed,
                     mlp_init)
from .transformer import (init_cache, make_transformer_probe_fn, model_decode,
                          model_forward, model_forward_perturbed, model_init,
                          model_loss, model_prefill, model_probe_costs,
                          supports_fused_probe)

__all__ = [
    "mlp_init", "mlp_apply", "mlp_apply_perturbed", "make_mlp_probe_fn",
    "linear_apply", "cnn_init", "cnn_apply", "fashion_cnn_init",
    "fashion_cnn_apply", "cifar_cnn_init", "cifar_cnn_apply",
    "ArchConfig", "model_init", "model_forward", "model_loss",
    "model_prefill", "model_decode", "init_cache",
    "model_forward_perturbed", "model_probe_costs",
    "make_transformer_probe_fn", "supports_fused_probe",
]
