"""Models: dense layers and the paper's sigmoid MLPs."""
from .simple import make_mlp_probe_fn, mlp_apply, mlp_apply_perturbed, mlp_init

__all__ = ["mlp_init", "mlp_apply", "mlp_apply_perturbed",
           "make_mlp_probe_fn"]
