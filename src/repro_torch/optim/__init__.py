"""First-order baseline optimizers (the paper's comparison axis)."""
from .sgd import sgd_init, sgd_step

__all__ = ["sgd_init", "sgd_step"]
