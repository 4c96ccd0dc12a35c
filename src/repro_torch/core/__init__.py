"""MGD core: the discrete algorithm, perturbations, cost, pytree utilities."""
from .cost import mse
from .mgd import MGDConfig, MGDState, build_mgd_step, mgd_init
from . import noise, perturbations, utils

__all__ = ["MGDConfig", "MGDState", "build_mgd_step", "mgd_init", "mse",
           "noise", "perturbations", "utils"]
