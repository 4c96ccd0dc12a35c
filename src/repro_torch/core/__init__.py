"""MGD core: the discrete and analog algorithms, probe parallelism,
perturbations, cost, counter-keyed randomness and pytree utilities."""
from .analog import (AnalogMGDConfig, AnalogMGDState, analog_init,
                     build_analog_step)
from .cost import COSTS, mae, mse, softmax_xent
from .mgd import (MGDConfig, MGDState, build_mgd_step, make_mgd_epoch,
                  mgd_init)
from .probe_parallel import (LocalMesh, build_probe_parallel_external_step,
                             build_probe_parallel_step, pod_seed)
from . import (forward_grad, noise, perturbations, probe_parallel, rng,
               utils)

__all__ = ["AnalogMGDConfig", "AnalogMGDState", "analog_init",
           "build_analog_step", "MGDConfig", "MGDState", "build_mgd_step",
           "make_mgd_epoch", "mgd_init", "mae", "mse", "softmax_xent",
           "COSTS", "forward_grad", "noise", "perturbations", "rng", "utils", "LocalMesh", "pod_seed",
           "build_probe_parallel_step", "build_probe_parallel_external_step",
           "probe_parallel"]
