"""repro_torch — multiplexed gradient descent in PyTorch on an NVIDIA H100.

The PyTorch/CUDA port of the JAX package ``repro``, which stays the
reference.  Same front door:

    import repro_torch as rt
    params = rt.mlp_init(1, (49, 4, 4))                   # on the card
    mgd = rt.driver("discrete",
                    rt.DriverConfig(dtheta=1e-2, eta=0.1, mode="central",
                                    fused=True),
                    loss_fn, probe_fn=rt.make_mlp_probe_fn())
    state = mgd.init(params)
    params, state, aux = mgd.step(params, state, batch)

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The fused path's three kernels (perturbed matmul,
its antithetic pair, the window update) are CUDA C++ for sm_90a under
``kernels/csrc``, built with nvcc on first use; on CPU tensors their
plain PyTorch versions run instead.
"""
from .api import (ALGORITHMS, DriverConfig, MGDDriver, driver, make_epoch,
                  state_step)
from .core import MGDConfig, MGDState, build_mgd_step, mgd_init, mse
from .models import make_mlp_probe_fn, mlp_apply, mlp_apply_perturbed, mlp_init
from .training import TrainLoopConfig, TrainResult, train_mgd

__all__ = [
    "ALGORITHMS", "DriverConfig", "MGDDriver", "driver", "make_epoch",
    "state_step",
    "MGDConfig", "MGDState", "build_mgd_step", "mgd_init", "mse",
    "mlp_init", "mlp_apply", "mlp_apply_perturbed", "make_mlp_probe_fn",
    "TrainLoopConfig", "TrainResult", "train_mgd",
]
