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

The dense GQA transformer (Qwen3-14B at full width) trains the same way::

    cfg = rt.get_config("qwen3-14b")
    params = rt.model_init(cfg.replace(n_layers=4), seed=0)
    mgd = rt.driver("discrete", rt.DriverConfig(dtheta=1e-2, eta=1e-2,
                                                mode="central", fused=True),
                    lambda p, b: rt.model_loss(p, cfg, b),
                    probe_fn=rt.make_transformer_probe_fn(cfg))
    sample = rt.lm_sampler(8, 64, cfg.vocab, seed=0)

Imperfect devices (``hardware``: noisy, quantized and drifting plants
with the reference's counter-keyed threefry noise), Algorithm 2
(``driver("analog", ...)``) and checkpoint/resume with scheduled
recalibration (``TrainLoopConfig(checkpoint_dir=..., recal_every=...)``)
compose with both.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The fused path's kernels (perturbed matmul, its
antithetic pair, the window update) and the ``kernels.ops.mgd_update``
entry point's kernel are CUDA C++ for sm_90a under ``kernels/csrc``,
built with nvcc on first use; on CPU tensors their plain PyTorch versions
run instead.
"""
from .api import (ALGORITHMS, DriverConfig, MGDDriver, driver, make_epoch,
                  state_step)
from .core import (AnalogMGDConfig, AnalogMGDState, MGDConfig, MGDState,
                   build_mgd_step, mgd_init, mse)
from .configs import get_config, get_smoke_config
from .data import lm_sampler
from .models import (ArchConfig, make_mlp_probe_fn, make_transformer_probe_fn,
                     mlp_apply, mlp_apply_perturbed, mlp_init, model_forward,
                     model_forward_perturbed, model_init, model_loss,
                     model_probe_costs, supports_fused_probe)
from .training import TrainLoopConfig, TrainResult, train_mgd

__all__ = [
    "ALGORITHMS", "DriverConfig", "MGDDriver", "driver", "make_epoch",
    "state_step",
    "MGDConfig", "MGDState", "build_mgd_step", "mgd_init", "mse",
    "AnalogMGDConfig", "AnalogMGDState",
    "mlp_init", "mlp_apply", "mlp_apply_perturbed", "make_mlp_probe_fn",
    "ArchConfig", "get_config", "get_smoke_config", "model_init",
    "model_forward", "model_loss", "model_forward_perturbed",
    "model_probe_costs", "make_transformer_probe_fn", "supports_fused_probe",
    "lm_sampler",
    "TrainLoopConfig", "TrainResult", "train_mgd",
]
