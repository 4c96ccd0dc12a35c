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

The decoders of every family (dense GQA such as Qwen3-14B, the qwen2-vl
and musicgen backbones, MoE, MLA, RWKV-6 and the Mamba-2 hybrid: every
id in ``configs.PORTED``) train the same way at full width::

    cfg = rt.get_config("qwen3-14b")
    params = rt.model_init(cfg.replace(n_layers=4), seed=0)
    mgd = rt.driver("discrete", rt.DriverConfig(dtheta=1e-2, eta=1e-2,
                                                mode="central", fused=True),
                    lambda p, b: rt.model_loss(p, cfg, b),
                    probe_fn=rt.make_transformer_probe_fn(cfg))
    sample = rt.lm_sampler(8, 64, cfg.vocab, seed=0)

The paper's Table 2 CNNs train the same way on the Fashion-MNIST /
CIFAR-10 stand-ins, beside the backprop baseline::

    params = rt.fashion_cnn_init(0)
    sample = rt.generator_sampler(rt.tasks.fashion_batch, 64, seed=3)
    loss = lambda p, b: rt.mse(rt.fashion_cnn_apply(p, b["x"]), b["y"])
    mgd = rt.driver("discrete", rt.DriverConfig(dtheta=1e-3, eta=1e-4,
                                                seed=1), loss)
    res = rt.train_backprop(loss, params, sample, 400, eta=0.02)

Probe parallelism runs k pods, each probing its own perturbation on its
own share of the batch, one after another on the card; a chip farm fans
the same k probes out to k external chips behind a host boundary::

    mgd = rt.driver("probe_parallel", rt.DriverConfig(dtheta=1e-2, eta=0.1,
                                                      mode="central",
                                                      fused=True),
                    loss_fn, probe_fn=rt.make_mlp_probe_fn(),
                    mesh=rt.LocalMesh(pod=4))
    farm = rt.hardware.simulated_chip_farm(4, (49, 4, 4), backend="thread")
    ext = rt.driver("probe_parallel_external",
                    rt.DriverConfig(dtheta=1e-2, eta=0.1, mode="central"),
                    plant=farm)

Serving: ``greedy_generate`` prefills a KV cache and decodes from it
(``repro_torch.serving``), and ``serve`` stands up the online service,
which answers requests from a fixed-slot dispatcher while a background
MGD trimmer re-trims the served weights from request feedback::

    svc = rt.serve(rt.ServiceConfig(slots=8), predict_fn, params,
                   trim=rt.TrimConfig(rt.DriverConfig(...), loss_fn))
    result = svc.serve({"x": x}, feedback={"y": y})

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
from .api import (ALGORITHMS, DriverConfig, MGDDriver, ProbeParallelState,
                  driver, make_epoch, register_driver, replace_step,
                  state_step)
from .core import (AnalogMGDConfig, AnalogMGDState, LocalMesh, MGDConfig,
                   MGDState, build_mgd_step, mgd_init, mse)
from . import hardware
from .configs import get_config, get_smoke_config
from .data import dataset_sampler, generator_sampler, lm_sampler, tasks
from .models import (ArchConfig, cifar_cnn_apply, cifar_cnn_init, cnn_apply,
                     cnn_init, fashion_cnn_apply, fashion_cnn_init,
                     linear_apply, make_mlp_probe_fn,
                     make_transformer_probe_fn, mlp_apply,
                     mlp_apply_perturbed, mlp_init, init_cache,
                     model_decode, model_forward, model_forward_perturbed,
                     model_init, model_loss, model_prefill,
                     model_probe_costs, supports_fused_probe)
from .optim import sgd_init, sgd_step
from .training import (TrainLoopConfig, TrainResult, classification_accuracy,
                       train_backprop, train_mgd)

train = train_mgd

# the serving tier resolves lazily: importing repro_torch does not load it
_LAZY = {"serve", "OnlineService", "ServiceConfig", "TrimConfig"}

__all__ = [
    "ALGORITHMS", "DriverConfig", "MGDDriver", "ProbeParallelState",
    "LocalMesh", "driver", "make_epoch", "hardware",
    "register_driver", "replace_step", "state_step",
    "MGDConfig", "MGDState", "build_mgd_step", "mgd_init", "mse",
    "AnalogMGDConfig", "AnalogMGDState",
    "mlp_init", "mlp_apply", "mlp_apply_perturbed", "make_mlp_probe_fn",
    "linear_apply", "cnn_init", "cnn_apply", "fashion_cnn_init",
    "fashion_cnn_apply", "cifar_cnn_init", "cifar_cnn_apply",
    "ArchConfig", "get_config", "get_smoke_config", "model_init",
    "model_forward", "model_loss", "model_forward_perturbed",
    "init_cache", "model_prefill", "model_decode",
    "model_probe_costs", "make_transformer_probe_fn", "supports_fused_probe",
    "tasks", "dataset_sampler", "generator_sampler", "lm_sampler",
    "sgd_init", "sgd_step",
    "TrainLoopConfig", "TrainResult", "train", "train_mgd", "train_backprop",
    "classification_accuracy",
] + sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.serving import online
        return getattr(online, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
