"""The implicit device of an ``MGDConfig``.

Only the ideal device is ported: the noisy, quantized and drifting plants
(σ_C readout noise, σ_θ write noise, DAC/ADC rounding, aging) remain in
the JAX package's ``repro.hardware.plants`` until ROADMAP item A8.
"""
from __future__ import annotations

from .base import IdealPlant, Plant


def plant_from_config(loss_fn, cfg, *, probe_fn=None) -> Plant:
    """``IdealPlant`` for a noise-free config; σ_C or σ_θ > 0 raise."""
    if getattr(cfg, "cost_noise", 0.0) or getattr(cfg, "update_noise", 0.0):
        raise NotImplementedError(
            "cost_noise/update_noise need the noisy plant, which is not "
            "ported to repro_torch yet (ROADMAP A8); use the JAX package "
            "or set both to 0")
    return IdealPlant(loss_fn, probe_fn=probe_fn)
