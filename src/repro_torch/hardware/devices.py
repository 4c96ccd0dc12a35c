"""Concrete device builders: defective sigmoid MLPs behind noisy or
quantized plants (paper §3.5, Fig. 10).

Device-to-device variation is keyed off one ``device_seed``: two plants
built with different seeds are two different physical chips (activation
defects, write and readout noise streams), and one seed is the same chip
across restarts and in both packages (``core.rng`` draws the reference's
threefry values).  The numpy chips of the reference's
``repro.hardware.devices`` belong with the host boundary (ROADMAP A12).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.cost import mse
from repro_torch.core.noise import sample_defects
from repro_torch.device import resolve_device
from repro_torch.models.simple import make_mlp_probe_fn, mlp_apply

from .base import IdealPlant, Plant, PlantMeta
from .plants import NoisyPlant, QuantizedPlant


def mlp_device_fns(sizes: Sequence[int], *, sigma_a: float = 0.0,
                   device_seed: int = 0, cost=mse, device=None):
    """(loss_fn, probe_fn, defects) for a sigmoidal MLP with per-neuron
    fabrication defects sampled from ``device_seed`` (σ_a = 0 → exact
    sigmoid and defects=None).  ``device`` is where the defect tensors
    live: the CUDA card unless the caller passes ``device="cpu"``."""
    if sigma_a:
        dev = resolve_device(device)
        defects = [sample_defects(device_seed + i, n, sigma_a, device=dev)
                   for i, n in enumerate(sizes[1:])]
    else:
        defects = None

    def loss_fn(params, batch):
        return cost(mlp_apply(params, batch["x"], defects=defects),
                    batch["y"])

    return loss_fn, make_mlp_probe_fn(defects), defects


def noisy_mlp_plant(sizes: Sequence[int], *, sigma_c: float = 0.0,
                    sigma_theta: float = 0.0, sigma_a: float = 0.0,
                    dtheta: float = 1e-2, device_seed: int = 0,
                    cost=mse, device=None) -> Plant:
    """A full §3.5 device: σ_C readout noise, σ_θ write noise, σ_a static
    activation defects, all drawn from ``device_seed``."""
    loss_fn, probe_fn, _ = mlp_device_fns(
        sizes, sigma_a=sigma_a, device_seed=device_seed, cost=cost,
        device=device)
    if not (sigma_c or sigma_theta):
        return IdealPlant(loss_fn, probe_fn=probe_fn, meta=PlantMeta(
            name="mlp-ideal", sigma_a=sigma_a))
    return NoisyPlant(
        loss_fn, cost_noise=sigma_c, write_noise=sigma_theta,
        dtheta=dtheta, seed=device_seed, probe_fn=probe_fn,
        meta=PlantMeta(name="mlp-noisy", cost_noise=sigma_c,
                       write_noise=sigma_theta, sigma_a=sigma_a))


def quantized_mlp_plant(sizes: Sequence[int], *, bits: int = 8,
                        w_clip: float = 2.0, write_tau: float = 0.0,
                        quantize_probes: bool = False,
                        adc_bits: Optional[int] = None,
                        adc_mode: str = "round", adc_range: float = 1.0,
                        sigma_a: float = 0.0,
                        device_seed: int = 0, cost=mse,
                        device=None) -> QuantizedPlant:
    """An MLP whose weight memory sits behind a ``bits``-bit DAC and
    (optionally) whose cost readout passes an ``adc_bits``-bit ADC."""
    loss_fn, probe_fn, _ = mlp_device_fns(
        sizes, sigma_a=sigma_a, device_seed=device_seed, cost=cost,
        device=device)
    return QuantizedPlant(
        loss_fn, bits=bits, w_clip=w_clip, write_tau=write_tau,
        quantize_probes=quantize_probes, adc_bits=adc_bits,
        adc_mode=adc_mode, adc_range=adc_range, seed=device_seed,
        probe_fn=probe_fn,
        meta=PlantMeta(name=f"mlp-dac{bits}", weight_bits=bits,
                       adc_bits=adc_bits, sigma_a=sigma_a))
