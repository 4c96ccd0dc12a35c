"""In-process hardware models: noisy, quantized and drifting plants.

PyTorch counterpart of ``repro.hardware.plants`` (paper §3.5, Figs 8-10):

* ``NoisyPlant``: σ_C cost-readout noise, one gaussian per scalar read
  keyed on (device seed, step, tag); σ_θ persistent-write noise, each
  element landing as θ + N(0, σ_θ·Δθ), keyed on (device seed + 77, leaf
  index counted from 1, step).
* ``QuantizedPlant``: persistent writes through a ``bits``-bit DAC
  (clip to ±w_clip, round to 2^bits − 1 levels) with an optional slow
  write lag, and an optional ``adc_bits``-bit cost ADC, deterministic or
  stochastic (seed + 131).
* ``DriftingPlant``: the stored weights age after every committed write,
  θ ← rest + a·(θ − rest) + σ_d·ξ(seed + 313, leaf, step).

Every draw comes from ``core.rng``, the port's copy of the reference's
``jax.random`` calls, so each device lands the reference's values: the
bits bitwise, the normals within ``rng.NORMAL_ULPS``.  The arithmetic
follows the reference op for op, each op rounding to its dtype as the
reference's eager ops do:

* the write noise is drawn in f32 and cast to the leaf's dtype before it
  is scaled (``σ_θ·Δθ`` rounded to that dtype) and added;
* the DAC divides by an f32 LSB, so a bf16 leaf is clipped and shifted in
  bf16 and then rounded in f32 and cast back at the end;
* drift runs in f32 as ``rest + a·(y − rest)``, then ``+ σ_d·ξ``.

Gaussian noise over a leaf is made and added ``rng.CHUNK`` elements at a
time, so no f32 copy of a whole leaf exists beside the output.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core import rng
from repro_torch.core.utils import f32, tree_flatten, tree_map, tree_unflatten
from .base import IdealPlant, Plant, PlantMeta


def _gauss_noise(seed, step, tag) -> torch.Tensor:
    """One standard-normal f32 draw keyed on (seed, tag, step), made on
    the host as a 0-dim CPU tensor (it combines with a card tensor
    without a copy)."""
    key = rng.fold_in(rng.fold_in(rng.prng_key(seed), tag), step)
    return rng.normal_scalar(key)


def _leaf_key(seed: int, leaf: int, step) -> rng.Key:
    return rng.fold_in(rng.fold_in(rng.prng_key(seed), leaf), step)


def _map_chunks(x: torch.Tensor, key: rng.Key, fn) -> torch.Tensor:
    """``fn(x_chunk, normal_chunk)`` over the flat leaf, chunk by chunk,
    into a new tensor of ``x``'s shape and dtype."""
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    for start, stop, xi in rng.normal_chunks(key, flat.numel(), x.device):
        out[start:stop] = fn(flat[start:stop], xi)
    return out.reshape(x.shape)


class NoisyPlant(Plant):
    """Device with gaussian readout noise and noisy persistent writes."""

    def __init__(self, loss_fn: Callable, *,
                 cost_noise: float = 0.0,
                 write_noise: float = 0.0,
                 dtheta: float = 1e-3,
                 seed: int = 0,
                 probe_fn: Optional[Callable] = None,
                 meta: Optional[PlantMeta] = None):
        self.loss_fn = loss_fn
        self.cost_noise = float(cost_noise)
        self.write_noise = float(write_noise)
        self.dtheta = float(dtheta)
        self.seed = int(seed)
        self.probe_fn = probe_fn
        self.meta = meta or PlantMeta(
            name="noisy", cost_noise=self.cost_noise,
            write_noise=self.write_noise)

    def _noisy(self, cost, step, tag):
        if self.cost_noise:
            cost = cost + f32(self.cost_noise) * _gauss_noise(
                self.seed, step, tag)
        return cost

    def read_cost(self, params, batch, *, step, tag: int = 0):
        return self._noisy(self.loss_fn(params, batch), step, tag)

    def write_key(self, leaf: int, step) -> rng.Key:
        """The key of a write's draws for leaf ``leaf`` (counted from 1)."""
        return _leaf_key(self.seed + 77, leaf, step)

    def write_leaf(self, x: torch.Tensor, leaf: int, step) -> torch.Tensor:
        """One leaf's noisy write: x + (σ_θ·Δθ)·ξ, with ξ cast to x's
        dtype first and σ_θ·Δθ rounded to it."""
        scale = torch.tensor(self.write_noise * self.dtheta, dtype=x.dtype)
        return _map_chunks(x, self.write_key(leaf, step),
                           lambda xc, xi: xc + scale * xi.to(x.dtype))

    def write_params(self, params, *, step, prev=None):
        if not self.write_noise:
            return params
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, [
            self.write_leaf(x, i, step) for i, x in enumerate(leaves, 1)])

    def apply_perturbed(self, params, batch, probe, *, step, tags):
        costs = super().apply_perturbed(params, batch, probe,
                                        step=step, tags=tags)
        if self.cost_noise:
            noise = torch.stack([_gauss_noise(self.seed, step, t)
                                 for t in tags]).to(costs.device)
            costs = costs + f32(self.cost_noise) * noise
        return costs


class QuantizedPlant(Plant):
    """Device whose persistent weight memory sits behind a limited-bit DAC
    with an optional first-order slow-write lag, and (optionally) whose
    cost readout passes a limited-bit ADC."""

    def __init__(self, loss_fn: Callable, *,
                 bits: int = 8,
                 w_clip: float = 2.0,
                 write_tau: float = 0.0,
                 quantize_probes: bool = False,
                 adc_bits: Optional[int] = None,
                 adc_mode: str = "round",
                 adc_range: float = 1.0,
                 seed: int = 0,
                 probe_fn: Optional[Callable] = None,
                 meta: Optional[PlantMeta] = None):
        if bits < 1:
            raise ValueError(f"weight DAC needs >= 1 bit, got {bits}")
        if adc_bits is not None and adc_bits < 1:
            raise ValueError(f"cost ADC needs >= 1 bit, got {adc_bits}")
        if adc_mode not in ("round", "stochastic"):
            raise ValueError(f"adc_mode must be 'round' or 'stochastic', "
                             f"got {adc_mode!r}")
        self.loss_fn = loss_fn
        self.bits = int(bits)
        self.w_clip = float(w_clip)
        self.write_tau = float(write_tau)
        self.quantize_probes = bool(quantize_probes)
        self.adc_bits = None if adc_bits is None else int(adc_bits)
        self.adc_mode = adc_mode
        self.adc_range = float(adc_range)
        self.seed = int(seed)
        self.probe_fn = probe_fn
        self.meta = meta or PlantMeta(name=f"dac{bits}", weight_bits=self.bits,
                                      adc_bits=self.adc_bits)

    @property
    def lsb(self) -> float:
        return 2.0 * self.w_clip / (2 ** self.bits - 1)

    @property
    def adc_lsb(self) -> float:
        if self.adc_bits is None:
            raise ValueError("plant has no cost ADC (adc_bits=None)")
        return self.adc_range / (2 ** self.adc_bits - 1)

    def _quantize_leaf(self, x):
        scale = f32(self.lsb)
        clip = torch.tensor(self.w_clip, dtype=x.dtype)
        shifted = torch.clamp(x, -self.w_clip, self.w_clip) + clip
        q = torch.round(shifted.float() / scale)
        return (q * scale - f32(self.w_clip)).to(x.dtype)

    def quantize(self, params):
        return tree_map(self._quantize_leaf, params)

    def write_params(self, params, *, step, prev=None):
        target = params
        if self.write_tau and prev is not None:
            # slow write: the cell slews a fraction 1 − e^{−1/τ_w} of the
            # commanded step per write event
            alpha = f32(1.0 - math.exp(-1.0 / self.write_tau))
            target = tree_map(
                lambda p, t: (p.float() + alpha * (t.float() - p.float())
                              ).to(t.dtype), prev, target)
        return self.quantize(target)

    def _adc(self, cost, step, tag):
        """k-bit cost readout: clip to [0, adc_range], land on the ADC
        grid; stochastic mode adds a uniform keyed on (seed + 131, tag,
        step) before the floor."""
        if self.adc_bits is None:
            return cost
        scale = f32(self.adc_lsb)
        code = torch.clamp(cost.float(), 0.0, self.adc_range) / scale
        if self.adc_mode == "stochastic":
            key = rng.fold_in(rng.fold_in(rng.prng_key(self.seed + 131),
                                          tag), step)
            code = torch.floor(code + rng.uniform_scalar(key))
        else:
            code = torch.round(code)
        return code * scale

    def read_cost(self, params, batch, *, step, tag: int = 0):
        if self.quantize_probes:
            params = self.quantize(params)
        return self._adc(self.loss_fn(params, batch), step, tag)

    def apply_perturbed(self, params, batch, probe, *, step, tags):
        # persistent params are already on the DAC grid; the probe line
        # bypasses the DAC, which the fused kernels cannot model otherwise
        if self.quantize_probes:
            raise NotImplementedError(
                "quantize_probes=True has no fused kernel path")
        costs = super().apply_perturbed(params, batch, probe,
                                        step=step, tags=tags)
        if self.adc_bits is not None:
            costs = torch.stack([self._adc(costs[i], step, t)
                                 for i, t in enumerate(tags)])
        return costs


class DriftingPlant(Plant):
    """Device whose stored weights age BETWEEN writes (drift/aging model).

    Wraps any in-process plant; after every committed write the landed
    weights take one transition θ ← rest + a·(θ − rest) + σ_d·ξ with
    a = exp(−1/drift_tau) (1 when drift_tau = 0):

    * ``mode="walk"``: Ornstein-Uhlenbeck random walk with per-step
      kicks of std ``drift_rate``, mean-reverting when ``drift_tau`` > 0;
    * ``mode="decay"``: relaxation toward ``rest`` with time constant
      ``drift_tau`` write events, ``drift_rate`` optional diffusion.

    The kick is keyed on (seed + 313, leaf index from 1, step), so a
    resumed run replays the identical device trajectory.
    """

    def __init__(self, inner: Plant, *, mode: str = "walk",
                 drift_rate: float = 0.0, drift_tau: float = 0.0,
                 rest: float = 0.0, seed: int = 0,
                 meta: Optional[PlantMeta] = None):
        if not isinstance(inner, Plant):
            raise TypeError(f"inner must be a repro_torch.hardware.Plant, "
                            f"got {type(inner).__name__}")
        if inner.meta.external:
            raise ValueError(
                "DriftingPlant cannot wrap an external plant — the device's "
                "stored weights live behind the host boundary; put the drift "
                "IN the device instead")
        if mode not in ("walk", "decay"):
            raise ValueError(f"drift mode must be 'walk' or 'decay', "
                             f"got {mode!r}")
        if mode == "walk" and drift_rate <= 0.0:
            raise ValueError("mode='walk' needs drift_rate > 0 (σ_d, the "
                             "per-step random-walk std)")
        if mode == "decay" and drift_tau <= 0.0:
            raise ValueError("mode='decay' needs drift_tau > 0 (the "
                             "relaxation time constant, in write events)")
        self.inner = inner
        self.mode = mode
        self.drift_rate = float(drift_rate)
        self.drift_tau = float(drift_tau)
        self.rest = float(rest)
        self.seed = int(seed)
        self.probe_fn = inner.probe_fn
        self.meta = meta or dataclasses.replace(
            inner.meta, name=f"drifting-{inner.meta.name}", drift_mode=mode,
            drift_rate=self.drift_rate, drift_tau=self.drift_tau,
            drift_rest=self.rest)

    def drift_key(self, leaf: int, step) -> rng.Key:
        """The key of a transition's kicks for leaf ``leaf`` (from 1)."""
        return _leaf_key(self.seed + 313, leaf, step)

    def drift_leaf(self, x: torch.Tensor, leaf: int, step) -> torch.Tensor:
        """One leaf's transition, in f32, cast back to x's dtype."""
        rest = f32(self.rest)
        a = f32(math.exp(-1.0 / self.drift_tau) if self.drift_tau else 1.0)
        rate = f32(self.drift_rate)

        def relax(y):
            return rest + a * (y - rest) if self.drift_tau else y

        if not self.drift_rate:
            return relax(x.float()).to(x.dtype)
        return _map_chunks(
            x, self.drift_key(leaf, step),
            lambda xc, xi: (relax(xc.float()) + rate * xi).to(x.dtype))

    def drift(self, params, step):
        """One drift transition of the stored weights, keyed on ``step``."""
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, [
            self.drift_leaf(x, i, step) for i, x in enumerate(leaves, 1)])

    def age(self, params, start_step, n_steps: int):
        """``n_steps`` drift transitions with no writes (a held device):
        steps ``start_step .. start_step + n_steps − 1``."""
        for j in range(int(n_steps)):
            params = self.drift(params, int(start_step) + j)
        return params

    # reads delegate (the carried tree IS the drifted device state);
    # writes land through the inner device, then age once
    def write_params(self, params, *, step, prev=None):
        return self.drift(
            self.inner.write_params(params, step=step, prev=prev), step)

    def read_cost(self, params, batch, *, step, tag: int = 0):
        return self.inner.read_cost(params, batch, step=step, tag=tag)

    def read_cost_pair(self, params, theta, batch, *, step, tag: int = 0):
        return self.inner.read_cost_pair(params, theta, batch,
                                         step=step, tag=tag)

    def apply_perturbed(self, params, batch, probe, *, step, tags):
        inner = self.inner
        if self.probe_fn is not None and inner.probe_fn is not self.probe_fn:
            # a probe_fn attached to the wrapper (driver resolution) rides
            # down so the inner device's imperfections still apply
            inner = copy.copy(inner)
            inner.probe_fn = self.probe_fn
        return inner.apply_perturbed(params, batch, probe,
                                     step=step, tags=tags)


def plant_from_config(loss_fn, cfg, *, probe_fn=None) -> Plant:
    """The implicit device of an ``MGDConfig``: ``cost_noise``/
    ``update_noise`` become a ``NoisyPlant`` keyed on ``cfg.seed``
    (σ = 0 → ``IdealPlant``)."""
    if getattr(cfg, "cost_noise", 0.0) or getattr(cfg, "update_noise", 0.0):
        return NoisyPlant(
            loss_fn,
            cost_noise=cfg.cost_noise,
            write_noise=getattr(cfg, "update_noise", 0.0),
            dtheta=cfg.dtheta,
            seed=cfg.seed,
            probe_fn=probe_fn,
        )
    return IdealPlant(loss_fn, probe_fn=probe_fn)
