"""The hardware plant abstraction: MGD's view of the device it trains.

The optimizer treats the network as an opaque plant (McCaughan et al.
2023 §4/§6): it writes parameters, presents an input and reads back ONE
scalar cost.  ``Plant`` is that protocol:

* ``write_params(params, *, step, prev=None)`` commits a persistent write
  and returns what landed (ideal devices: the input unchanged);
* ``read_cost(params, batch, *, step, tag)`` is a transient probe write
  plus a cost readout;
* ``read_cost_pair(params, theta, batch, *, step, tag)`` the antithetic
  readout C(θ+θ̃), C(θ−θ̃);
* ``apply_perturbed(params, batch, probe, *, step, tags)`` the fused probe
  path: costs under θ ± θ̃ with θ̃ generated at the parameter (in the CUDA
  kernels), never materialized.

``PlantMeta`` carries static device metadata.  The imperfect devices are
in ``plants.py``; external plants remain in the JAX package (ROADMAP
A12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.utils import tree_add, tree_axpy

Pytree = Any


@dataclasses.dataclass(frozen=True)
class PlantMeta:
    """Static device metadata."""

    name: str = "ideal"
    cost_noise: float = 0.0          # σ_C, std of the cost readout noise
    write_noise: float = 0.0         # σ_θ, persistent-write noise in units of Δθ
    sigma_a: float = 0.0             # σ_a, static activation-defect scale
    weight_bits: Optional[int] = None  # DAC resolution of persistent writes
    adc_bits: Optional[int] = None     # ADC resolution of the cost readout
    write_latency_s: float = 0.0     # τ per persistent parameter write
    read_latency_s: float = 0.0      # τ per cost readout (≈ τ_p floor)
    external: bool = False           # True → host-callback / process boundary
    chips: int = 1                   # devices probed concurrently (chip farm)
    drift_mode: Optional[str] = None  # walk | decay | None (stable device)
    drift_rate: float = 0.0          # σ_d, per-step random-walk std
    drift_tau: float = 0.0           # relaxation τ toward drift_rest (steps)
    drift_rest: float = 0.0          # rest value the weights decay toward
    fault_tolerant: bool = False     # host boundary armed with a FaultPolicy

    def step_latency_s(self, reads_per_step: int = 2,
                       writes_per_step: int = 1, *,
                       differential: bool = False,
                       pipelined: bool = False) -> float:
        """Projected seconds per MGD iteration on this device (Table 3
        style).  ``differential`` prices a paired readout as one
        conversion; ``pipelined`` overlaps the write with the readout."""
        reads = reads_per_step * (0.5 if differential else 1.0)
        read_time = reads * self.read_latency_s
        write_time = writes_per_step * self.write_latency_s
        if pipelined:
            return max(read_time, write_time)
        return read_time + write_time


class Plant:
    """Base plant: ideal pass-through semantics; subclasses override what
    their hardware model perturbs."""

    meta: PlantMeta = PlantMeta()
    probe_fn: Optional[Callable] = None

    def write_params(self, params: Pytree, *, step,
                     prev: Optional[Pytree] = None) -> Pytree:
        """Commit ``params`` to the device; return what actually landed."""
        return params

    def read_cost(self, params: Pytree, batch, *, step, tag: int = 0):
        raise NotImplementedError

    def read_cost_pair(self, params: Pytree, theta: Pytree, batch, *,
                       step, tag: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(C(θ+θ̃), C(θ−θ̃)) as two reads with consecutive tags."""
        c_plus = self.read_cost(tree_add(params, theta), batch,
                                step=step, tag=tag)
        c_minus = self.read_cost(tree_axpy(-1.0, theta, params), batch,
                                 step=step, tag=tag + 1)
        return c_plus, c_minus

    @property
    def supports_fused(self) -> bool:
        return self.probe_fn is not None

    def apply_perturbed(self, params: Pytree, batch, probe, *, step, tags):
        """Costs under θ ± θ̃ with θ̃ generated at the parameter: a
        [len(tags)] tensor, one per sign in ``probe.ctx.signs``."""
        if self.probe_fn is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no perturbed-apply interface "
                "(construct it with probe_fn=... for the fused path)")
        return self.probe_fn(params, batch, probe)


class IdealPlant(Plant):
    """In-process device: ``read_cost`` IS the loss function and writes
    land exactly."""

    def __init__(self, loss_fn: Callable, *,
                 probe_fn: Optional[Callable] = None,
                 meta: Optional[PlantMeta] = None):
        self.loss_fn = loss_fn
        self.probe_fn = probe_fn
        self.meta = meta or PlantMeta(name="ideal")

    def read_cost(self, params, batch, *, step, tag: int = 0):
        return self.loss_fn(params, batch)
