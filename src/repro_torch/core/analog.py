"""Continuous-time MGD, the paper's Algorithm 2 (analog hardware).

PyTorch counterpart of ``repro.core.analog``.  Build it through the
registry: ``repro_torch.driver("analog", cfg, loss_fn)``.  Discretized
with timestep ``dt``:

    C̃(t)  ← α_hp · (C̃(t−dt) + C(t) − C(t−dt))        α_hp = τ_hp/(τ_hp+dt)
    e(t)  ← C̃(t)·θ̃(t)·dt/Δθ²
    G(t)  ← (dt/(τ_θ+dt)) · (e(t) + (τ_θ/dt)·G(t−dt))   (single-pole lowpass)
    θ     ← θ − η·G(t)                                   (continuous update)

There is no discrete update event and no C₀: the highpass at the cost
output removes the baseline and the per-parameter lowpass integrates.
θ̃ is materialized every tick (no fused path, as in the reference).  The
tick counter ``t`` and the ``primed`` flag are host values, like the
discrete state's step, so a tick never reads the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import perturbations as pert
from .utils import f32, tree_add, tree_axpy, tree_leaves, tree_map, \
    tree_zeros_like

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AnalogMGDConfig:
    """Continuous MGD constants (stability, paper §4.2: η·|G|·dt ≪ Δθ)."""

    ptype: str = "sinusoidal"
    dtheta: float = 1e-2
    eta: float = 1e-3
    tau_theta: float = 10.0   # lowpass (gradient-integration) time constant
    tau_hp: float = 100.0     # highpass (baseline-removal) time constant
    tau_p: int = 1            # perturbation bandwidth control (1/Δf)
    dt: float = 1.0
    seed: int = 0
    # σ_C of the implicit device (a NoisyPlant); must stay 0 when an
    # explicit plant is passed
    cost_noise: float = 0.0


class AnalogMGDState(NamedTuple):
    t: int                  # tick counter (time = t·dt), host int
    c_prev: torch.Tensor    # C(t−dt)
    c_tilde: torch.Tensor   # highpass output C̃(t−dt)
    g: Pytree               # lowpass gradient estimate, f32
    primed: bool            # False → the first tick only primes c_prev


def analog_init(params: Pytree, cfg: AnalogMGDConfig) -> AnalogMGDState:
    dev = tree_leaves(params)[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return AnalogMGDState(t=0, c_prev=zero, c_tilde=zero,
                          g=tree_zeros_like(params, torch.float32),
                          primed=False)


def build_analog_step(
    loss_fn: Optional[Callable],
    cfg: AnalogMGDConfig,
    total_params: Optional[int] = None,
    *,
    plant=None,
):
    """One dt tick of Algorithm 2: ``step_fn(params, state, batch)``.

    Cost reads and the continuous write go through a
    ``repro_torch.hardware.Plant``; ``plant=None`` builds the implicit
    device from the config (``cost_noise`` → a ``NoisyPlant``).
    """
    from repro_torch.core.mgd import _resolve_plant
    plant = _resolve_plant(loss_fn, cfg, plant=plant)

    inv_d2 = 1.0 / (cfg.dtheta * cfg.dtheta)
    A_HP = f32(cfg.tau_hp / (cfg.tau_hp + cfg.dt))
    A_G_NEW = f32(cfg.dt / (cfg.tau_theta + cfg.dt))
    A_G_OLD = f32(cfg.tau_theta / (cfg.tau_theta + cfg.dt))
    DT = f32(cfg.dt)
    INV_D2 = f32(inv_d2)
    NEG_ETA = f32(-cfg.eta)

    def step_fn(params, state: AnalogMGDState, batch):
        t = state.t
        theta_t = pert.generate(
            params, ptype=cfg.ptype, step=t, seed=cfg.seed,
            dtheta=cfg.dtheta, tau_p=cfg.tau_p, total=total_params)
        c = plant.read_cost(tree_add(params, theta_t), batch,
                            step=t, tag=0).float()
        c_prev = state.c_prev if state.primed else c
        c_tilde = A_HP * (state.c_tilde + c - c_prev)
        e_coef = c_tilde * DT * INV_D2
        scale = A_G_NEW * (e_coef / DT)
        g = tree_map(lambda gi, pi: scale * pi.float() + A_G_OLD * gi,
                     state.g, theta_t)
        # every tick is a physical write event
        new_params = plant.write_params(
            tree_axpy(NEG_ETA, g, params), step=t, prev=params)
        new_state = AnalogMGDState(t=t + 1, c_prev=c, c_tilde=c_tilde, g=g,
                                   primed=True)
        return new_params, new_state, {"cost": c, "c_tilde": c_tilde}

    return step_fn
