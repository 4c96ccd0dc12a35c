"""One driver API: ``repro_torch.driver()`` builds the MGD algorithms.

    mgd = repro_torch.driver("discrete", DriverConfig(dtheta=1e-2, eta=1.0),
                             loss_fn, device="cuda")
    state = mgd.init(params)
    params, state, aux = mgd.step(params, state, batch)

``MGDDriver`` is the optax-style ``(init, step)`` pair; every step emits
the standardized ``aux`` keys ``cost``, ``c_tilde`` and
``grad_norm_proxy`` (|C̃|/Δθ), plus ``updated`` for the discrete driver.

The registry holds ``"discrete"`` (Algorithm 1, incl. the fused CUDA
path) and ``"analog"`` (Algorithm 2).  The probe-parallel algorithms of
the JAX package's registry raise with the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.utils import f32, tree_leaves
from repro_torch.device import resolve_device

Pytree = Any

ALGORITHMS = ("discrete", "analog")
_NOT_PORTED = {
    "probe_parallel": "A11 (probe parallelism)",
    "probe_parallel_external": "A11/A12 (probe parallelism over external "
                               "chips)",
}


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Algorithm-agnostic MGD configuration (the JAX package's
    ``repro.api.DriverConfig``, field for field).

    Shared fields default to ``None`` and resolve to the algorithm's
    defaults at ``driver()`` time: Δθ = 1e-3, η = 1e-2, rademacher for
    the discrete driver; Δθ = 1e-2, η = 1e-3, sinusoidal, τ_θ = 10 for
    the analog one.  A config whose other-section knobs were moved from
    their defaults is rejected.
    """

    # -- shared (None → per-algorithm default) ------------------------------
    ptype: Optional[str] = None
    dtheta: Optional[float] = None
    eta: Optional[float] = None
    tau_theta: Optional[float] = None
    tau_p: int = 1
    seed: int = 0
    cost_noise: float = 0.0

    # -- discrete section (Algorithm 1) -------------------------------------
    mode: str = "forward"
    tau_x: int = 1
    replay: bool = False
    probes: int = 1
    probe_impl: str = "map"
    momentum: float = 0.0
    staleness: int = 0
    fused: bool = False
    kernel_impl: Optional[str] = None   # cuda | ref | None = by device
    update_noise: float = 0.0

    # -- analog section (Algorithm 2) ---------------------------------------
    tau_hp: float = 100.0
    dt: float = 1.0

    def replace(self, **kw) -> "DriverConfig":
        return dataclasses.replace(self, **kw)


_DISCRETE_ONLY = {
    "mode": "forward", "tau_x": 1, "replay": False, "probes": 1,
    "probe_impl": "map", "momentum": 0.0, "staleness": 0, "fused": False,
    "kernel_impl": None, "update_noise": 0.0,
}
_ANALOG_ONLY = {"tau_hp": 100.0, "dt": 1.0}


def _reject_foreign(cfg: DriverConfig, algorithm: str) -> None:
    foreign = _DISCRETE_ONLY if algorithm == "analog" else _ANALOG_ONLY
    section = "analog" if foreign is _ANALOG_ONLY else "discrete"
    for field, default in foreign.items():
        if getattr(cfg, field) != default:
            raise ValueError(
                f"DriverConfig.{field}={getattr(cfg, field)!r} is a "
                f"{section}-section knob the {algorithm!r} driver cannot "
                f"honor — did you mean repro_torch.driver({section!r}, "
                f"...)? (leave {field} at its default {default!r} "
                f"otherwise)")


def as_mgd_config(cfg):
    """Resolve ``cfg`` to the discrete driver's ``MGDConfig``."""
    from repro_torch.core.analog import AnalogMGDConfig
    from repro_torch.core.mgd import MGDConfig

    if isinstance(cfg, MGDConfig):
        return cfg
    if isinstance(cfg, AnalogMGDConfig):
        raise TypeError("AnalogMGDConfig describes Algorithm 2 — use "
                        "repro_torch.driver('analog', cfg, ...) or a "
                        "DriverConfig")
    if not isinstance(cfg, DriverConfig):
        raise TypeError(f"expected DriverConfig or MGDConfig, got "
                        f"{type(cfg).__name__}")
    tau_theta = 1 if cfg.tau_theta is None else cfg.tau_theta
    if int(tau_theta) != tau_theta:
        raise ValueError(
            f"the discrete driver integrates over an integer number of "
            f"steps; tau_theta={tau_theta} is fractional — fractional "
            f"time constants belong to repro_torch.driver('analog', ...)")
    return MGDConfig(
        ptype="rademacher" if cfg.ptype is None else cfg.ptype,
        dtheta=1e-3 if cfg.dtheta is None else cfg.dtheta,
        eta=1e-2 if cfg.eta is None else cfg.eta,
        tau_p=cfg.tau_p, tau_theta=int(tau_theta), tau_x=cfg.tau_x,
        mode=cfg.mode, replay=cfg.replay, probes=cfg.probes,
        probe_impl=cfg.probe_impl, momentum=cfg.momentum, seed=cfg.seed,
        cost_noise=cfg.cost_noise, update_noise=cfg.update_noise,
        staleness=cfg.staleness, fused=cfg.fused,
        kernel_impl=cfg.kernel_impl)


def as_analog_config(cfg):
    """Resolve ``cfg`` to the continuous driver's ``AnalogMGDConfig``."""
    from repro_torch.core.analog import AnalogMGDConfig
    from repro_torch.core.mgd import MGDConfig

    if isinstance(cfg, AnalogMGDConfig):
        return cfg
    if isinstance(cfg, MGDConfig):
        raise TypeError("MGDConfig describes the discrete Algorithm 1 — "
                        "use repro_torch.driver('discrete', cfg, ...) or a "
                        "DriverConfig")
    if not isinstance(cfg, DriverConfig):
        raise TypeError(f"expected DriverConfig or AnalogMGDConfig, got "
                        f"{type(cfg).__name__}")
    return AnalogMGDConfig(
        ptype="sinusoidal" if cfg.ptype is None else cfg.ptype,
        dtheta=1e-2 if cfg.dtheta is None else cfg.dtheta,
        eta=1e-3 if cfg.eta is None else cfg.eta,
        tau_theta=10.0 if cfg.tau_theta is None else float(cfg.tau_theta),
        tau_hp=cfg.tau_hp, tau_p=cfg.tau_p, dt=cfg.dt, seed=cfg.seed,
        cost_noise=cfg.cost_noise)


class MGDDriver(NamedTuple):
    """The ``(init, step)`` pair plus construction metadata: ``tau_x`` for
    sampler pacing, ``config`` the resolved algorithm config, ``plant``
    the device handed in (None for the implicit one), ``device`` where
    params and batches must live."""

    init: Callable[[Pytree], Any]
    step: Callable[[Pytree, Any, Any], Tuple[Pytree, Any, Dict]]
    algorithm: str = "discrete"
    config: Any = None
    tau_x: int = 1
    plant: Any = None
    device: Optional[torch.device] = None


def state_step(state) -> int:
    """The global iteration counter of a driver state (a host int)."""
    if hasattr(state, "step"):
        return state.step
    if hasattr(state, "t"):
        return state.t
    raise TypeError(f"{type(state).__name__} has no step/t counter")


def replace_step(state, step):
    """``state`` with its iteration counter set to ``step``."""
    if hasattr(state, "step"):
        return state._replace(step=int(step))
    if hasattr(state, "t"):
        return state._replace(t=int(step))
    raise TypeError(f"{type(state).__name__} has no step/t counter")


_REGISTRY: Dict[str, Callable[..., MGDDriver]] = {}


def register_driver(name: str):
    """Register a builder under ``name`` (decorator).  Builders receive
    ``(cfg, loss_fn, **kwargs)`` and return an ``MGDDriver``."""
    def deco(builder):
        _REGISTRY[name] = builder
        return builder
    return deco


def driver(algorithm: str, cfg=None, loss_fn: Optional[Callable] = None, *,
           plant=None, probe_fn: Optional[Callable] = None, mesh=None,
           total_params: Optional[int] = None, device=None,
           **kwargs) -> MGDDriver:
    """Construct an MGD algorithm behind the uniform driver contract.

    ``device`` is where the run lives: the CUDA card unless the caller
    passes ``device="cpu"``; without a card that request is required.
    """
    if algorithm in _NOT_PORTED:
        raise NotImplementedError(
            f"the {algorithm!r} algorithm is not ported to repro_torch yet "
            f"(ROADMAP {_NOT_PORTED[algorithm]}); use the JAX package")
    if algorithm not in _REGISTRY:
        raise ValueError(f"unknown algorithm {algorithm!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    if cfg is None:
        cfg = DriverConfig()
    if isinstance(cfg, DriverConfig):
        _reject_foreign(cfg, algorithm)
    return _REGISTRY[algorithm](
        cfg, loss_fn, plant=plant, probe_fn=probe_fn, mesh=mesh,
        total_params=total_params, device=resolve_device(device), **kwargs)


def _standard_aux(metrics: Dict, c_tilde, dtheta: float) -> Dict:
    aux = dict(metrics)
    aux["grad_norm_proxy"] = torch.abs(c_tilde.float()) / f32(dtheta)
    return aux


def check_on_device(params, device: torch.device) -> None:
    """Raise unless every leaf of ``params`` lies on ``device``."""
    for leaf in tree_leaves(params):
        if leaf.device.type != device.type or (
                device.index is not None and leaf.device != device):
            raise ValueError(f"params lie on {leaf.device}, the driver runs "
                             f"on {device}; move them (convert.to_torch, "
                             f"mlp_init(device=...)) or build the driver "
                             f"with device={str(leaf.device)!r}")


@register_driver("discrete")
def _build_discrete(cfg, loss_fn, *, plant=None, probe_fn=None, mesh=None,
                    total_params=None, device=None) -> MGDDriver:
    from repro_torch.core.mgd import build_mgd_step, mgd_init

    if mesh is not None:
        raise ValueError("the discrete driver is single-program — a mesh "
                         "only parameterizes probe parallelism")
    mcfg = as_mgd_config(cfg)
    raw = build_mgd_step(loss_fn, mcfg, total_params, probe_fn=probe_fn,
                         plant=plant)

    def init(params):
        check_on_device(params, device)
        return mgd_init(params, mcfg)

    def step(params, state, batch):
        params, state, m = raw(params, state, batch)
        return params, state, _standard_aux(m, m["c_tilde"], mcfg.dtheta)

    return MGDDriver(init=init, step=step, algorithm="discrete", config=mcfg,
                     tau_x=mcfg.tau_x, plant=plant, device=device)


@register_driver("analog")
def _build_analog(cfg, loss_fn, *, plant=None, probe_fn=None, mesh=None,
                  total_params=None, device=None) -> MGDDriver:
    from repro_torch.core.analog import analog_init, build_analog_step

    if mesh is not None:
        raise ValueError("the analog driver is single-program; mesh only "
                         "parameterizes probe parallelism")
    if probe_fn is not None:
        raise ValueError("the analog driver has no fused probe path — "
                         "probe_fn belongs to repro_torch.driver("
                         "'discrete', DriverConfig(fused=True), ...)")
    if isinstance(cfg, DriverConfig) and cfg.probes != 1:
        raise ValueError(f"probes={cfg.probes} is a discrete-section knob; "
                         "Algorithm 2 multiplexes probes in frequency, not "
                         "by count — use repro_torch.driver('discrete', "
                         "...) for probe averaging")
    acfg = as_analog_config(cfg)
    raw = build_analog_step(loss_fn, acfg, total_params, plant=plant)

    def init(params):
        check_on_device(params, device)
        return analog_init(params, acfg)

    def step(params, state, batch):
        params, state, m = raw(params, state, batch)
        return params, state, _standard_aux(m, m["c_tilde"], acfg.dtheta)

    return MGDDriver(init=init, step=step, algorithm="analog", config=acfg,
                     tau_x=1, plant=plant, device=device)


def make_epoch(drv: MGDDriver, steps_per_call: int,
               sample_fn: Callable[[int], Any]):
    """``run(params, state) -> (params, state, stacked_aux)`` running
    ``steps_per_call`` driver iterations; iteration n uses sample index
    n // τ_x.  The counterpart of the reference's scanned epoch, as a
    Python loop."""
    def run(params, state):
        auxes = []
        for _ in range(steps_per_call):
            batch = sample_fn(state_step(state) // drv.tau_x)
            params, state, aux = drv.step(params, state, batch)
            auxes.append(aux)
        stacked = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]} \
            if auxes else {}
        return params, state, stacked

    return run
