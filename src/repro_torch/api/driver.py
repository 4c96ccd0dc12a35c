"""One driver API: ``repro_torch.driver()`` builds the MGD algorithms.

    mgd = repro_torch.driver("discrete", DriverConfig(dtheta=1e-2, eta=1.0),
                             loss_fn, device="cuda")
    state = mgd.init(params)
    params, state, aux = mgd.step(params, state, batch)

``MGDDriver`` is the optax-style ``(init, step)`` pair; every step emits
the standardized ``aux`` keys ``cost``, ``c_tilde`` and
``grad_norm_proxy`` (|C̃|/Δθ), plus ``updated`` for the discrete driver.

The registry holds ``"discrete"`` (Algorithm 1, incl. the fused CUDA
path), ``"analog"`` (Algorithm 2), ``"probe_parallel"`` (k pods, each
probing its own perturbation on its own batch share, run one after
another on the card: ``mesh=LocalMesh(pod=k)``) and
``"probe_parallel_external"`` (the same averaged update over k external
chips: ``plant=ChipFarm(...)``).  The probe-parallel drivers carry a
``ProbeParallelState`` (the step counter alone) and report
``aux["c_tilde"] = mean|C̃_k|``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.utils import epoch_loop, f32, tree_leaves
from repro_torch.device import resolve_device

Pytree = Any

ALGORITHMS = ("discrete", "analog", "probe_parallel",
              "probe_parallel_external")


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


class ProbeParallelState(NamedTuple):
    """Probe-parallel carries no optimizer buffers — parameters update
    every step from the k gathered scalars; only the counter remains (a
    host int)."""

    step: int


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


_WARNED: set = set()


def warn_deprecated(name: str, replacement: str, *,
                    category=DeprecationWarning) -> None:
    """Single-fire deprecation warning per legacy spelling."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"{name} is deprecated; use the consolidated surface instead: "
        f"{replacement}", category, stacklevel=3)


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


def _probe_parallel_driver(raw, mcfg, algorithm, plant, device) -> MGDDriver:
    """The probe-parallel drivers' shared (init, step) over
    ``raw(params, step, batch) -> (params, metrics)``: the state is the
    step counter, and ``aux["c_tilde"]`` is ``mean|C̃_k|``."""

    def init(params):
        check_on_device(params, device)
        return ProbeParallelState(step=0)

    def step(params, state, batch):
        params, m = raw(params, state.step, batch)
        aux = _standard_aux(m, m["c_tilde_mean"], mcfg.dtheta)
        aux["c_tilde"] = m["c_tilde_mean"]
        return params, ProbeParallelState(step=state.step + 1), aux

    return MGDDriver(init=init, step=step, algorithm=algorithm, config=mcfg,
                     tau_x=mcfg.tau_x, plant=plant, device=device)


@register_driver("probe_parallel")
def _build_probe_parallel(cfg, loss_fn, *, plant=None, probe_fn=None,
                          mesh=None, total_params=None, device=None,
                          probe_axis="pod", data_axis=None, param_specs=None,
                          batch_specs=None) -> MGDDriver:
    """Probe-parallel MGD: the k pods of ``mesh``'s probe axis, one after
    another on ``device`` (see ``core.probe_parallel``)."""
    from repro_torch.core.probe_parallel import build_probe_parallel_step

    if mesh is None:
        raise ValueError("repro_torch.driver('probe_parallel', ...) needs a "
                         "mesh= with the probe axis (default name 'pod'), "
                         "e.g. LocalMesh(pod=4) — each slice along it "
                         "evaluates one probe")
    fused = getattr(cfg, "fused", False)
    if probe_fn is not None and not fused:
        raise ValueError("probe_parallel only takes a probe_fn on its fused "
                         "path — set DriverConfig(fused=True) so every pod "
                         "probes through the CUDA kernels")
    if isinstance(cfg, DriverConfig) and cfg.probes != 1:
        raise ValueError(f"probes={cfg.probes} conflicts with "
                         "probe_parallel: the probe count IS the mesh's "
                         f"{probe_axis!r} axis size — leave probes=1")
    mcfg = as_mgd_config(cfg)
    if mcfg.tau_theta != 1 or mcfg.replay or mcfg.staleness:
        raise ValueError("probe_parallel updates every step (tau_theta=1, "
                         "no replay/staleness) — temporal integration "
                         "composes at the driver level, not inside the "
                         "pod step")
    raw = build_probe_parallel_step(
        loss_fn, mcfg, mesh, probe_axis=probe_axis, data_axis=data_axis,
        param_specs=param_specs, batch_specs=batch_specs, plant=plant,
        probe_fn=probe_fn)

    return _probe_parallel_driver(raw, mcfg, "probe_parallel", plant, device)


@register_driver("probe_parallel_external")
def _build_probe_parallel_external(cfg, loss_fn, *, plant=None, probe_fn=None,
                                   mesh=None, total_params=None,
                                   device=None) -> MGDDriver:
    """Probe-parallel MGD over k EXTERNAL chips (the §6 chip farm): the
    same averaged update as ``probe_parallel``, fanned out host-side to a
    ``hardware.farm.ChipFarm``.  The perturbations and the update live on
    ``device``.

    A farm armed with a ``hardware.FaultPolicy`` gains the fault-tolerant
    step: failed/quarantined/outlier chips are masked out of the average
    (η effectively rescaled by the live chip count — see
    ``core.probe_parallel``) and the aux metrics gain ``n_valid`` /
    ``n_used`` live-chip counts."""
    from repro_torch.core.probe_parallel import \
        build_probe_parallel_external_step
    from repro_torch.hardware.farm import ChipFarm

    if mesh is not None:
        raise ValueError("probe_parallel_external fans probes out host-side "
                         "— a mesh only parameterizes "
                         "repro_torch.driver('probe_parallel', ...)")
    if probe_fn is not None:
        raise ValueError("probe_parallel_external has no fused probe path — "
                         "the chips evaluate their own probes behind the "
                         "host boundary")
    if not isinstance(plant, ChipFarm):
        raise ValueError("repro_torch.driver('probe_parallel_external', "
                         "...) needs plant=ChipFarm(...) — k external chips "
                         "behind one host boundary "
                         "(repro_torch.hardware.simulated_chip_farm builds "
                         "a reference farm)")
    if loss_fn is not None:
        raise ValueError("probe_parallel_external has no in-process loss — "
                         "the chips ARE the cost oracle; pass loss_fn=None")
    if isinstance(cfg, DriverConfig) and cfg.probes != 1:
        raise ValueError(f"probes={cfg.probes} conflicts with "
                         "probe_parallel_external: the probe count IS the "
                         "farm size — leave probes=1")
    mcfg = as_mgd_config(cfg)
    if mcfg.tau_theta != 1 or mcfg.replay or mcfg.staleness:
        raise ValueError("probe_parallel_external updates every step "
                         "(tau_theta=1, no replay/staleness) — temporal "
                         "integration composes at the driver level, not "
                         "across the host boundary")
    raw = build_probe_parallel_external_step(mcfg, plant)

    return _probe_parallel_driver(raw, mcfg, "probe_parallel_external",
                                  plant, device)


def make_epoch(drv: MGDDriver, steps_per_call: int,
               sample_fn: Callable[[int], Any]):
    """``run(params, state) -> (params, state, stacked_aux)`` running
    ``steps_per_call`` driver iterations; iteration n uses sample index
    n // τ_x.  The counterpart of the reference's scanned epoch, as a
    Python loop."""
    return epoch_loop(drv.step, steps_per_call, sample_fn,
                      lambda state: state_step(state) // drv.tau_x)
