"""Multiplexed gradient descent, discrete algorithm (paper Algorithm 1).

PyTorch counterpart of ``repro.core.mgd``.  Build it through the driver
registry::

    mgd = repro_torch.driver("discrete", repro_torch.DriverConfig(...),
                             loss_fn, probe_fn=..., device="cuda")
    state = mgd.init(params)
    params, state, aux = mgd.step(params, state, batch)

One iteration: regenerate θ̃ for step n [τ_p]; probe ±θ̃ (central) or
refresh C₀ and probe +θ̃ (forward) [τ_x]; C̃ is the ONE scalar of
feedback; e = C̃·θ̃/Δθ²; every τ_θ steps θ ← θ − η·Σe [τ_θ].

The JAX package's ``jit``/``lax.scan``/``lax.cond`` become eager Python.
The step counter ``n`` is a host int, so the C₀ refresh, the update
decision and the replay window's slots are host decisions and a step
never waits on the device; C₀, the replay window, C̃ and the costs stay
on the device.

Float order.  Every scalar constant enters as a 0-dim float32 tensor
(``f32``) in the reference's written association —
``s = C̃·f32(1/Δθ²)``, ``t = f32(−η)·(f32(Δθ)·s)``,
``C̃ = 0.5·(C₊ − C₋)`` — so the fused path (kernels, or their plain
versions) and the materializing path give bitwise-equal f32 trajectories
on the same device.  Nothing here is compiled by ``torch.compile``, which
may reassociate.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tracing
from repro_torch.kernels import ops as kops
from . import perturbations as pert
from .probe_parallel import pod_seed
from .utils import (epoch_loop, f32, is_dtensor, leaf_meta, tree_add,
                    tree_axpy,
                    tree_flatten, tree_leaves, tree_map, tree_scale,
                    tree_unflatten, tree_zeros_like)

Pytree = Any


@dataclasses.dataclass(frozen=True)
class MGDConfig:
    """Static configuration of the MGD optimizer (the paper's Table 1 plus
    framework extensions; see ``repro.core.mgd.MGDConfig``)."""

    ptype: str = "rademacher"     # rademacher | walsh | sequential | sinusoidal
    dtheta: float = 1e-3          # Δθ, perturbation amplitude
    eta: float = 1e-2             # η, learning rate
    tau_p: int = 1                # perturbation time constant
    tau_theta: int = 1            # parameter-update (integration) time
    tau_x: int = 1                # input-sample change time (driver-enforced)
    mode: str = "forward"         # forward (paper) | central (beyond-paper)
    replay: bool = False          # scalar-replay O(1)-memory updates
    probes: int = 1               # probe-averaging count
    probe_impl: str = "map"       # map | vmap (both a loop in eager torch)
    momentum: float = 0.0         # heavy-ball coefficient on G
    seed: int = 0
    cost_noise: float = 0.0       # σ_C of the implicit device
    update_noise: float = 0.0     # σ_θ of the implicit device
    staleness: int = 0            # bounded-staleness feedback (replay only)
    # fused probe execution: probes evaluate through the model's probe_fn,
    # whose weight matmuls run in the perturbed-matmul kernels; updates of
    # ndim ≥ 2 leaves run in the window-update kernel
    fused: bool = False
    kernel_impl: Optional[str] = None   # cuda | ref | None = by device

    def __post_init__(self):
        if self.ptype not in pert.PERTURBATION_TYPES:
            raise ValueError(f"unknown perturbation type {self.ptype!r}")
        if self.mode not in ("forward", "central"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.kernel_impl in ("pallas", "interpret"):
            raise ValueError(
                f"kernel_impl={self.kernel_impl!r} is a Pallas route of the "
                f"JAX package; repro_torch takes 'cuda', 'ref' or None")
        if self.kernel_impl not in (None,) + kops.IMPLS:
            raise ValueError(f"unknown kernel_impl {self.kernel_impl!r}")
        if self.replay and self.ptype == "sinusoidal" and self.tau_theta > 256:
            raise ValueError("replay mode with sinusoidal ptype and large "
                             "tau_theta: use the analog algorithm instead")
        if self.staleness and not self.replay:
            raise ValueError("bounded-staleness feedback requires replay mode "
                             "(the C̃ window is what absorbs the delay)")
        if self.fused:
            if self.ptype != "rademacher":
                raise ValueError("fused path regenerates signs in-kernel — "
                                 "rademacher only")
            if self.probes != 1:
                raise ValueError("fused path supports probes=1")
            if self.momentum or self.update_noise:
                raise ValueError("fused path has no materialized update "
                                 "direction — momentum/update_noise need "
                                 "the unfused optimizer")
            if self.tau_theta > 1 and not self.replay:
                raise ValueError("fused path with tau_theta > 1 requires "
                                 "replay=True (the O(P) gradient accumulator "
                                 "is exactly what fusion eliminates)")


class MGDState(NamedTuple):
    """Carried optimizer state; ``step`` is a host int, the rest tensors."""

    step: int                               # global iteration counter n
    c0: torch.Tensor                        # f32 baseline cost C₀
    g: Optional[Pytree]                     # gradient accumulator
    replay_c: Optional[torch.Tensor]        # f32[tau_theta + staleness]
    m: Optional[Pytree]                     # momentum buffer
    metric_cost: torch.Tensor               # f32 last cost (telemetry)


def mgd_init(params: Pytree, cfg: MGDConfig) -> MGDState:
    """Fresh optimizer state on the params' device.  τ_θ = 1 needs no
    gradient accumulator (the update consumes e immediately)."""
    dev = tree_leaves(params)[0].device
    g = (None if (cfg.replay or cfg.tau_theta == 1)
         else tree_zeros_like(params, torch.float32))
    window = cfg.tau_theta + cfg.staleness
    replay_c = (torch.zeros((window,), dtype=torch.float32, device=dev)
                if cfg.replay else None)
    m = tree_zeros_like(params, torch.float32) if cfg.momentum else None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return MGDState(step=0, c0=zero, g=g, replay_c=replay_c, m=m,
                    metric_cost=zero)


def _resolve_plant(loss_fn, cfg, *, probe_fn=None, plant=None):
    """The device behind this optimizer run (see the reference)."""
    from repro_torch.hardware.base import Plant
    from repro_torch.hardware.plants import plant_from_config

    if plant is None:
        if loss_fn is None:
            raise ValueError("need a loss_fn (or an explicit plant)")
        return plant_from_config(loss_fn, cfg, probe_fn=probe_fn)
    if not isinstance(plant, Plant):
        raise TypeError(f"plant must be a repro_torch.hardware.Plant, "
                        f"got {type(plant).__name__}")
    if getattr(cfg, "cost_noise", 0.0) or getattr(cfg, "update_noise", 0.0):
        raise ValueError(
            "cfg.cost_noise/update_noise describe the implicit device; "
            "with an explicit plant the plant owns all imperfections — "
            "set the config fields to 0")
    if probe_fn is not None and plant.probe_fn is not probe_fn:
        if plant.probe_fn is not None:
            raise ValueError("both the plant and build_mgd_step were given "
                             "a probe_fn — they disagree; set it in one "
                             "place")
        plant = copy.copy(plant)
        plant.probe_fn = probe_fn
    return plant


def _probe_seed(cfg: MGDConfig, probe: int) -> int:
    """Distinct seed per probe, uint32: ``pod_seed(cfg.seed, probe)``;
    probe 0 is ``cfg.seed`` itself."""
    return pod_seed(cfg.seed, probe)


def _update_blocks(leaf, seeds):
    """(input, output, window seeds, signs' row stride) of each block the
    window update takes for an ndim ≥ 2 leaf, and the updated leaf those
    outputs make up.  A plain leaf is one block; a DTensor leaf's local
    shard is its row runs (``perturbations.shard_runs``), each with its
    first global index folded into the seeds and the leaf's last dim as
    the stride, so no parameter is communicated."""
    if not is_dtensor(leaf):
        new = torch.empty_like(leaf)
        return [(leaf, new, seeds, None)], new
    from torch.distributed.tensor import DTensor
    local = leaf.to_local()
    new = torch.empty(local.shape, dtype=local.dtype, device=local.device)
    local_shape, offset = pert.shard_layout(leaf)
    blocks = []
    if local.numel():
        for idx, start in pert.shard_runs(tuple(leaf.shape), local_shape,
                                          offset):
            blocks.append((local[idx], new[idx],
                           [pert.shifted_leaf_seed(s, start) for s in seeds],
                           leaf.shape[-1]))
    return blocks, DTensor.from_local(new, leaf.device_mesh, leaf.placements,
                                      run_check=False, shape=leaf.shape,
                                      stride=leaf.stride())


def fused_leaf_updates(cfg: MGDConfig, params, seeds_of, coefs, alpha,
                       small_update):
    """ndim ≥ 2 leaves through one grouped window update — leaf ``lid``'s
    window seeds are ``seeds_of(lid)``, they reach the device in one copy,
    and on the card it is one launch — small leaves through
    ``small_update(leaf, lid)``.  DTensor leaves update their local shards
    (``_update_blocks``)."""
    leaves, treedef = tree_flatten(params)
    metas = leaf_meta(params)
    blocks, out = [], []
    for (lid, _, _), leaf in zip(metas, leaves):
        if leaf.dim() >= 2:
            parts, new = _update_blocks(leaf, seeds_of(lid))
            blocks += parts
            out.append(new)
        else:
            out.append(small_update(leaf, lid))
    if blocks:
        seeds = kops.seeds_tensor([b[2] for b in blocks],
                                  pert.local_device(leaves[0]))
        kops.mgd_update_window_group(
            [b[0] for b in blocks], seeds, coefs, alpha=alpha,
            dtheta=cfg.dtheta, impl=cfg.kernel_impl,
            n_cols=[b[3] for b in blocks], out=[b[1] for b in blocks])
    return tree_unflatten(treedef, out)


def fused_update_tau1(cfg: MGDConfig, params, n: int, c_tilde):
    """The fused step's update at τ_θ = 1: θ ← θ − η·C̃·θ̃/Δθ² at step
    ``n``, θ̃ regenerated in the window-update kernel (``cfg.kernel_impl``
    picks the kernel or its plain version) for every ndim ≥ 2 leaf."""
    seed = _probe_seed(cfg, 0)
    s = c_tilde * f32(1.0 / (cfg.dtheta * cfg.dtheta))
    t = f32(-cfg.eta) * (f32(cfg.dtheta) * s)

    def small(leaf, lid):
        # sign-LAST form of leaf + (−η)·(θ̃·s): the ±1 sign commutes
        # exactly through both roundings, so this equals the
        # materializing path bitwise and no FMA can re-round it
        signs = pert.leaf_theta(leaf, pert.leaf_seed(seed, n // cfg.tau_p,
                                                     lid), 1.0, torch.float32)
        return (leaf.float() + signs * t).to(leaf.dtype)

    def seeds_of(lid):
        return [pert.leaf_seed(seed, n // cfg.tau_p, lid)]

    return fused_leaf_updates(cfg, params, seeds_of, s.reshape(1),
                              -cfg.eta, small)


def _take_slots(buf: torch.Tensor, slots) -> torch.Tensor:
    """``buf[slots]`` for host-int slots, built from slices (no index
    tensor has to reach the device)."""
    parts = []
    start = prev = slots[0]
    for s in slots[1:]:
        if s != prev + 1:
            parts.append(buf[start:prev + 1])
            start = s
        prev = s
    parts.append(buf[start:prev + 1])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def build_mgd_step(
    loss_fn: Optional[Callable],
    cfg: MGDConfig,
    total_params: Optional[int] = None,
    *,
    probe_fn: Optional[Callable] = None,
    plant=None,
):
    """Build the MGD iteration ``step_fn(params, state, batch) ->
    (params, state, metrics)`` (the registry's discrete builder).

    ``loss_fn(params, batch) -> scalar cost`` is the only model interface.
    With ``cfg.fused=True`` the model also provides ``probe_fn(params,
    batch, probe) -> [n_signs]`` costs under θ ± θ̃ (e.g.
    ``models.simple.make_mlp_probe_fn``), which routes weight matmuls
    through the perturbed-matmul kernels.  The caller controls τ_x by
    switching ``batch`` every τ_x calls.
    """
    plant = _resolve_plant(loss_fn, cfg, probe_fn=probe_fn, plant=plant)
    if cfg.fused and not plant.supports_fused:
        raise ValueError("cfg.fused=True needs a probe_fn (the model's "
                         "perturbed-apply interface) on the plant")
    if plant.meta.external:
        # The reference's refusal, kept as it is: its traced step cannot
        # put an ordered host callback inside lax.cond (forward mode's C₀
        # refresh, every windowed update).  This eager step could drive
        # those, but that would be a feature the JAX package lacks.
        if cfg.mode != "central" or cfg.tau_theta != 1 or cfg.replay:
            raise ValueError("external plants need mode='central', "
                             "tau_theta=1, replay=False — the only "
                             "cond-free step an ordered host callback "
                             "can ride (see hardware/external.py)")

    inv_d2 = 1.0 / (cfg.dtheta * cfg.dtheta)
    HALF = f32(0.5)
    INV_D2 = f32(inv_d2)
    NEG_ETA = f32(-cfg.eta)
    DTHETA = f32(cfg.dtheta)
    REPLAY_SCALE = f32(-cfg.eta * inv_d2)
    flags = {}

    def updated_flag(value: bool, device) -> torch.Tensor:
        key = (str(device), bool(value))
        if key not in flags:
            flags[key] = torch.full((), float(value), dtype=torch.float32,
                                    device=device)
        return flags[key]

    def perturbation(params, step, probe=0):
        return pert.generate(params, ptype=cfg.ptype, step=step,
                             seed=_probe_seed(cfg, probe), dtheta=cfg.dtheta,
                             tau_p=cfg.tau_p, total=total_params)

    def need_c0(n):
        return n % cfg.tau_x == 0 or n % cfg.tau_theta == 0

    def probe_once(params, state, batch, probe):
        """One perturbation probe → (C̃, θ̃, c0, cost_metric)."""
        n = state.step
        theta_t = perturbation(params, n, probe)
        if cfg.mode == "central":
            c_plus, c_minus = plant.read_cost_pair(
                params, theta_t, batch, step=n, tag=2 * probe)
            c_tilde = HALF * (c_plus - c_minus)
            return c_tilde, theta_t, state.c0, HALF * (c_plus + c_minus)
        c0 = (plant.read_cost(params, batch, step=n, tag=2 * probe).float()
              if need_c0(n) else state.c0)
        c_pert = plant.read_cost(tree_add(params, theta_t), batch,
                                 step=n, tag=2 * probe + 1)
        return c_pert - c0, theta_t, c0, c0

    def accumulate(params, state, batch):
        """All probes → averaged error signal contribution + scalars."""
        if cfg.probes == 1:
            c_tilde, theta_t, c0, cm = probe_once(params, state, batch, 0)
            return tree_scale(theta_t, c_tilde * INV_D2), c_tilde, c0, cm
        es, cts, c0s, cms = [], [], [], []
        for probe in range(cfg.probes):
            c_tilde, theta_t, c0, cm = probe_once(params, state, batch, probe)
            es.append(tree_scale(theta_t, c_tilde * INV_D2))
            cts.append(c_tilde)
            c0s.append(c0)
            cms.append(cm)
        e = tree_scale(tree_map(lambda *xs: torch.stack(xs).sum(0), *es),
                       1.0 / cfg.probes)
        return (e, torch.stack(cts).mean(), c0s[0],
                torch.stack(cms).mean())

    def apply_update(params, state, g_step):
        """θ ← θ − η·G (Eq. 4) with optional momentum, landed through the
        plant."""
        with tracing.span("mgd.update"):
            m = state.m
            if cfg.momentum:
                m = tree_axpy(1.0, g_step, tree_scale(state.m, cfg.momentum))
                direction = m
            else:
                direction = g_step
            new_params = plant.write_params(
                tree_axpy(NEG_ETA, direction, params), step=state.step,
                prev=params)
            return new_params, m

    # ----- fused probe + update paths (cfg.fused) --------------------------

    def _probe(n, signs):
        ctx = pert.ProbeCtx(signs=signs, dtheta=cfg.dtheta, tau_p=cfg.tau_p,
                            impl=cfg.kernel_impl)
        return pert.Probe(n, _probe_seed(cfg, 0), ctx)

    def probe_once_fused(params, state, batch):
        """Fused probe → (C̃, c0, cost_metric); no θ̃ pytree exists."""
        n = state.step
        if cfg.mode == "central":
            costs = plant.apply_perturbed(
                params, batch, _probe(n, (1.0, -1.0)), step=n, tags=(0, 1))
            c_plus, c_minus = costs[0], costs[1]
            c_tilde = HALF * (c_plus - c_minus)
            return c_tilde, state.c0, HALF * (c_plus + c_minus)
        c0 = (plant.read_cost(params, batch, step=n, tag=0).float()
              if need_c0(n) else state.c0)
        c_pert = plant.apply_perturbed(
            params, batch, _probe(n, (1.0,)), step=n, tags=(1,))[0]
        return c_pert - c0, c0, c0

    def window_steps(n):
        return [n - (cfg.tau_theta - 1) - cfg.staleness + j
                for j in range(cfg.tau_theta)]

    def fused_replay_update(params, state, replay_c):
        """Scalar-replay window update: the J sign regenerations run
        against one read of each W in the window-update kernel."""
        n = state.step
        seed = _probe_seed(cfg, 0)
        window = replay_c.shape[0]
        steps = window_steps(n)
        coefs = REPLAY_SCALE * _take_slots(replay_c,
                                           [s % window for s in steps])

        def small(leaf, lid):
            lf = leaf
            for jj, s in enumerate(steps):
                theta = pert.leaf_theta(
                    lf, pert.leaf_seed(seed, s // cfg.tau_p, lid),
                    cfg.dtheta)
                lf = (lf.float() + coefs[jj] * theta.float()).to(lf.dtype)
            return lf

        def seeds_of(lid):
            return [pert.leaf_seed(seed, s // cfg.tau_p, lid) for s in steps]

        return fused_leaf_updates(cfg, params, seeds_of, coefs, 1.0, small)

    def record(replay_c, n, c_tilde):
        replay_c = replay_c.clone()
        replay_c[n % replay_c.shape[0]] = c_tilde
        return replay_c

    def step_fn_fused(params, state: MGDState, batch):
        n = state.step
        with tracing.span("mgd.probe"):
            c_tilde, c0, cost_metric = probe_once_fused(params, state, batch)
        do_update = (n + 1) % cfg.tau_theta == 0
        metrics = {"cost": cost_metric, "c_tilde": c_tilde,
                   "updated": updated_flag(do_update, c_tilde.device)}
        if cfg.replay:
            replay_c = record(state.replay_c, n, c_tilde)
            new_params = params
            if do_update:
                with tracing.span("mgd.update"):
                    new_params = plant.write_params(
                        fused_replay_update(params, state, replay_c),
                        step=n, prev=params)
            new_state = state._replace(step=n + 1, c0=c0, replay_c=replay_c,
                                       metric_cost=cost_metric)
            return new_params, new_state, metrics
        # tau_theta == 1 (enforced by MGDConfig): update every step
        with tracing.span("mgd.update"):
            new_params = plant.write_params(
                fused_update_tau1(cfg, params, n, c_tilde), step=n,
                prev=params)
        new_state = MGDState(step=n + 1, c0=c0, g=None, replay_c=None, m=None,
                             metric_cost=cost_metric)
        return new_params, new_state, metrics

    # ----- replay-mode update: regenerate θ̃ for the τ_θ window ------------

    def replay_update(params, state, replay_c):
        """θ −= η Σ_j C̃_j·θ̃_j/Δθ² over the last τ_θ steps, θ̃ regenerated."""
        window = replay_c.shape[0]
        p = params
        for s in window_steps(state.step):
            theta_j = perturbation(params, s)
            p = tree_axpy(REPLAY_SCALE * replay_c[s % window], theta_j, p)
        return p

    def traced(step_fn):
        def step(params, state: MGDState, batch):
            with tracing.span("mgd.step", step=state.step):
                return step_fn(params, state, batch)
        return step

    if cfg.fused:
        return traced(step_fn_fused)

    # τ_θ = 1 rademacher updates take the sign-last form θ + sgn·t with
    # t = (−η)·(Δθ·s): sgn·t is exact, so the value equals the written
    # two-step association bitwise, and the fused kernel's too.
    sign_exact_update = (cfg.tau_theta == 1 and cfg.probes == 1
                         and not cfg.momentum and not cfg.replay
                         and cfg.ptype == "rademacher")

    def step_fn(params, state: MGDState, batch):
        n = state.step
        if sign_exact_update and all(leaf.dtype == torch.float32
                                     for leaf in tree_leaves(params)):
            with tracing.span("mgd.probe"):
                c_tilde, _, c0, cost_metric = probe_once(params, state,
                                                         batch, 0)
            with tracing.span("mgd.update"):
                s = c_tilde * INV_D2
                t = NEG_ETA * (DTHETA * s)
                signs = pert.generate_signs_only(
                    params, step=n, seed=_probe_seed(cfg, 0),
                    tau_p=cfg.tau_p)
                new_params = plant.write_params(
                    tree_map(lambda p, g_: p + g_ * t, params, signs),
                    step=n, prev=params)
            new_state = MGDState(step=n + 1, c0=c0, g=None, replay_c=None,
                                 m=None, metric_cost=cost_metric)
            metrics = {"cost": cost_metric, "c_tilde": c_tilde,
                       "updated": updated_flag(True, c_tilde.device)}
            return new_params, new_state, metrics
        with tracing.span("mgd.probe"):
            e, c_tilde, c0, cost_metric = accumulate(params, state, batch)
        do_update = (n + 1) % cfg.tau_theta == 0
        metrics = {"cost": cost_metric, "c_tilde": c_tilde,
                   "updated": updated_flag(do_update, c_tilde.device)}

        if cfg.replay:
            replay_c = record(state.replay_c, n, c_tilde)
            new_params = params
            if do_update:
                with tracing.span("mgd.update"):
                    new_params = plant.write_params(
                        replay_update(params, state, replay_c),
                        step=n, prev=params)
            new_state = state._replace(step=n + 1, c0=c0, replay_c=replay_c,
                                       metric_cost=cost_metric)
            return new_params, new_state, metrics

        if cfg.tau_theta == 1:
            new_params, new_m = apply_update(params, state, e)
            new_g = None
        else:
            g = tree_add(state.g, e)
            if do_update:
                new_params, new_m = apply_update(params, state, g)
                new_g = tree_zeros_like(g)
            else:
                new_params, new_m, new_g = params, state.m, g
        new_state = MGDState(step=n + 1, c0=c0, g=new_g, replay_c=None,
                             m=new_m if cfg.momentum else None,
                             metric_cost=cost_metric)
        return new_params, new_state, metrics

    return traced(step_fn)


def make_mgd_epoch(loss_fn, cfg: MGDConfig, steps_per_call: int,
                   sample_fn: Callable[[int], Any], *,
                   probe_fn: Optional[Callable] = None, plant=None):
    """``run(params, state) -> (params, state, stacked_metrics)`` running
    ``steps_per_call`` MGD iterations of ``build_mgd_step``; iteration n
    uses sample index ``state.step // cfg.tau_x`` (τ_x).  The twin of the
    reference's scanned epoch, as a Python loop; the generic equivalent
    for any driver is ``repro_torch.api.make_epoch``."""
    return epoch_loop(
        build_mgd_step(loss_fn, cfg, probe_fn=probe_fn, plant=plant),
        steps_per_call, sample_fn, lambda state: state.step // cfg.tau_x)
