"""Training loops: MGD (the paper) and backprop + SGD (the baseline).

``train_mgd`` consumes a ``repro_torch.api.MGDDriver`` or a config the
registry resolves (``DriverConfig``, ``MGDConfig``, ``AnalogMGDConfig``).
It runs ``chunk`` steps between host reads, evaluates on a cadence and
records one history entry per chunk.  The loop is eager, so external
plants (``ExternalPlant``, ``ChipFarm``) run step by step like any
other; a plant that keeps writes in flight (a pipelined farm) is fenced
before every eval, recalibration and checkpoint, and at the end, and a
fault-tolerant plant's fault summary is logged once at the end.

Checkpoints carry the driver's FULL state next to the params (whatever
the algorithm keeps: replay window, accumulator, momentum, filter
memories), in the reference's on-disk layout (``training.checkpoint``).
Perturbations and device noise are counter-keyed on the global step, so
a resumed run is the uninterrupted run, bit for bit.

``recal_every`` turns on scheduled recalibration, the lab-bench
mitigation for drifting devices: every ``recal_every`` completed steps
the loop rewrites the device from the shadow parameters
(``recal_params``, by default the initial params) through the plant's
write path.  Boundaries are a pure function of the global step, so a
resumed run replays the same schedule, with one exception it shares with
the reference: recalibration runs only while steps remain, so a run that
ends on a boundary checkpoints parameters that were never recalibrated,
and a run resumed from that checkpoint skips that rewrite.

``TrainResult.checkpoint_s`` holds the seconds of each checkpoint save
and of the restore, device work fenced on both sides.

``train_backprop`` is the comparison baseline: ``torch.autograd``
gradients and plain SGD on the same loss_fn / sampler interface, so a
comparison runs both algorithms on identical models and data.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.api.driver import MGDDriver, driver as build_driver, \
    replace_step, state_step, warn_deprecated
from repro_torch.core.mgd import MGDState
from repro_torch.core.utils import f32, tree_flatten, tree_unflatten
from repro_torch.optim import sgd_init, sgd_step
from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainResult:
    params: Any
    state: Any
    history: list          # list of (step, metric dict)
    steps_done: int
    # {"save": [s, ...], "restore": s}: seconds of each checkpoint write
    # and of the resume's read
    checkpoint_s: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainLoopConfig:
    """Every loop-level knob of ``train_mgd``, in one place."""

    algorithm: Optional[str] = None    # registry name for a DriverConfig
    chunk: int = 100                   # steps between host reads
    eval_fn: Optional[Callable] = None     # eval_fn(params) -> dict
    eval_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = True
    log: Optional[Callable] = print
    probe_fn: Optional[Callable] = None    # fused probe path (cfg.fused)
    plant: Any = None                  # hardware.Plant (None → implicit)
    mesh: Any = None                   # probe-parallel probe mesh
    recal_every: int = 0               # scheduled full-rewrite period
    recal_params: Any = None           # shadow params (None → initial)

    def replace(self, **kw) -> "TrainLoopConfig":
        return dataclasses.replace(self, **kw)


_LOOP_FIELDS = tuple(f.name for f in dataclasses.fields(TrainLoopConfig))


def resolve_driver(loss_fn, cfg, *, probe_fn=None, plant=None, mesh=None,
                   algorithm: Optional[str] = None,
                   device=None) -> MGDDriver:
    """Pass a built ``MGDDriver`` through, or build one from a config."""
    if isinstance(cfg, MGDDriver):
        if loss_fn is not None or probe_fn is not None or plant is not None \
                or mesh is not None or device is not None:
            raise ValueError(
                "got a pre-built MGDDriver AND loss_fn/probe_fn/plant/mesh/"
                "device — those belong to repro_torch.driver(...)")
        return cfg
    if algorithm is None:
        from repro_torch.core.analog import AnalogMGDConfig
        algorithm = "analog" if isinstance(cfg, AnalogMGDConfig) \
            else "discrete"
    return build_driver(algorithm, cfg, loss_fn,
                        probe_fn=probe_fn, plant=plant, mesh=mesh,
                        device=device)


def _ckpt_tree(params, state):
    """Checkpoint payload: params + the driver's full state (``None``
    fields vanish from the flattened tree)."""
    return {"params": params, "state": state}


def _sync(device) -> None:
    """Wait for the card's queued work, so a host timing covers it."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _recalibrate(drv, params, shadow, step):
    """Commit the shadow parameters to the device through the plant's
    write path (DAC grid, write noise and one drift transition all
    apply); with the implicit device the rewrite is the shadow itself."""
    if drv.plant is None:
        return shadow
    return drv.plant.write_params(shadow, step=step, prev=params)


def _restore_any(checkpoint_dir, params, state, log):
    """Restore the newest checkpoint into (params, state), falling back
    through the reference's layouts: full state → buffers-only
    ``{"params", "opt": {g, replay_c, m}}`` (discrete) → params only
    (buffers reset)."""
    try:
        tree, _, start = ckpt.restore(checkpoint_dir,
                                      _ckpt_tree(params, state))
        return tree["params"], tree["state"], start
    except ckpt.CheckpointMismatch:
        pass
    dev = state.c0.device if isinstance(state, MGDState) else None

    def scalars(st, extra):
        return st._replace(
            c0=f32(extra.get("c0", 0.0)).to(dev),
            metric_cost=f32(extra.get("metric_cost", 0.0)).to(dev))

    if isinstance(state, MGDState):
        try:
            tree, extra, start = ckpt.restore(
                checkpoint_dir,
                {"params": params, "opt": {"g": state.g,
                                           "replay_c": state.replay_c,
                                           "m": state.m}})
            state = scalars(state._replace(
                g=tree["opt"]["g"], replay_c=tree["opt"]["replay_c"],
                m=tree["opt"]["m"], step=start), extra)
            return tree["params"], state, start
        except ckpt.CheckpointMismatch:
            pass
    params, extra, start = ckpt.restore(checkpoint_dir, params)
    if log:
        log("[mgd] legacy checkpoint: optimizer buffers reset")
    state = replace_step(state, start)
    if isinstance(state, MGDState):
        state = scalars(state, extra)
    return params, state, start


def train_mgd(
    loss_fn: Optional[Callable],
    params,
    cfg,                # MGDDriver | DriverConfig | (Analog)MGDConfig
    sample_fn: Callable,          # sample_fn(sample_index) -> batch
    num_steps: int,
    *,
    loop: Optional[TrainLoopConfig] = None,
    device=None,
    **flat,                       # legacy flat spelling of TrainLoopConfig
) -> TrainResult:
    """Run an MGD driver for ``num_steps`` iterations.

    ``device`` is where the run lives (the CUDA card unless
    ``device="cpu"``); a pre-built driver carries its own.  With
    ``loop.checkpoint_dir`` the run resumes from the newest checkpoint
    there (unless ``loop.resume`` is False) and saves every
    ``loop.checkpoint_every`` steps.  The reference's flat keywords
    (``chunk=``, ``log=``, ...) build the same ``TrainLoopConfig`` and
    fire one ``PendingDeprecationWarning``.
    """
    if flat:
        unknown = sorted(set(flat) - set(_LOOP_FIELDS))
        if unknown:
            raise TypeError(f"train_mgd got unexpected keyword arguments "
                            f"{unknown}; loop-level knobs are the fields "
                            f"of TrainLoopConfig: {sorted(_LOOP_FIELDS)}")
        if loop is not None:
            raise ValueError(
                f"got loop=TrainLoopConfig(...) AND the flat keywords "
                f"{sorted(flat)} — set every loop knob in one place")
        warn_deprecated(
            "train_mgd's flat loop keywords",
            "train_mgd(..., loop=TrainLoopConfig(...))",
            category=PendingDeprecationWarning)
        loop = TrainLoopConfig(**flat)
    loop = loop or TrainLoopConfig()
    if loop.recal_every < 0:
        raise ValueError(
            f"recal_every must be >= 0, got {loop.recal_every}")
    # shadow taken from the caller's arguments BEFORE any resume: the
    # factory calibration, identical across restarts
    shadow = loop.recal_params if loop.recal_params is not None else params
    drv = resolve_driver(loss_fn, cfg, probe_fn=loop.probe_fn,
                         plant=loop.plant, mesh=loop.mesh,
                         algorithm=loop.algorithm, device=device)
    state = drv.init(params)
    done = 0
    ckdir = loop.checkpoint_dir
    ckpt_s = {}
    if ckdir and loop.resume and ckpt.latest_step(ckdir) is not None:
        _sync(drv.device)
        t_io = time.perf_counter()
        params, state, done = _restore_any(ckdir, params, state, loop.log)
        _sync(drv.device)
        ckpt_s["restore"] = time.perf_counter() - t_io
        if loop.log:
            loop.log(f"[mgd] resumed from step {done}")
    # a plant that keeps writes in flight exposes fence(); boundaries
    # that read the state (eval, recalibration, checkpoint) wait on it
    plant_fence = getattr(drv.plant, "fence", None)
    fence = plant_fence if callable(plant_fence) else (lambda: None)
    history = []
    t0 = time.time()
    while done < num_steps:
        n = min(loop.chunk, num_steps - done)
        if loop.recal_every:
            # stop each chunk at the next recalibration boundary
            n = min(n, loop.recal_every - done % loop.recal_every)
        metrics = {}
        for _ in range(n):
            batch = sample_fn(state_step(state) // drv.tau_x)
            params, state, metrics = drv.step(params, state, batch)
        done += n
        rec = {k: float(v) for k, v in metrics.items()}
        if loop.eval_fn and loop.eval_every and \
                (done % loop.eval_every < loop.chunk):
            fence()
            rec.update({k: float(v) for k, v in loop.eval_fn(params).items()})
        history.append((done, rec))
        if loop.log:
            msg = " ".join(f"{k}={v:.4g}" for k, v in rec.items())
            loop.log(f"[mgd] step {done}/{num_steps} {msg} "
                     f"({(time.time() - t0):.1f}s)")
        if loop.recal_every and done % loop.recal_every == 0 \
                and done < num_steps:
            fence()
            params = _recalibrate(drv, params, shadow, done)
            if loop.log:
                loop.log(f"[mgd] step {done}: scheduled recalibration "
                         f"(full rewrite from shadow params)")
        if ckdir and loop.checkpoint_every and \
                done % loop.checkpoint_every == 0:
            fence()
            _sync(drv.device)
            t_io = time.perf_counter()
            ckpt.save(ckdir, done, _ckpt_tree(params, state),
                      extra={"algo": drv.algorithm,
                             "seed": int(getattr(drv.config, "seed", 0))})
            ckpt_s.setdefault("save", []).append(time.perf_counter() - t_io)
    fence()
    # fault-tolerant plants (ExternalPlant/ChipFarm with a FaultPolicy)
    # expose a telemetry summary — surface it once, so a run that survived
    # faults says so instead of looking clean
    fault_summary = getattr(drv.plant, "fault_summary", None)
    if loop.log and callable(fault_summary):
        summary = fault_summary()
        if summary.get("events"):
            loop.log(f"[mgd] fault-tolerance summary: {summary}")
    return TrainResult(params, state, history, done, ckpt_s)


def _grads(loss_fn, params, batch):
    """∂loss/∂params through autograd, as a tree of params' structure;
    the graph is freed before return."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        live = [x.detach().requires_grad_(True) for x in leaves]
        loss = loss_fn(tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live)
    return tree_unflatten(treedef, list(grads))


def train_backprop(
    loss_fn: Callable,
    params,
    sample_fn: Callable,
    num_steps: int,
    *,
    eta: float,
    momentum: float = 0.0,
    chunk: int = 100,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 0,
    log: Optional[Callable] = print,
) -> TrainResult:
    """The paper's comparison baseline: backprop + plain SGD.

    Runs whole chunks of ``chunk`` steps (step i reads ``sample_fn(i)``)
    until at least ``num_steps`` are done, as the reference's scanned
    chunks do; each chunk's history entry holds the cost of its last
    step's own batch, taken after that step's update."""
    opt_state = sgd_init(params, momentum)
    history = []
    done = 0
    while done < num_steps:
        for i in range(done, done + chunk):
            batch = sample_fn(i)
            params, opt_state = sgd_step(
                params, _grads(loss_fn, params, batch), opt_state, eta=eta,
                momentum=momentum)
        with torch.no_grad():
            loss = loss_fn(params, batch)
        done += chunk
        rec = {"cost": float(loss)}
        if eval_fn and eval_every and (done % eval_every < chunk):
            rec.update({k: float(v) for k, v in eval_fn(params).items()})
        history.append((done, rec))
        if log:
            msg = " ".join(f"{k}={v:.4g}" for k, v in rec.items())
            log(f"[bp ] step {done}/{num_steps} {msg}")
    return TrainResult(params, opt_state, history, done)


def classification_accuracy(apply_fn, params, x, y_onehot):
    """Fraction of argmax matches, the paper's accuracy metric (a 0-dim
    f32 tensor)."""
    with torch.no_grad():
        pred = apply_fn(params, x)
    return (pred.argmax(-1) == y_onehot.argmax(-1)).float().mean()
