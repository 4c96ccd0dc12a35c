"""Training loop: run any MGD driver for a number of steps.

``train_mgd`` consumes a ``repro_torch.api.MGDDriver`` or a config the
registry resolves (``DriverConfig``/``MGDConfig``).  It runs ``chunk``
steps between host reads, evaluates on a cadence and records one history
entry per chunk.  Checkpoint/resume and scheduled recalibration are not
ported yet (ROADMAP "rest of A6") and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.api.driver import MGDDriver, driver as build_driver, \
    state_step


@dataclasses.dataclass
class TrainResult:
    params: Any
    state: Any
    history: list          # list of (step, metric dict)
    steps_done: int


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
    return build_driver(algorithm or "discrete", cfg, loss_fn,
                        probe_fn=probe_fn, plant=plant, mesh=mesh,
                        device=device)


def train_mgd(
    loss_fn: Optional[Callable],
    params,
    cfg,                          # MGDDriver | DriverConfig | MGDConfig
    sample_fn: Callable,          # sample_fn(sample_index) -> batch
    num_steps: int,
    *,
    loop: Optional[TrainLoopConfig] = None,
    device=None,
) -> TrainResult:
    """Run an MGD driver for ``num_steps`` iterations.

    ``device`` is where the run lives (the CUDA card unless
    ``device="cpu"``); a pre-built driver carries its own.
    """
    loop = loop or TrainLoopConfig()
    if loop.checkpoint_dir or loop.checkpoint_every:
        raise NotImplementedError("checkpoint/resume is not ported to "
                                  "repro_torch yet (ROADMAP rest of A6)")
    if loop.recal_every or loop.recal_params is not None:
        raise NotImplementedError("scheduled recalibration is not ported "
                                  "to repro_torch yet (ROADMAP rest of A6)")
    drv = resolve_driver(loss_fn, cfg, probe_fn=loop.probe_fn,
                         plant=loop.plant, mesh=loop.mesh,
                         algorithm=loop.algorithm, device=device)
    state = drv.init(params)
    history = []
    done = 0
    t0 = time.time()
    while done < num_steps:
        n = min(loop.chunk, num_steps - done)
        metrics = {}
        for _ in range(n):
            batch = sample_fn(state_step(state) // drv.tau_x)
            params, state, metrics = drv.step(params, state, batch)
        done += n
        rec = {k: float(v) for k, v in metrics.items()}
        if loop.eval_fn and loop.eval_every and \
                (done % loop.eval_every < loop.chunk):
            rec.update({k: float(v) for k, v in loop.eval_fn(params).items()})
        history.append((done, rec))
        if loop.log:
            msg = " ".join(f"{k}={v:.4g}" for k, v in rec.items())
            loop.log(f"[mgd] step {done}/{num_steps} {msg} "
                     f"({(time.time() - t0):.1f}s)")
    return TrainResult(params, state, history, done)
