"""Drift/aging study on the port: MGD's online re-trim against scheduled
recalibration.

    python -m repro_torch.benchmarks.drift_aging [--out DIR] [--smoke]
                                                 [--device cpu]

The twin of the reference's ``benchmarks/drift_aging.py``: the same rows,
rates, strategies, seeds and budgets (a 2000-step drift-free reference
run, then 1000-step windows; ``--smoke`` sweeps σ_d ∈ {0.01, 0.08}
without the decay trio, the committed baseline's grid), through
``repro_torch``'s ``train_mgd`` on a ``hardware.DriftingPlant`` whose
stored weights random-walk (or decay toward rest) after every write:

* Train a reference network drift-free → θ* and its accuracy A₀.
* For each σ_d, three strategies from θ* through the same loop:
  ``none`` (η = 0, the device just ages), ``recal`` (η = 0 plus the
  loop's ``recal_every`` rewrite from θ*) and ``mgd`` (continuous
  re-trim: η = 1.6 with 4-probe averaging).
* Rows: tail accuracy per (rate, strategy), each strategy's collapse
  rate, the fraction of A₀ MGD holds where no mitigation collapses (the
  gated headline), and Table-3-style projected seconds per window on an
  HW1-like device.

Runs on the CUDA card unless ``--device cpu``.  Weights come from the
port's own ``mlp_init`` of the reference's seeds and the batches are the
reference's, so the rows are the reference's experiment, not its
trajectory.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import DriverConfig
from repro_torch.core import mse
from repro_torch.core.rng import prng_key
from repro_torch.data import tasks
from repro_torch.data.pipeline import generator_sampler
from repro_torch.device import resolve_device
from repro_torch.hardware import DriftingPlant, IdealPlant, PlantMeta
from repro_torch.models.simple import mlp_apply, mlp_init
from repro_torch.training.train_loop import (TrainLoopConfig,
                                             classification_accuracy,
                                             train_mgd)

from .common import bench_cli

SIZES = (49, 4, 4)
CHANCE = 0.25                          # 4-way nist7x7 classification
RATES = (0.003, 0.01, 0.03, 0.08)      # σ_d sweep (per-step walk std)
SMOKE_RATES = (0.01, 0.08)
DECAY_TAU = 400.0                      # decay-mode relaxation constant
STRATEGIES = ("none", "recal", "mgd")
COLLAPSE_FRAC = 0.5   # collapsed ⇔ above-chance margin falls below ½·(A₀−chance)
RECAL_EVERY = 100
ETA_REF = 0.4                          # drift-free reference training
ETA_RETRIM = 1.6                       # re-trim: strong feedback ...
PROBES_RETRIM = 4                      # ... with 4-probe averaging


def _loss(params, batch):
    return mse(mlp_apply(params, batch["x"]), batch["y"])


def _accuracy(params, xe, ye):
    return float(classification_accuracy(mlp_apply, params, xe, ye))


def reference(seed, steps, dev):
    """Drift-free MGD training → (θ*, A₀)."""
    params = mlp_init(seed, SIZES, device=dev)
    cfg = DriverConfig(dtheta=2e-2, eta=ETA_REF, mode="central", seed=seed)
    res = train_mgd(_loss, params, cfg,
                    generator_sampler(tasks.nist7x7_batch, 8, seed=11,
                                      device=dev), steps,
                    loop=TrainLoopConfig(chunk=max(steps // 4, 1), log=None),
                    device=dev)
    xe, ye = tasks.nist7x7_batch(prng_key(99), 512, device=dev)
    return res.params, _accuracy(res.params, xe, ye)


def strategy_run(strategy, theta_star, plant, seed, steps, dev):
    """One mitigation window from θ* on ``plant``; returns tail accuracy
    (mean of the last 3 evals — recalibration phase averages out)."""
    xe, ye = tasks.nist7x7_batch(prng_key(99), 512, device=dev)
    mgd = strategy == "mgd"
    cfg = DriverConfig(dtheta=2e-2, eta=ETA_RETRIM if mgd else 0.0,
                       probes=PROBES_RETRIM if mgd else 1,
                       mode="central", seed=seed)
    eval_every = max(steps // 8, 1)
    res = train_mgd(
        _loss, theta_star, cfg,
        generator_sampler(tasks.nist7x7_batch, 8, seed=11, device=dev),
        steps,
        loop=TrainLoopConfig(
            plant=plant, chunk=eval_every,
            eval_fn=lambda p: {"acc": _accuracy(p, xe, ye)},
            eval_every=eval_every, log=None,
            recal_every=RECAL_EVERY if strategy == "recal" else 0,
            recal_params=theta_star),
        device=dev)
    accs = [rec["acc"] for _, rec in res.history if "acc" in rec]
    return float(np.mean(accs[-3:]))


def _wallclock_rows(steps):
    """Projected seconds per drift window on an HW1-style device (1 ms
    cost read, 1 ms full-array write): what each mitigation strategy
    COSTS, Table-3 style."""
    hw = PlantMeta(name="HW1-drift", read_latency_s=1e-3,
                   write_latency_s=1e-3)
    per_step = {
        "none": 0.0,                                    # device idles
        "recal": hw.step_latency_s(0, 1) / RECAL_EVERY,  # amortized rewrite
        # one central pair per probe, plus the update write
        "mgd": hw.step_latency_s(2 * PROBES_RETRIM, 1),
    }
    return [{
        "bench": "drift_aging",
        "name": f"projected_{strategy}_s_per_{steps}steps",
        "value": steps * s,
        "detail": "HW1-style 1 ms read/write; recal amortizes one full "
                  f"rewrite per {RECAL_EVERY} steps",
    } for strategy, s in per_step.items()]


def run(seed: int = 0, smoke: bool = False, device=None):
    dev = resolve_device(device)
    rates = SMOKE_RATES if smoke else RATES
    ref_steps = 2000
    window = 1000

    theta_star, a0 = reference(seed, ref_steps, dev)
    collapse_acc = CHANCE + COLLAPSE_FRAC * (a0 - CHANCE)
    rows = [{
        "bench": "drift_aging", "name": "driftfree_accuracy", "value": a0,
        "detail": f"reference MGD training, {ref_steps} steps, nist7x7",
    }]

    tail = {}
    for rate in rates:
        for strategy in STRATEGIES:
            plant = DriftingPlant(IdealPlant(_loss), mode="walk",
                                  drift_rate=rate, seed=seed + 41)
            acc = strategy_run(strategy, theta_star, plant, seed, window,
                               dev)
            tail[(strategy, rate)] = acc
            rows.append({
                "bench": "drift_aging",
                "name": f"acc_{strategy}_rate{rate:g}",
                "value": acc,
                "detail": f"tail accuracy after {window} drift steps; "
                          f"OU walk sigma_d={rate:g}/step",
            })

    collapse = {}
    for strategy in STRATEGIES:
        collapsed = [r for r in rates
                     if tail[(strategy, r)] < collapse_acc]
        collapse[strategy] = min(collapsed) if collapsed else -1.0
        rows.append({
            "bench": "drift_aging",
            "name": f"collapse_rate_{strategy}",
            "value": collapse[strategy],
            "detail": f"first swept sigma_d losing half the above-chance "
                      f"margin (tail acc < {collapse_acc:.3f}; -1: never "
                      f"in sweep)",
        })

    # headline: the fraction of drift-free accuracy continuous MGD holds
    # at the drift rate where the unmitigated device has collapsed
    if collapse["none"] > 0:
        hold = tail[("mgd", collapse["none"])] / a0
        detail = (f"MGD tail acc / A0 at sigma_d={collapse['none']:g} "
                  f"(where no-mitigation collapsed)")
    else:
        hold, detail = -1.0, "no-mitigation never collapsed in this sweep"
    rows.append({
        "bench": "drift_aging", "name": "retrim_hold_frac",
        "value": hold, "detail": detail,
    })

    # decay mode: relaxation toward rest — recalibration's best case
    # (full grid only: the smoke gate covers the walk rows)
    if not smoke:
        for strategy in STRATEGIES:
            plant = DriftingPlant(IdealPlant(_loss), mode="decay",
                                  drift_tau=DECAY_TAU, rest=0.0,
                                  seed=seed + 41)
            acc = strategy_run(strategy, theta_star, plant, seed, window,
                               dev)
            rows.append({
                "bench": "drift_aging",
                "name": f"acc_{strategy}_decay_tau{DECAY_TAU:g}",
                "value": acc,
                "detail": f"tail accuracy, weights relaxing toward 0 with "
                          f"tau_d={DECAY_TAU:g} write events",
            })

    rows += _wallclock_rows(window)
    return rows


def main(argv=None) -> int:
    return bench_cli("drift_aging", run, argv, doc=__doc__,
                     smoke_help="sigma_d in {0.01, 0.08} without the decay "
                                "trio (the committed baseline's grid) "
                                "instead of the full sweep")


if __name__ == "__main__":
    raise SystemExit(main())
