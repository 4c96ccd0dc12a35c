"""Farm scaling on the port: probe-parallel MGD over k external chips.

    python -m repro_torch.benchmarks.farm_scaling [--out DIR] [--smoke]
                                                  [--device cpu]
    python -m repro_torch.benchmarks.farm_scaling --backend process --smoke

The twin of the reference's ``benchmarks/farm_scaling.py``: the same
rows in the same order, farms, seeds and budgets (``--smoke``: ks
(1, 2, 4), 24 variance rounds, 300 NIST7x7 steps, 8 throughput steps at
25 ms busy; the budget of the committed ``artifacts/bench/
farm_scaling.json``), all through ``repro_torch.driver(
"probe_parallel_external", cfg, plant=ChipFarm(...))``.  The driver's
params, perturbations and update live on the CUDA card unless
``--device cpu``; the chips are the numpy chips on the host (threads,
or forked workers for the process backend).  Weights come from the
port's own ``mlp_init`` of the reference's seeds.

Sections: the ĝ variance against k at frozen params (matched and
diverse chips), NIST7x7 accuracy against k, the projected wall-clock
of 1e4 HW1 steps (``PlantMeta`` arithmetic), and measured steps/s of
GIL-holding chips on the thread and process backends with the
double-buffered pipeline on.  The card is synchronised before every
``farm.fence()`` and clock read: the host must not race its own queued
step.  The process backend forks its workers after CUDA has initialised
in this process; that is safe only because the workers never touch
CUDA (``hardware/backend/base.py``: they are numpy-pure).

Writes ``DIR/farm_scaling.json`` and prints the rows as CSV; the
``--backend`` form sweeps the throughput section alone and writes
nothing.  Gate the JSON, unedited, with ``python -m
benchmarks.check_regression --fresh DIR --baseline artifacts/bench``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from repro_torch.api import DriverConfig, driver, replace_step
from repro_torch.core.rng import prng_key
from repro_torch.core.utils import tree_leaves
from repro_torch.data import tasks
from repro_torch.data.pipeline import generator_sampler
from repro_torch.device import resolve_device
from repro_torch.hardware import PlantMeta, simulated_chip_farm
from repro_torch.hardware.devices import _hold_gil_busy
from repro_torch.models.simple import mlp_init
from repro_torch.training.train_loop import TrainLoopConfig, train_mgd

from .common import bench_cli, median, sync

KS = (1, 2, 4, 8)
SMOKE_KS = (1, 2, 4)
N_SEEDS = 3
THROUGHPUT_BACKENDS = ("thread", "process")

# MATCHED chips (no defects, no write noise: k iid probe estimates, the
# textbook 1/k) and DIVERSE chips (σ_a defects + σ_θ writes: the law
# saturates), as the reference's
VARIANCE_CHIPS = [
    ("matched", dict(sigma_a=0.0, sigma_theta=0.0, sigma_c=1e-3)),
    ("diverse", dict(sigma_a=0.1, sigma_theta=0.01, sigma_c=1e-3)),
]


def _host(t):
    return t.detach().cpu().numpy()


def _xor(dev):
    x, y = tasks.xor_dataset(device=dev)
    return {"x": x, "y": y}


def _variance_rows(ks, rounds, seed, dev):
    """Across-step variance of one averaged-update component at frozen
    params: the C̃-estimator variance the farm averages down."""
    batch = _xor(dev)
    params = mlp_init(seed, (2, 2, 1), device=dev)
    cfg = DriverConfig(dtheta=1e-2, eta=1.0, mode="central", seed=seed)
    w0 = _host(tree_leaves(params)[1])[0, 0]
    rows = []
    for flavor, chip_kw in VARIANCE_CHIPS:
        variances = {}
        for k in ks:
            with simulated_chip_farm(k, (2, 2, 1), base_seed=seed,
                                     **chip_kw) as farm:
                mgd = driver("probe_parallel_external", cfg, plant=farm,
                             device=dev)
                state = mgd.init(params)
                samples = []
                for t in range(rounds):
                    new_params, _, _ = mgd.step(params,
                                                replace_step(state, t), batch)
                    w1 = _host(tree_leaves(new_params)[1])[0, 0]
                    samples.append((w1 - w0) / cfg.eta)   # one ĝ component
            variances[k] = float(np.var(samples))
            rows.append({
                "bench": "farm_scaling",
                "name": f"ghat_variance_{flavor}_k{k}",
                "value": variances[k],
                "detail": f"{rounds} frozen-param steps; {flavor} chips "
                          f"{chip_kw}",
            })
        for k in ks[1:]:
            rows.append({
                "bench": "farm_scaling",
                "name": f"variance_ratio_{flavor}_k{k}",
                "value": (variances[ks[0]] / variances[k]
                          if variances[k] else -1),
                "detail": f"var(k=1)/var(k={k}) — ≈{k} if variance ∝ 1/k",
            })
    return rows


def _convergence_rows(ks, steps, seed, n_seeds, dev):
    """NIST7x7 accuracy (mean on-chip readout across the farm) after a
    fixed budget, against farm size; η = 0.125·k (linear scaling)."""
    rows = []
    xe, ye = tasks.nist7x7_batch(prng_key(99), 512, device=dev)
    eval_batch = {"x": xe, "y": ye}
    for k in ks:
        cfg = DriverConfig(dtheta=2e-2, eta=0.125 * k, mode="central",
                           seed=seed)
        accs = []
        for s in range(seed, seed + n_seeds):
            with simulated_chip_farm(k, (49, 4, 4), base_seed=100 * s,
                                     sigma_a=0.15, sigma_theta=0.01,
                                     sigma_c=1e-4) as farm:
                res = train_mgd(
                    None, mlp_init(s, (49, 4, 4), device=dev),
                    cfg.replace(seed=s),
                    generator_sampler(tasks.nist7x7_batch, 8, seed=11 + s,
                                      device=dev), steps,
                    loop=TrainLoopConfig(
                        algorithm="probe_parallel_external", plant=farm,
                        chunk=max(steps // 4, 1), log=None), device=dev)
                accs.append(float(farm.measure_accuracy(res.params,
                                                        eval_batch)))
        rows.append({
            "bench": "farm_scaling", "name": f"nist7x7_k{k}_accuracy",
            "value": median(accs),
            "detail": f"median of {n_seeds} farms, {steps} steps, "
                      f"eta=0.125k, mean on-chip readout",
        })
    return rows


def _latency_rows(ks):
    """Projected wall-clock of 1e4 steps on HW1-style chips (1 ms cost
    read): k serial probes on one chip against one concurrent farm
    pair."""
    rows = []
    serial = PlantMeta(name="HW1-serial", read_latency_s=1e-3, external=True)
    for k in ks:
        farm = PlantMeta(name=f"HW1-farm-{k}", read_latency_s=1e-3,
                         external=True, chips=k)
        rows.append({
            "bench": "farm_scaling", "name": f"projected_1e4steps_k{k}_s",
            "value": 1e4 * farm.step_latency_s(reads_per_step=2,
                                               writes_per_step=0),
            "detail": f"farm: 2 concurrent reads/step; serial k-probe "
                      f"chip would need "
                      f"{1e4 * serial.step_latency_s(2 * k, 0):.0f}s",
        })
    return rows


def _throughput_rows(ks, smoke, dev, backends=THROUGHPUT_BACKENDS):
    """Measured steps/s through ``py_busy_ms`` farms a backend, pipeline
    on.  A chip holds the GIL ``busy_ms`` a readout conversion (2 a
    central pair), so the thread backend serializes across chips and the
    process backend (one GIL a worker) stays flat in k.  ``detail`` gives
    both the hold asked for and one hold timed on this host (``usleep``
    may sleep far longer than asked)."""
    busy_ms = 25.0 if smoke else 50.0
    t0 = time.perf_counter()
    _hold_gil_busy(busy_ms)
    held_ms = 1e3 * (time.perf_counter() - t0)
    n_steps = 8 if smoke else 16
    batch = _xor(dev)
    params = mlp_init(0, (2, 2, 1), device=dev)
    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=0)
    cores = len(os.sched_getaffinity(0))
    rows = []
    step_s, util = {}, {}
    for backend in backends:
        for k in ks:
            # the process backend forks here, after CUDA is initialised:
            # safe because its workers are numpy-pure and never touch CUDA
            with simulated_chip_farm(k, (2, 2, 1), base_seed=0,
                                     sigma_a=0.0, sigma_theta=0.0,
                                     sigma_c=1e-3, py_busy_ms=busy_ms,
                                     backend=backend,
                                     pipeline=True) as farm:
                mgd = driver("probe_parallel_external", cfg, plant=farm,
                             device=dev)
                p, s = params, mgd.init(params)
                for _ in range(3):                 # worker warm-up
                    p, s, _ = mgd.step(p, s, batch)
                sync(dev)
                farm.fence()
                b0 = farm.backend.busy_seconds()
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    p, s, _ = mgd.step(p, s, batch)
                sync(dev)
                farm.fence()
                wall = time.perf_counter() - t0
                busy = farm.backend.busy_seconds() - b0
            step_s[backend, k] = wall / n_steps
            util[backend, k] = busy / (wall * k) if wall else 0.0
            rows.append({
                "bench": "farm_scaling",
                "name": f"steps_per_s_{backend}_k{k}",
                "value": n_steps / wall,
                "detail": f"{1e3 * wall / n_steps:.1f} ms/step, "
                          f"busy {busy_ms} ms/conversion asked, "
                          f"{held_ms:.1f} ms held, "
                          f"util {util[backend, k]:.2f}, {cores} cores, "
                          f"optimizer on {dev.type}",
            })
    kmax = max(ks)
    if "process" in backends:
        rows.append({
            "bench": "farm_scaling",
            "name": f"wallclock_flat_process_k{kmax}",
            "value": step_s["process", kmax] / step_s["process", 1],
            "detail": f"process step-time ratio k={kmax} vs k=1 — "
                      "~1.0 when the farm is flat in k (target <= 1.25)",
        })
        rows.append({
            "bench": "farm_scaling",
            "name": f"pipeline_utilization_process_k{kmax}",
            "value": util["process", kmax],
            "detail": f"device-busy / (k x wall) at k={kmax}, "
                      "double-buffered (target >= 0.8)",
        })
    if "thread" in backends and "process" in backends:
        rows.append({
            "bench": "farm_scaling",
            "name": f"thread_over_process_k{kmax}",
            "value": step_s["thread", kmax] / step_s["process", kmax],
            "detail": f"GIL-bound thread farm serializes: ~{kmax}x the "
                      "process step time at the same k",
        })
    return rows


def run(seed: int = 0, smoke: bool = False, device=None):
    """The reference's rows at its budgets (``smoke``: the CI cut)."""
    dev = resolve_device(device)
    ks = SMOKE_KS if smoke else KS
    rounds = 24 if smoke else 192
    steps = 300 if smoke else 3000
    rows = _variance_rows(ks, rounds, seed, dev)
    rows += _convergence_rows(ks, steps, seed, 1 if smoke else N_SEEDS, dev)
    rows += _latency_rows(ks)
    rows += _throughput_rows(ks, smoke, dev)
    return rows


def sweep(argv=None) -> int:
    """The standalone backend sweep: the throughput section of one or
    more backends, printed as CSV."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=list(THROUGHPUT_BACKENDS),
                    action="append", required=True,
                    help="backend(s) to sweep")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    cli = ap.parse_args(argv)
    out = _throughput_rows(SMOKE_KS if cli.smoke else KS, cli.smoke,
                           resolve_device(cli.device), tuple(cli.backend))
    for row in out:
        print(f"{row['bench']},{row['name']},{row['value']:.6g},"
              f"\"{row['detail']}\"")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if any(a == "--backend" or a.startswith("--backend=") for a in argv):
        return sweep(argv)
    return bench_cli("farm_scaling", run, argv, doc=__doc__,
                     smoke_help="ks (1, 2, 4), 24 rounds, 300 steps, 8 "
                                "throughput steps: the committed "
                                "baseline's budget")


if __name__ == "__main__":
    raise SystemExit(main())
