"""Paper Fig. 4 on the port: MGD ≡ backprop on XOR as τ_θ grows.

    python -m repro_torch.benchmarks.fig4_equivalence [--out DIR]
                                                      [--device cpu]

The twin of the reference's ``benchmarks/fig4_equivalence.py``: the same
3 rows, seeds and budgets.  Final cost after 40,000 MGD iterations for
τ_θ = τ_x ∈ {1, 100} (median of 5 seeds) against backprop's after 4000
steps at η = 2.0 on batches of 4.  Weights come from the port's own
``mlp_init`` of the reference's seeds.  The whole budget is hours of
eager steps on the card's host; writes ``DIR/fig4_equivalence.json`` and
prints the rows as CSV.
"""
from __future__ import annotations

import torch

from repro_torch.api import DriverConfig, driver, make_epoch
from repro_torch.core import mse
from repro_torch.data import tasks
from repro_torch.data.pipeline import dataset_sampler
from repro_torch.device import resolve_device
from repro_torch.models.simple import mlp_apply, mlp_init
from repro_torch.training.train_loop import train_backprop

from .common import bench_cli, xor_loss

N_SEEDS = 5


def _final_cost(params, x, y):
    with torch.no_grad():
        return float(mse(mlp_apply(params, x), y))


def _mgd_curve(tau, seed, iters=40000, chunk=2000, device=None):
    dev = resolve_device(device)
    x, y = tasks.xor_dataset(device=dev)
    params = mlp_init(seed, (2, 2, 1), device=dev)
    # τ_θ = τ_x = tau: each sample integrated tau steps (batch size 1).
    # G accumulates ∝ τ_θ, so η·τ_θ is held ≈ constant across the sweep
    # (the paper's Fig. 6b max-η ∝ 1/τ_θ observation).
    cfg = DriverConfig(dtheta=1e-2, eta=1.0 / tau if tau > 1 else 1.0,
                       tau_theta=tau, tau_x=tau, seed=seed)
    mgd = driver("discrete", cfg, xor_loss, device=dev)
    run = make_epoch(mgd, chunk, dataset_sampler(x, y, 1))
    state = mgd.init(params)
    for _ in range(iters // chunk):
        params, state, _ = run(params, state)
    return _final_cost(params, x, y)


def _backprop_final(seed, device=None):
    """Backprop's final cost: 4000 SGD steps at η = 2.0, batches of 4."""
    dev = resolve_device(device)
    x, y = tasks.xor_dataset(device=dev)
    res = train_backprop(xor_loss, mlp_init(seed, (2, 2, 1), device=dev),
                         dataset_sampler(x, y, 4), 4000, eta=2.0, log=None)
    return _final_cost(res.params, x, y)


def run(device=None):
    dev = resolve_device(device)
    rows = []
    for tau in (1, 100):
        finals = [_mgd_curve(tau, s, device=dev) for s in range(N_SEEDS)]
        rows.append({
            "bench": "fig4", "name": f"mgd_tau_{tau}_final_cost",
            "value": sorted(finals)[N_SEEDS // 2],
            "detail": f"median of {N_SEEDS} seeds, 40k iterations",
        })
    finals = [_backprop_final(s, device=dev) for s in range(N_SEEDS)]
    rows.append({"bench": "fig4", "name": "backprop_final_cost",
                 "value": sorted(finals)[N_SEEDS // 2],
                 "detail": f"median of {N_SEEDS} seeds, 4k steps"})
    return rows


def main(argv=None) -> int:
    return bench_cli("fig4_equivalence", run, argv, doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
