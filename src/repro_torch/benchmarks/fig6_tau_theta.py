"""Paper Fig. 6 on the port: the effect of τ_θ on XOR training time at
fixed batch size.

    python -m repro_torch.benchmarks.fig6_tau_theta [--out DIR]
                                                    [--device cpu]

The twin of the reference's ``benchmarks/fig6_tau_theta.py``: the same 9
rows, grids, seeds and budgets.  (a) fixed η: batch-1 training slows with
τ_θ, batch-4 barely changes; (b) the max-η sweep, approximated with a
coarse grid per τ_θ that stops at the first η with > 50 % solved.  The
legacy ``MGDConfig`` goes through ``train_until`` to the driver.  Weights
come from the port's own ``mlp_init`` of the reference's seeds.  The
whole budget is hours of eager steps on the card's host; writes
``DIR/fig6_tau_theta.json`` and prints the rows as CSV.
"""
from __future__ import annotations

from repro_torch.core import MGDConfig
from repro_torch.device import resolve_device

from .common import bench_cli, median, time_to_solve_xor

N_SEEDS = 3
TAUS = (1, 4, 16)


def run(device=None):
    dev = resolve_device(device)
    rows = []
    # (a) fixed low eta, batch 1 (tau_x = tau_theta) vs batch 4
    for batch in (1, 4):
        for tau in TAUS:
            tau_x = tau if batch == 1 else max(1, tau // 4)
            cfg = MGDConfig(dtheta=1e-2, eta=0.5, tau_theta=tau,
                            tau_x=tau_x)
            times = [time_to_solve_xor(cfg, s, max_steps=80000, chunk=4000,
                                       device=dev)
                     for s in range(N_SEEDS)]
            solved = [t for t in times if t is not None]
            rows.append({
                "bench": "fig6", "name": f"batch{batch}_tau{tau}_steps",
                "value": median(solved) if solved else -1,
                "detail": f"{len(solved)}/{N_SEEDS} solved, fixed eta=0.5",
            })
    # (b) max-eta per tau (coarse grid)
    for tau in TAUS:
        best = None
        for eta in (8.0, 4.0, 2.0, 1.0, 0.5):
            cfg = MGDConfig(dtheta=1e-2, eta=eta, tau_theta=tau, tau_x=tau)
            times = [time_to_solve_xor(cfg, s, max_steps=40000, chunk=2000,
                                       device=dev)
                     for s in range(N_SEEDS)]
            solved = [t for t in times if t is not None]
            if len(solved) * 2 > N_SEEDS:       # > 50 % convergence
                best = (eta, median(solved))
                break
        rows.append({
            "bench": "fig6", "name": f"max_eta_tau{tau}",
            "value": best[0] if best else -1,
            "detail": f"min median steps {best[1] if best else 'n/a'}; "
                      "paper: max-eta falls as tau_theta grows",
        })
    return rows


def main(argv=None) -> int:
    return bench_cli("fig6_tau_theta", run, argv, doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
