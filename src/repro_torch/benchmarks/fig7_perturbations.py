"""Paper Fig. 7 on the port: the four perturbation types train XOR at
comparable speed (the fixed-bandwidth feedback argument).

    python -m repro_torch.benchmarks.fig7_perturbations [--out DIR]
                                                        [--device cpu]

The twin of the reference's ``benchmarks/fig7_perturbations.py``: the
same 4 rows, seeds and budgets (120,000 steps a run in chunks of
10,000).  Weights come from the port's own ``mlp_init`` of the
reference's seeds.  The whole budget is hours of eager steps on the
card's host; writes ``DIR/fig7_perturbations.json`` and prints the rows
as CSV.
"""
from __future__ import annotations

from repro_torch.core import MGDConfig
from repro_torch.device import resolve_device

from .common import bench_cli, median, time_to_solve_xor

N_SEEDS = 4
TYPES = ("rademacher", "walsh", "sequential", "sinusoidal")


def config(ptype):
    """The paper's protocol: τ_x = 250 (the sample held while the codes
    integrate), τ_θ = 1, one shared η for every type.  Deterministic codes
    (Walsh, sinusoidal) NEED the long τ_x: their orthogonality is only
    realized over a full code period, so sample churn at τ_x = 1 aliases
    with the code structure."""
    return MGDConfig(ptype=ptype, dtheta=1e-2, eta=0.2, tau_theta=1,
                     tau_x=250)


def run(device=None):
    dev = resolve_device(device)
    rows = []
    for ptype in TYPES:
        times = [time_to_solve_xor(config(ptype), s, max_steps=120000,
                                   chunk=10000, device=dev)
                 for s in range(N_SEEDS)]
        solved = [t for t in times if t is not None]
        rows.append({
            "bench": "fig7", "name": f"{ptype}_steps_to_solve",
            "value": median(solved) if solved else -1,
            "detail": f"{len(solved)}/{N_SEEDS} solved (eta=0.2 shared); "
                      "paper: all four types approximately equivalent",
        })
    return rows


def main(argv=None) -> int:
    return bench_cli("fig7_perturbations", run, argv, doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
