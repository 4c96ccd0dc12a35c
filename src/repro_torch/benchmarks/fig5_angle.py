"""Paper Fig. 5 on the port: the angle between G and the true gradient
against integration time, for 2-bit parity (9 params), 4-bit parity (25)
and NIST7x7 (220).

    python -m repro_torch.benchmarks.fig5_angle [--out DIR] [--device cpu]

The twin of the reference's ``benchmarks/fig5_angle.py``: the same 9
rows, seeds and budgets.  η = 0 and τ_θ = 10⁹, so G only accumulates;
its angle to the backprop gradient is read at steps 100, 1000 and 10,000
(median of 5 seeds).  The reference jits its step; the twin calls the
driver's step eagerly, one step a call.  Weights come from the port's own
``mlp_init`` of the reference's seeds; the NIST7x7 batch is the
reference's draw (``core.rng``).  Writes ``DIR/fig5_angle.json`` and
prints the rows as CSV.
"""
from __future__ import annotations

from repro_torch.api import DriverConfig, driver
from repro_torch.core import mse, rng
from repro_torch.core.forward_grad import gradient_angle, true_gradient
from repro_torch.data import tasks
from repro_torch.device import resolve_device
from repro_torch.models.simple import mlp_apply, mlp_init

from .common import bench_cli

CHECKPOINTS = (100, 1000, 10000)
N_SEEDS = 5


def _loss(p, b):
    return mse(mlp_apply(p, b["x"]), b["y"])


def _angles(sizes, batch, seeds=N_SEEDS, iters=max(CHECKPOINTS),
            device=None):
    dev = resolve_device(device)
    out = {t: [] for t in CHECKPOINTS}
    for seed in range(seeds):
        params = mlp_init(seed, sizes, device=dev)
        # τ_θ = 10⁹ stays a Python int: the update never comes, and no
        # buffer is sized by it (no replay window)
        cfg = DriverConfig(dtheta=1e-3, eta=0.0, tau_theta=10**9, seed=seed)
        mgd = driver("discrete", cfg, _loss, device=dev)
        state = mgd.init(params)
        g_true = true_gradient(_loss, params, batch)
        p = params
        for t in range(1, iters + 1):
            p, state, _ = mgd.step(p, state, batch)
            if t in CHECKPOINTS:
                out[t].append(float(gradient_angle(state.g, g_true)))
    # (a cut run, iters < max(CHECKPOINTS), reports the checkpoints it
    # reached)
    return {t: sorted(v)[len(v) // 2] for t, v in out.items() if v}


def run(device=None):
    dev = resolve_device(device)
    rows = []
    for name, sizes, data in [
        ("parity2", (2, 2, 1), tasks.parity_dataset(2, device=dev)),
        ("parity4", (4, 4, 1), tasks.parity_dataset(4, device=dev)),
        ("nist7x7", (49, 4, 4), tasks.nist7x7_batch(rng.prng_key(0), 64,
                                                    device=dev)),
    ]:
        batch = {"x": data[0], "y": data[1]}
        angles = _angles(sizes, batch, device=dev)
        for t, a in angles.items():
            rows.append({"bench": "fig5", "name": f"{name}_angle_t{t}",
                         "value": a, "detail": "median rad; expect "
                         "monotone decrease with t, larger nets slower"})
    return rows


def main(argv=None) -> int:
    return bench_cli("fig5_angle", run, argv, doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
