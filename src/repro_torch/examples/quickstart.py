"""Quickstart: train XOR with multiplexed gradient descent.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The entire interface between MGD and the model is ONE scalar-valued
function ``loss_fn(params, batch)`` — no gradients, no model structure.
Every algorithm is built the same way through the driver registry:

    mgd = repro_torch.driver("discrete" | "analog" | "probe_parallel",
                             cfg, loss_fn, plant=..., probe_fn=...,
                             mesh=..., device=...)
    state = mgd.init(params)
    params, state, aux = mgd.step(params, state, batch)

``aux`` always carries ``cost``, ``c_tilde`` (the one-scalar feedback)
and ``grad_norm_proxy``; ``repro_torch.make_epoch`` runs many steps in
one call.
"""
import argparse

import repro_torch as rt
from repro_torch.data.pipeline import dataset_sampler
from repro_torch.data.tasks import xor_dataset

EPOCHS, EPOCH_STEPS = 10, 2000


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    x, y = xor_dataset(device=args.device)
    params = rt.mlp_init(2, (2, 2, 1), device=args.device)  # the paper's 2-2-1

    def loss_fn(p, batch):
        return rt.mse(rt.mlp_apply(p, batch["x"]), batch["y"])

    # τ_p = τ_θ = τ_x = 1 with ±Δθ Rademacher codes == SPSA (paper Fig. 2c)
    cfg = rt.DriverConfig(ptype="rademacher", dtheta=1e-2, eta=1.0,
                          tau_theta=1, tau_x=1, seed=0)
    mgd = rt.driver("discrete", cfg, loss_fn, device=args.device)
    run = rt.make_epoch(mgd, EPOCH_STEPS, dataset_sampler(x, y, 1))
    state = mgd.init(params)
    cost = float("nan")
    for epoch in range(EPOCHS):
        params, state, aux = run(params, state)
        cost = float(rt.mse(rt.mlp_apply(params, x), y))
        print(f"iteration {EPOCH_STEPS * (epoch + 1):6d}: dataset cost "
              f"{cost:.4f} (|grad| proxy "
              f"{float(aux['grad_norm_proxy'][-1]):.3g})")
        if cost < 0.04:
            print("solved (paper threshold 0.04)")
            break
    print("predictions:", [round(float(v), 3)
                           for v in rt.mlp_apply(params, x)[:, 0]])
    return cost


if __name__ == "__main__":
    main()
