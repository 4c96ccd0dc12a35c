"""Scaling laws on the port: ĝ variance and accuracy against the probe
count k and the parameter count N.

    python -m repro_torch.benchmarks.scaling_laws [--out DIR] [--smoke]
                                                  [--device cpu]

The twin of the reference's ``benchmarks/scaling_laws.py``: the same rows
in the same order, seeds and budgets (``--smoke``: 30 rounds, 300 steps),
through ``repro_torch.driver("probe_parallel", cfg, loss,
mesh=LocalMesh(pod=k))``, whose k pods run one after another on one
device (the CUDA card unless ``--device cpu``).  The reference shrinks
its k grid to the devices the host offers; the port always runs all of
``KS`` = (1, 2, 4, 8), the grid of the committed baseline.  Weights come
from the port's own ``mlp_init`` of the reference's seeds.

Sections: ĝ variance against k at frozen params with a replicated batch
(``batch_specs=()``) and with the default pod-sharded batch; ĝ variance
against N at k = 4; XOR accuracy and cost against k; the dyadic
``LinearLaneChip`` law (a 4-pod step ≡ a 4-chip ``shard_batch`` farm,
bitwise, as a 0/1 row gated at zero); and projections for qwen3-14b and
deepseek-v3-671b, whose N counts the leaves of ``launch.specs.
abstract_params`` (the meta device: nothing allocated).

Writes ``DIR/scaling_laws.json`` and prints the rows as CSV.  Gate it,
unedited, with ``python -m benchmarks.check_regression --fresh DIR
--baseline artifacts/bench``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import DriverConfig, driver, replace_step
from repro_torch.core import LocalMesh, mae, mse
from repro_torch.core.utils import tree_leaves, tree_size
from repro_torch.data import tasks
from repro_torch.device import resolve_device
from repro_torch.hardware import ChipFarm, LinearLaneChip, PlantMeta
from repro_torch.models.simple import linear_apply, mlp_apply, mlp_init

from .common import bench_cli

BENCH = "scaling_laws"
KS = (1, 2, 4, 8)
N_K = 4                         # k of the variance-against-N sweep
N_SIZES = ((2, 2, 1), (2, 8, 1), (2, 32, 1))
PROJECTED_ARCHS = ("qwen3-14b", "deepseek-v3-671b")
BITMATCH_PODS = 4
BITMATCH_STEPS = 4
# chip-in-the-loop pricing for the projections (Table-3 HW1 class)
HW1 = PlantMeta(name="HW1", read_latency_s=1e-3, write_latency_s=1e-3)


def _loss(p, b):
    return mse(mlp_apply(p, b["x"]), b["y"])


def _xor8(dev):
    x, y = tasks.xor_dataset(device=dev)
    return {"x": x.repeat(2, 1), "y": y.repeat(2, 1)}


def _host(t):
    return t.detach().cpu().numpy()


def _ghat_samples(sizes, k, rounds, seed, dev, *, replicate_batch):
    """Across-step samples of one averaged-update component at frozen
    params, (w1 − w0)/η a probe round, on k pods."""
    cfg = DriverConfig(dtheta=1e-2, eta=1.0, mode="central", seed=seed)
    kw = {"batch_specs": ()} if replicate_batch else {}
    drv = driver("probe_parallel", cfg, _loss, mesh=LocalMesh(pod=k),
                 device=dev, **kw)
    params = mlp_init(seed, sizes, device=dev)
    state = drv.init(params)
    batch = _xor8(dev)
    w0 = _host(tree_leaves(params)[1])[0, 0]
    samples = []
    for t in range(rounds):
        new_params, _, _ = drv.step(params, replace_step(state, t), batch)
        w1 = _host(tree_leaves(new_params)[1])[0, 0]
        samples.append((w1 - w0) / cfg.eta)
    return samples


def _variance_rows(rounds, seed, dev):
    rows = []
    for flavor, replicate in (("replicated", True), ("sharded", False)):
        variances = {}
        for k in KS:
            variances[k] = float(np.var(
                _ghat_samples((2, 2, 1), k, rounds, seed, dev,
                              replicate_batch=replicate)))
            rows.append({
                "bench": BENCH, "name": f"mesh_ghat_variance_{flavor}_k{k}",
                "value": variances[k],
                "detail": f"{rounds} frozen-param {k}-pod steps; "
                          f"{flavor} batch"})
        for k in KS[1:]:
            rows.append({
                "bench": BENCH, "name": f"mesh_variance_ratio_{flavor}_k{k}",
                "value": (variances[KS[0]] / variances[k]
                          if variances[k] else -1.0),
                "detail": f"var(k=1)/var(k={k}) — ≈{k} if variance ∝ 1/k"
                          + ("" if replicate else
                             "; per-shard objectives differ, law "
                             "saturates (sharded mode)")})
    return rows


def _variance_vs_n_rows(rounds, seed, dev):
    """Single-component ĝ variance across model sizes at k = ``N_K``."""
    rows, measured = [], {}
    for sizes in N_SIZES:
        n = tree_size(mlp_init(0, sizes, device=dev))
        measured[n] = float(np.var(
            _ghat_samples(sizes, N_K, rounds, seed, dev,
                          replicate_batch=True)))
        rows.append({
            "bench": BENCH, "name": f"ghat_variance_N{n}",
            "value": measured[n],
            "detail": f"mlp {sizes}, k={N_K}, {rounds} frozen-param steps"})
    ns = sorted(measured)
    rows.append({
        "bench": BENCH, "name": "variance_slope_N",
        "value": measured[ns[-1]] / measured[ns[0]],
        "detail": f"var(N={ns[-1]})/var(N={ns[0]}) — grows with N "
                  f"(cross-talk term ∝ Σ g_j²)"})
    return rows, measured


def _accuracy_rows(steps, seed, dev):
    """XOR accuracy and cost after a fixed budget on batch-sharded pods."""
    rows = []
    batch = _xor8(dev)
    for k in KS:
        cfg = DriverConfig(dtheta=1e-2, eta=2.0, mode="central", seed=seed)
        drv = driver("probe_parallel", cfg, _loss, mesh=LocalMesh(pod=k),
                     device=dev)
        p = mlp_init(seed, (2, 2, 1), device=dev)
        s = drv.init(p)
        costs = []
        for _ in range(steps):
            p, s, aux = drv.step(p, s, batch)
            costs.append(aux["cost"])
        pred = _host(mlp_apply(p, batch["x"]))
        acc = float(np.mean((pred > 0.5) == (_host(batch["y"]) > 0.5)))
        rows.append({
            "bench": BENCH, "name": f"xor_accuracy_k{k}", "value": acc,
            "detail": f"{steps} steps, batch-sharded {k}-pod step"})
        rows.append({
            "bench": BENCH, "name": f"xor_cost_k{k}",
            "value": float(np.mean([float(c) for c in costs[-10:]])),
            "detail": f"mean cost over final 10 of {steps} steps"})
    return rows


def bitmatch(dev) -> bool:
    """The acceptance law: a batch-sharded 4-pod step ≡ a 4-chip
    ``shard_batch`` ``LinearLaneChip`` farm, bit for bit (f32), over a
    dyadic-exact horizon."""
    def l1(p, b):
        return mae(b["y"], linear_apply(p, b["x"]))

    def init():
        return [{"w": torch.tensor([[0.5], [-0.25]], device=dev),
                 "b": torch.tensor([0.25], device=dev)}]

    batch = _xor8(dev)
    cfg = dict(dtheta=0.5, eta=0.5, mode="central", seed=5)
    drv = driver("probe_parallel", DriverConfig(**cfg), l1,
                 mesh=LocalMesh(pod=BITMATCH_PODS), device=dev)
    with ChipFarm([LinearLaneChip() for _ in range(BITMATCH_PODS)],
                  shard_batch=True) as farm:
        ext = driver("probe_parallel_external", DriverConfig(**cfg),
                     plant=farm, device=dev)
        p_m, s_m = init(), drv.init(init())
        p_f, s_f = init(), ext.init(init())
        match = True
        for _ in range(BITMATCH_STEPS):
            p_m, s_m, _ = drv.step(p_m, s_m, batch)
            p_f, s_f, _ = ext.step(p_f, s_f, batch)
            match &= all(torch.equal(a, b) for a, b in
                         zip(tree_leaves(p_m), tree_leaves(p_f)))
    return match


def _bitmatch_rows(dev):
    return [{
        "bench": BENCH, "name": "mesh_farm_bitmatch_f32",
        "value": 1.0 if bitmatch(dev) else 0.0,
        "detail": f"{BITMATCH_PODS}-pod batch-sharded step vs "
                  f"{BITMATCH_PODS}-chip shard_batch LinearLane farm, "
                  f"{BITMATCH_STEPS} dyadic-exact steps, params "
                  "bit-compared"}]


def _projection_rows(var_by_n):
    """Big-config projections: N from ``abstract_params`` (nothing
    allocated), the N/k probe budget and HW1 step pricing.  Pure
    arithmetic, gated tight."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.specs import abstract_params

    rows = []
    ns = sorted(var_by_n)
    slope = var_by_n[ns[-1]] / ns[-1]        # var ≈ slope · N
    for arch in PROJECTED_ARCHS:
        tag = arch.replace("-", "_")
        n_full = tree_size(abstract_params(get_config(arch)))
        n_smoke = tree_size(abstract_params(get_smoke_config(arch)))
        rows.append({"bench": BENCH, "name": f"params_{tag}",
                     "value": float(n_full),
                     "detail": "abstract_params leaf-size sum"})
        rows.append({"bench": BENCH, "name": f"params_smoke_{tag}",
                     "value": float(n_smoke),
                     "detail": "smoke_config abstract N (CI scale)"})
        for k in (8, 4096):
            rows.append({
                "bench": BENCH, "name": f"projected_probe_budget_{tag}_k{k}",
                "value": float(n_full) / k,
                "detail": "probes-to-target ∝ N/k (follow-up scaling)"})
        rows.append({
            "bench": BENCH, "name": f"projected_step_s_{tag}",
            "value": HW1.step_latency_s(
                reads_per_step=2, writes_per_step=1,
                differential=True, pipelined=True),
            "detail": "HW1 pricing, k concurrent differential pairs, "
                      "pipelined write (k-independent wall-clock)"})
        rows.append({
            "bench": BENCH, "name": f"projected_ghat_variance_{tag}_k8",
            "value": slope * n_full / 8.0,
            "detail": f"measured var/N slope {slope:.3g} × N/k "
                      f"(informational extrapolation)"})
    return rows


def run(seed: int = 0, smoke: bool = False, device=None):
    """The reference's rows at its budgets (``smoke``: the CI cut)."""
    dev = resolve_device(device)
    rounds = 30 if smoke else 100
    steps = 300 if smoke else 800
    rows = _variance_rows(rounds, seed, dev)
    n_rows, var_by_n = _variance_vs_n_rows(rounds, seed, dev)
    rows += n_rows
    rows += _accuracy_rows(steps, seed, dev)
    rows += _bitmatch_rows(dev)
    rows += _projection_rows(var_by_n)
    return rows


def main(argv=None) -> int:
    return bench_cli("scaling_laws", run, argv, doc=__doc__,
                     smoke_help="30 rounds, 300 steps: the committed "
                                "baseline's budget")


if __name__ == "__main__":
    raise SystemExit(main())
