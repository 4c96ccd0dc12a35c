"""Paper Table 3 on the port: projected wall-clock training time on
hardware.

    python -m repro_torch.benchmarks.table3_hardware [--out DIR]
                                                     [--device cpu]

The twin of the reference's ``benchmarks/table3_hardware.py``: the same
23 rows in the same order.  The 21 ``*_seconds`` rows are
``PlantMeta.step_latency_s`` arithmetic over Table 2's step budgets
(``HW``, ``HW_WRITE``, ``STEPS`` and ``PAPER`` are copies of the
reference's tables).  The two backprop rows time this package's
``train_backprop`` (2000 XOR steps; 40 Fashion steps at batch 256) on
the device the twin runs on (the CUDA card unless ``--device cpu``);
their names keep the reference's ``_cpu_`` so that the regression gate
finds them, and ``detail`` says which device and card ran them.

Writes ``DIR/table3_hardware.json`` and prints the rows as CSV.  Gate
it, unedited, with ``python -m benchmarks.check_regression --fresh DIR
--baseline artifacts/bench``.
"""
from __future__ import annotations

import time

from repro_torch.core import mse
from repro_torch.data import tasks
from repro_torch.data.pipeline import dataset_sampler, generator_sampler
from repro_torch.device import resolve_device
from repro_torch.hardware import PlantMeta
from repro_torch.models.simple import (fashion_cnn_apply, fashion_cnn_init,
                                       mlp_apply, mlp_init)
from repro_torch.training.train_loop import train_backprop

from .common import bench_cli, card_line, sync

# the paper's three hardware rows as plant metadata (the reference's): the
# per-step clock is the cost readout (τ_p), write latency folded into it
HW = {
    "HW1_chip_in_loop": PlantMeta(name="HW1", read_latency_s=1e-3,
                                  external=True),          # τ_p = 1 ms
    "HW2_memcompute": PlantMeta(name="HW2", read_latency_s=10e-9),
    "HW3_superconducting": PlantMeta(name="HW3", read_latency_s=200e-12),
}
# write-capable variants of the fast rows: every persistent write paid at
# the readout clock (τ_w = τ_p), pricing the central pair (2 reads + 1
# write a step) and its fused upgrade (differential pair, pipelined write)
HW_WRITE = {
    "HW2_memcompute": PlantMeta(name="HW2w", read_latency_s=10e-9,
                                write_latency_s=10e-9),
    "HW3_superconducting": PlantMeta(name="HW3w", read_latency_s=200e-12,
                                     write_latency_s=200e-12),
}
STEPS = {"2bit_parity": 1e4, "fashion_mnist": 1e6, "cifar10": 1e7}
PAPER = {  # (HW1, HW2, HW3, backprop) from the paper's Table 3
    "2bit_parity": ("20 s", "200 us", "4 us", "70 ms CPU"),
    "fashion_mnist": ("33 min", "20 ms", "400 us", "54 s GPU"),
    "cifar10": ("5.6 h", "200 ms", "4 ms", "480 s GPU"),
}
XOR_BP_STEPS = 2000
FASHION_BP_STEPS = 40


def projection_rows():
    """The 21 pure-arithmetic ``*_seconds`` rows."""
    rows = []
    for task, steps in STEPS.items():
        for hw, meta in HW.items():
            rows.append({
                "bench": "table3", "name": f"{task}_{hw}_seconds",
                "value": steps * meta.step_latency_s(reads_per_step=1,
                                                     writes_per_step=0),
                "detail": f"paper: {PAPER[task]}",
            })
    for task, steps in STEPS.items():
        for hw, meta in HW_WRITE.items():
            central = meta.step_latency_s(reads_per_step=2,
                                          writes_per_step=1)
            fused = meta.step_latency_s(reads_per_step=2, writes_per_step=1,
                                        differential=True, pipelined=True)
            rows.append({
                "bench": "table3", "name": f"{task}_{hw}_central_seconds",
                "value": steps * central,
                "detail": "2 reads + 1 write per step, tau_w = tau_p",
            })
            rows.append({
                "bench": "table3", "name": f"{task}_{hw}_fused_seconds",
                "value": steps * fused,
                "detail": "differential pair (1 read) + pipelined write "
                          f"-> max(tau_r, tau_w); {central / fused:.1f}x "
                          "over central",
            })
    return rows


def _timed_backprop(loss, params, sample, steps, eta, chunk, dev):
    sync(dev)
    t0 = time.perf_counter()
    train_backprop(loss, params, sample, steps, eta=eta,
                   chunk=min(chunk, steps), log=None)
    sync(dev)
    return (time.perf_counter() - t0) / steps


def backprop_rows(dev):
    """Backprop's measured step time on ``dev``, as the reference's two
    rows."""
    where = f"{dev.type}: {card_line() if dev.type == 'cuda' else 'host'}"
    x, y = tasks.xor_dataset(device=dev)

    def loss(p, b):
        return mse(mlp_apply(p, b["x"]), b["y"])

    per_step = _timed_backprop(loss, mlp_init(0, (2, 2, 1), device=dev),
                               dataset_sampler(x, y, 4), XOR_BP_STEPS,
                               2.0, 1000, dev)
    rows = [{"bench": "table3", "name": "2bit_parity_backprop_cpu_s",
             "value": per_step * 1e4,
             "detail": f"measured {per_step*1e6:.1f} us/step on {where}; "
                       "paper CPU 70 ms total"}]

    def floss(p, b):
        return mse(fashion_cnn_apply(p, b["x"]), b["y"])

    per_step = _timed_backprop(
        floss, fashion_cnn_init(0, device=dev),
        generator_sampler(tasks.fashion_batch, 256, seed=3, device=dev),
        FASHION_BP_STEPS, 1.0, 20, dev)
    rows.append({"bench": "table3", "name": "fashion_backprop_cpu_s_1e6",
                 "value": per_step * 1e6,
                 "detail": f"measured {per_step*1e3:.1f} ms/step (batch "
                           f"256) on {where}; paper GPU 54 s — MGD on "
                           "HW2/HW3 projects orders of magnitude faster"})
    return rows


def run(device=None):
    """The reference's 23 rows (it has no smoke budget or seed)."""
    return projection_rows() + backprop_rows(resolve_device(device))


def main(argv=None) -> int:
    return bench_cli("table3_hardware", run, argv, doc=__doc__,
                     smoke_help="accepted for the runner's sake; the "
                                "bench has one budget")


if __name__ == "__main__":
    raise SystemExit(main())
