"""Paper Table 2 on the port: MGD against backprop on the four tasks.

    python -m repro_torch.benchmarks.table2_datasets [--out DIR] [--smoke]
                                                     [--device cpu]

The twin of the reference's ``benchmarks/table2_datasets.py``: the same
rows (``bench``, ``name``, ``value``, ``detail``), configs, seeds and step
budgets, through ``repro_torch.driver``/``make_epoch`` and
``train_backprop``.  Fashion-MNIST and CIFAR-10 are the procedural
stand-ins of the same shape; the claim is the MGD-against-backprop gap on
the same data at matched budgets.  Weights come from the port's own
generators (``mlp_init``/``*_cnn_init`` of the reference's seeds), so the
rows are the reference's experiment, not its trajectory.

Runs on the CUDA card unless ``--device cpu``.  ``--smoke`` cuts every
step budget (and chunk) by ``SMOKE_CUT``, nothing else.  Writes
``DIR/table2_datasets.json`` (``{"rows", "seconds", "seed"}`` as the
reference's runner does, plus the card, the step counts and seconds of
each training run) and prints the rows as CSV.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.api import driver, make_epoch
from repro_torch.core import MGDConfig, mse
from repro_torch.core.rng import prng_key
from repro_torch.core.utils import tree_size
from repro_torch.data import tasks
from repro_torch.data.pipeline import dataset_sampler, generator_sampler
from repro_torch.models.simple import (cifar_cnn_apply, cifar_cnn_init,
                                       fashion_cnn_apply, fashion_cnn_init,
                                       mlp_apply, mlp_init)
from repro_torch.training.train_loop import (classification_accuracy,
                                             train_backprop)

from .common import card_line

SMOKE_CUT = 100


def _acc(apply_fn, params, x, y):
    return float(classification_accuracy(apply_fn, params, x, y))


def _mse_loss(apply_fn):
    def loss(p, b):
        return mse(apply_fn(p, b["x"]), b["y"])
    return loss


class Runner:
    """Holds the device and the budget cut, and times every training run."""

    def __init__(self, device, smoke: bool):
        self.device = torch.device(device)
        self.cut = SMOKE_CUT if smoke else 1
        self.runs = []

    def steps(self, n: int) -> int:
        return max(1, n // self.cut)

    def _timed(self, name, steps, fn):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        s = time.perf_counter() - t0
        self.runs.append({"run": name, "steps": steps, "s": s,
                          "steps_per_s": steps / s})
        return out

    def mgd(self, name, loss_fn, params, cfg, sample_fn, steps, chunk):
        """The reference's ``_train_mgd``: max(1, steps // chunk) calls of
        a ``chunk``-step epoch."""
        steps, chunk = self.steps(steps), self.steps(chunk)
        mgd = driver("discrete", cfg, loss_fn, device=self.device)
        run = make_epoch(mgd, chunk, sample_fn)
        calls = max(1, steps // chunk)

        def go():
            p, state = params, mgd.init(params)
            for _ in range(calls):
                p, state, _ = run(p, state)
            return p

        return self._timed(name, calls * chunk, go)

    def backprop(self, name, loss_fn, params, sample_fn, steps, *, eta,
                 chunk=100):
        steps, chunk = self.steps(steps), self.steps(chunk)
        res = self._timed(name, -(-steps // chunk) * chunk,
                          lambda: train_backprop(loss_fn, params, sample_fn,
                                                 steps, eta=eta, chunk=chunk,
                                                 log=None))
        return res.params


def run(device="cuda", smoke: bool = False):
    """Table 2's rows."""
    return measure(device, smoke)[0]


def measure(device="cuda", smoke: bool = False):
    """Table 2's rows and the timing of each training run."""
    r = Runner(device, smoke)
    dev = r.device
    rows = []

    # --- XOR (paper: 100% at 1e4 steps) ---
    x, y = tasks.xor_dataset(device=dev)
    loss = _mse_loss(mlp_apply)
    p = mlp_init(2, (2, 2, 1), device=dev)
    cfg = MGDConfig(dtheta=1e-2, eta=1.0, seed=0)
    p = r.mgd("xor_mgd", loss, p, cfg, dataset_sampler(x, y, 1), 10000, 2000)
    rows.append({"bench": "table2", "name": "xor_mgd_1e4_solved",
                 "value": float(float(mse(mlp_apply(p, x), y)) < 0.04),
                 "detail": "paper: 100% (eta=1, dtheta=1e-2 calibrated)"})

    # --- NIST7x7 (paper: 38% @1e4, 81% @1e5) ---
    p = mlp_init(2, (49, 4, 4), device=dev)
    cfg = MGDConfig(dtheta=1e-2, eta=0.1, seed=1)
    sample = generator_sampler(tasks.nist7x7_batch, 1, seed=7, device=dev)
    xe, ye = tasks.nist7x7_batch(prng_key(99), 512, device=dev)
    loss = _mse_loss(mlp_apply)
    p = r.mgd("nist7x7_mgd_1e4", loss, p, cfg, sample, 10000, 5000)
    rows.append({"bench": "table2", "name": "nist7x7_mgd_1e4_acc",
                 "value": _acc(mlp_apply, p, xe, ye),
                 "detail": "paper 38% @1e4 (eta=0.1)"})
    p = r.mgd("nist7x7_mgd_9e4_more", loss, p, cfg, sample, 90000, 15000)
    rows.append({"bench": "table2", "name": "nist7x7_mgd_1e5_acc",
                 "value": _acc(mlp_apply, p, xe, ye),
                 "detail": "paper 81% @1e5"})
    pb = mlp_init(2, (49, 4, 4), device=dev)
    pb = r.backprop("nist7x7_backprop", loss, pb, generator_sampler(
        tasks.nist7x7_batch, 32, seed=7, device=dev), 3000, eta=1.0)
    rows.append({"bench": "table2", "name": "nist7x7_backprop_acc",
                 "value": _acc(mlp_apply, pb, xe, ye),
                 "detail": "paper 99.8%"})

    # --- Fashion-MNIST stand-in CNN (paper: 34.2% @1e4, 88.6% backprop) ---
    loss = _mse_loss(fashion_cnn_apply)
    p = fashion_cnn_init(0, device=dev)
    nparams = tree_size(p)
    cfg = MGDConfig(dtheta=1e-3, eta=1e-4, seed=1)
    sample = generator_sampler(tasks.fashion_batch, 64, seed=3, device=dev)
    p = r.mgd("fashion_mgd", loss, p, cfg, sample, 8000, 2000)
    xe, ye = tasks.fashion_batch(prng_key(98), 512, device=dev)
    rows.append({"bench": "table2", "name": "fashion_cnn_params",
                 "value": nparams,
                 "detail": "paper 14378 (head wiring ambiguity documented)"})
    rows.append({"bench": "table2", "name": "fashion_mgd_8e3_acc",
                 "value": _acc(fashion_cnn_apply, p, xe, ye),
                 "detail": "paper 34.2% @1e4 (procedural stand-in; "
                           "eta=1e-4 dtheta=1e-3 batch 64)"})
    pb = fashion_cnn_init(0, device=dev)
    pb = r.backprop("fashion_backprop", loss, pb, sample, 400, eta=0.02,
                    chunk=200)
    rows.append({"bench": "table2", "name": "fashion_backprop_acc",
                 "value": _acc(fashion_cnn_apply, pb, xe, ye),
                 "detail": "paper 88.6%; same data/arch as the MGD row"})

    # --- CIFAR-10 stand-in CNN (paper 26154 params; 12% @1e4) ---
    loss = _mse_loss(cifar_cnn_apply)
    p = cifar_cnn_init(0, device=dev)
    nparams = tree_size(p)
    cfg = MGDConfig(dtheta=1e-3, eta=5e-5, seed=1)
    sample = generator_sampler(tasks.cifar_batch, 64, seed=4, device=dev)
    p = r.mgd("cifar_mgd", loss, p, cfg, sample, 6000, 2000)
    xe, ye = tasks.cifar_batch(prng_key(97), 512, device=dev)
    rows.append({"bench": "table2", "name": "cifar_cnn_params",
                 "value": nparams, "detail": "paper 26154"})
    rows.append({"bench": "table2", "name": "cifar_mgd_6e3_acc",
                 "value": _acc(cifar_cnn_apply, p, xe, ye),
                 "detail": "paper 12% @1e4 (procedural stand-in)"})
    pb = cifar_cnn_init(0, device=dev)
    pb = r.backprop("cifar_backprop", loss, pb, sample, 400, eta=0.02,
                    chunk=200)
    rows.append({"bench": "table2", "name": "cifar_backprop_acc",
                 "value": _acc(cifar_cnn_apply, pb, xe, ye),
                 "detail": "paper 68%; same data/arch"})
    return rows, r.runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="bench_torch",
                    help="directory for table2_datasets.json")
    ap.add_argument("--smoke", action="store_true",
                    help=f"cut every step budget by {SMOKE_CUT}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line() if args.device == "cuda" else "cpu"
    t0 = time.perf_counter()
    rows, runs = measure(args.device, args.smoke)
    seconds = time.perf_counter() - t0
    print("bench,name,value,detail")
    for r in rows:
        detail = str(r["detail"]).replace(",", ";")
        print(f"{r['bench']},{r['name']},{r['value']},{detail}")
    for rec in runs:
        print(json.dumps(rec))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "table2_datasets.json")
    with open(path, "w") as f:
        json.dump({"rows": rows, "seconds": seconds, "seed": 0,
                   "device": args.device, "card": card, "smoke": args.smoke,
                   "runs": runs}, f, indent=1)
    print(f"# table2_datasets done in {seconds:.1f}s ({card}) → {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
