"""Shared benchmark helpers: driver-based MGD training with early stopping
(the twin of the reference's ``benchmarks/common.py``).

Every benchmark builds its algorithm through ``repro_torch.driver``, so
the same helper drives any registered config against any hardware plant.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import time
from typing import Callable, Optional

import torch

from repro_torch.api import driver as build_driver, make_epoch
from repro_torch.core import mse
from repro_torch.core.utils import tree_leaves
from repro_torch.data import tasks
from repro_torch.data.pipeline import dataset_sampler
from repro_torch.models.simple import mlp_apply, mlp_init


def train_until(loss_fn, params, cfg, sample_fn, *, max_steps: int,
                threshold_fn: Callable, chunk: int = 2000, plant=None,
                algorithm: str = "discrete", device=None):
    """Run an MGD driver ``chunk`` steps at a time until
    ``threshold_fn(params)`` or the budget.  Returns (params, steps_used,
    solved)."""
    drv = build_driver(algorithm, cfg, loss_fn, plant=plant, device=device)
    run = make_epoch(drv, chunk, sample_fn)
    state = drv.init(params)
    steps = 0
    while steps < max_steps:
        params, state, _ = run(params, state)
        steps += chunk
        if threshold_fn(params):
            return params, steps, True
    return params, steps, False


def xor_loss(params, batch):
    return mse(mlp_apply(params, batch["x"]), batch["y"])


def xor_mse(params):
    x, y = tasks.xor_dataset(device=tree_leaves(params)[0].device)
    return float(mse(mlp_apply(params, x), y))


def xor_setup(seed: int, device=None):
    x, y = tasks.xor_dataset(device=device)
    params = mlp_init(seed, (2, 2, 1), device=device)
    return params, xor_loss, dataset_sampler(x, y, 1)


def time_to_solve_xor(cfg, seed: int, max_steps=60000, chunk=2000,
                      plant=None, device=None):
    params, loss_fn, sample_fn = xor_setup(seed, device)
    _, steps, solved = train_until(
        loss_fn, params, cfg, sample_fn, max_steps=max_steps,
        threshold_fn=lambda p: xor_mse(p) < 0.04, chunk=chunk, plant=plant,
        device=device)
    return steps if solved else None


def median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2] if vals else None


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def sync(dev) -> None:
    """Wait for the card's queued work (a no-op on the CPU), before a
    clock read or a host fence."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def call_run(run: Callable, seed: int, smoke: bool, device):
    """``run(device=...)``, with ``seed``/``smoke`` forwarded only where
    the bench takes them, as the reference's runner does.  Returns (rows,
    the seed used or None, whether a smoke budget ran), so that no record
    claims a seed or a budget cut it did not use."""
    params = inspect.signature(run).parameters
    kwargs = {"device": device}
    if "seed" in params:
        kwargs["seed"] = seed
    if "smoke" in params:
        kwargs["smoke"] = smoke
    return run(**kwargs), kwargs.get("seed"), kwargs.get("smoke", False)


def bench_cli(bench: str, run: Callable, argv=None, *, doc: str,
              smoke_help: Optional[str] = None) -> int:
    """The twins' command line: ``[--out DIR] [--smoke] [--device cpu]
    [--seed N]``, with no ``--smoke`` where ``smoke_help`` is None (the
    twin has one budget).  Runs ``run`` through ``call_run``, prints the
    rows as CSV and writes ``DIR/<bench>.json`` (``{"rows", "seconds",
    "seed"}`` as the reference's runner does, plus the device and card).
    Gate it,
    unedited, with ``python -m benchmarks.check_regression --fresh DIR
    --baseline artifacts/bench``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--out", default="bench_torch",
                    help=f"directory for {bench}.json")
    if smoke_help is not None:
        ap.add_argument("--smoke", action="store_true", help=smoke_help)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    rows, seed, smoke = call_run(run, args.seed,
                                 getattr(args, "smoke", False), args.device)
    seconds = time.perf_counter() - t0
    print("bench,name,value,detail")
    print_rows(rows)
    path, card = write_record(args.out, bench, rows, seconds, seed,
                              args.device, smoke)
    print(f"# {bench} done in {seconds:.1f}s ({card}) → {path}")
    return 0


def print_rows(rows) -> None:
    """The rows as CSV lines under ``bench,name,value,detail``."""
    for r in rows:
        detail = str(r["detail"]).replace(",", ";")
        print(f"{r['bench']},{r['name']},{r['value']},{detail}")


def write_record(out: str, bench: str, rows, seconds: float, seed, device,
                 smoke: bool):
    """``out/<bench>.json``: the reference runner's ``{"rows", "seconds",
    "seed"}`` plus the device, the card and the smoke flag."""
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{bench}.json")
    with open(path, "w") as f:
        json.dump({"rows": rows, "seconds": seconds, "seed": seed,
                   "device": str(device), "card": card, "smoke": smoke},
                  f, indent=1)
    return path, card
