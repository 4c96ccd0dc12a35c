"""The twins' runner: the port's counterpart of the reference's
``benchmarks/run.py``.

    python -m repro_torch.benchmarks.run [--only farm,table3] [--seed 7]
                                         [--smoke] [--out DIR]
                                         [--device cpu] [--list]

Runs each selected twin on the CUDA card unless ``--device cpu``, prints
a CSV (bench,name,value,detail) and writes ``DIR/<bench>.json`` as
``{"rows", "seconds", "seed"}`` (plus the device, the card and the smoke
flag).  ``--seed`` and ``--smoke`` reach only the twins that take them,
so that no record claims a seed it did not use.  ``--list`` prints the
registered twins; an ``--only`` substring that matches none exits 2; a
twin that raises makes the runner exit 1 after it has run the rest.
Gate the directory, unedited, with ``python -m
benchmarks.check_regression --fresh DIR --baseline artifacts/bench``.

The twins are registered in the reference's order.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

import torch

from .common import call_run, print_rows, write_record

BENCHES = [
    "scaling_laws",
    "fig4_equivalence",
    "fig5_angle",
    "fig6_tau_theta",
    "fig7_perturbations",
    "fig8_noise",
    "table2_datasets",
    "table3_hardware",
    "hardware_plants",
    "fused_probe",
    "farm_scaling",
    "drift_aging",
    "fault_tolerance",
    "online_serving",
    "roofline_report",
]


def run_bench(name: str, seed: int, smoke: bool, device):
    """(rows, seconds, seed used, smoke used) of one twin."""
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    t0 = time.perf_counter()
    rows, seed_used, smoke_used = call_run(mod.run, seed, smoke, device)
    return rows, time.perf_counter() - t0, seed_used, smoke_used


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark name substrings")
    ap.add_argument("--list", action="store_true",
                    help="print the registered benchmark names and exit")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed for the twins that take run(seed=...)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke=True for the twins that take it (the "
                         "committed baselines' budgets)")
    ap.add_argument("--out", default="bench_torch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.list:
        for name in BENCHES:
            print(name)
        return 0

    selected = BENCHES
    if args.only:
        keys = args.only.split(",")
        unknown = [k for k in keys if not any(k in b for b in BENCHES)]
        if unknown:
            print(f"--only matched no benchmark for {unknown}; "
                  f"registered: {BENCHES}", file=sys.stderr)
            return 2
        selected = [b for b in BENCHES if any(k in b for k in keys)]

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    print("bench,name,value,detail")
    failures = []
    for name in selected:
        try:
            rows, seconds, seed, smoke = run_bench(name, args.seed,
                                                   args.smoke, args.device)
        except Exception as e:    # noqa: BLE001 — report, run the rest
            failures.append((name, repr(e)))
            traceback.print_exc(limit=5, file=sys.stderr)
            continue
        print_rows(rows)
        write_record(args.out, name, rows, seconds, seed, args.device,
                     smoke)
        print(f"# {name} done in {seconds:.1f}s", file=sys.stderr)
    if failures:
        print(f"# FAILURES: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
