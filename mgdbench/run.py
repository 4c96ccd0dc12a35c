"""Run one cell of the port's benchmark once, on the CUDA card.

    python mgdbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``
(steps in the measured window), ``failed`` (of them, steps whose cost is
not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the check compared,
beside its limit.  The same lines close standard error.  Exits non-zero,
printing no result, without a CUDA card, or if JAX or the JAX package
was loaded.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _prepare() -> None:
    """The checkout's ``src`` and root on the path, and the caches of
    compilers the program may use at fixed paths inside the checkout."""
    for entry in (ROOT / "src", ROOT):
        if str(entry) not in sys.path:
            sys.path.insert(0, str(entry))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".cache" / "mgdbench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare()

    import torch
    from mgdbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    chips = int(cell.work["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mgdbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines, _ = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"mgdbench: the run loaded {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
