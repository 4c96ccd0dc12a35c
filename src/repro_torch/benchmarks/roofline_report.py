"""Roofline + collective-traffic summary over the port's dry-run
artifacts — the twin of the reference's ``benchmarks/roofline_report.py``
and this repo's quantitative version of the paper's §5 broadcast
argument.

Headline number: MGD's gradient-path collective is ONE scalar per step;
backprop's is an O(P) gradient all-reduce.  The rows compare, per
cell of ``python -m repro_torch.launch.dryrun`` (single-pod, untagged;
the cells the reference skips are left out), the H100 roofline terms
(``launch.roofline``) and the hypothetical backprop gradient all-reduce
(2·P/chips bf16 bytes) against MGD's 4-byte scalar.  It reads files
only: no card, no seed.

    python -m repro_torch.benchmarks.roofline_report [--artifacts DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import LINK_BW, roofline_terms

from .common import print_rows

ART = os.path.join("artifacts", "dryrun_torch")


def run(device=None, art_dir: str = ART):
    """The rows; ``device`` is taken for the runner's call and unused."""
    rows = []
    paths = sorted(glob.glob(os.path.join(art_dir, "*_singlepod.json")))
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("tag") or rec.get("skipped"):
            continue
        t = roofline_terms(rec)
        rows.append({
            "bench": "roofline",
            "name": f"{rec['arch']}_{rec['shape']}_dominant",
            "value": round(t["roofline_fraction"], 4),
            "detail": (f"{t['dominant']}-bound; compute {t['compute']:.3g}s "
                       f"memory {t['memory']:.3g}s coll "
                       f"{t['collective']:.3g}s; MODEL/counted "
                       f"{t['flops_ratio']*100:.0f}%"),
        })
        if rec["kind"] == "train":
            # MGD vs backprop feedback-channel bytes
            p = rec["params"]
            bp_allreduce = 2.0 * p * 2 / rec["chips"]   # bf16 ring AR
            mgd_scalar = 4.0                            # one f32 scalar
            rows.append({
                "bench": "roofline",
                "name": f"{rec['arch']}_gradpath_bytes_ratio",
                "value": bp_allreduce / mgd_scalar,
                "detail": (f"backprop grad-AR {bp_allreduce/2**20:.1f} "
                           f"MiB/dev vs MGD scalar 4 B "
                           f"(={bp_allreduce/LINK_BW*1e3:.2f} ms/step "
                           "of pure gradient traffic eliminated)"),
            })
    if not rows:
        return [{"bench": "roofline", "name": "artifacts_missing",
                 "value": -1,
                 "detail": "run python -m repro_torch.launch.dryrun first"}]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", default=ART)
    args = ap.parse_args(argv)
    print("bench,name,value,detail")
    print_rows(run(art_dir=args.artifacts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
