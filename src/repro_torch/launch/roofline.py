"""Roofline analysis over the port's dry-run artifacts.

The twin of the reference's ``launch/roofline.py``, with the H100's own
numbers.  Hardware model (NVIDIA H100 SXM5 data sheet values, per GPU —
not measurements):

    PEAK_FLOPS = 989e12 /s    dense bf16 tensor-core peak at the 700 W
                              limit (the one ``chip_smoke.py`` uses)
    HBM_BW     = 3.35e12 B/s  HBM3 bandwidth
    LINK_BW    = 50e9 B/s     one 400 Gb/s NDR InfiniBand NIC per GPU:
                              the production meshes' 16-wide axes cross
                              nodes of 8, so their collectives ride it

Terms per (arch × shape × mesh) cell, per MGD step (or serve step):
    compute    = global_FLOPs / (chips × peak)
    memory     = global_bytes / (chips × HBM_bw)
    collective = per-device wire bytes / link_bw

FLOPs/bytes are ``launch.op_cost``'s global logical counts; bytes are a
streaming estimate (matmul operands + results, gather results): fusion
can beat it, gathers can exceed it; treat as ±2×.  Collective bytes are
``launch.comm_bytes``'s per-rank wire bytes.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

PEAK_FLOPS = 989e12         # bf16 dense / GPU (H100 SXM data sheet)
HBM_BW = 3.35e12            # bytes/s / GPU (HBM3, data sheet)
LINK_BW = 50e9              # bytes/s / GPU (400 Gb/s NDR InfiniBand)
HBM_GB = 80                 # device memory / GPU


def load_artifacts(art_dir: str) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def roofline_terms(rec: dict) -> dict:
    chips = rec["chips"]
    t_compute = rec["counted_flops"] / (chips * PEAK_FLOPS)
    t_memory = rec["counted_bytes"] / (chips * HBM_BW)
    t_coll = rec["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = rec["model_flops"]
    return {
        **terms,
        "dominant": dominant,
        "step_time_bound": bound,
        "model_flops": useful,
        "flops_ratio": useful / max(rec["counted_flops"], 1),
        # achievable fraction of compute roofline if perfectly overlapped
        "roofline_fraction": t_compute / max(bound, 1e-30),
        "mfu_bound": useful / max(bound, 1e-30) / (chips * PEAK_FLOPS),
    }


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _ran(records, multi_pod, tag=""):
    return [r for r in records if r["multi_pod"] == multi_pod
            and r.get("tag", "") == tag and not r.get("skipped")]


def table(records: List[dict], *, multi_pod=False, tag="") -> str:
    rows = []
    hdr = ("| arch | shape | chips | compute | memory | collective | "
           "dominant | roofline frac | MFU bound | MODEL/counted flops |")
    sep = "|" + "---|" * 10
    rows.append(hdr)
    rows.append(sep)
    for r in _ran(records, multi_pod, tag):
        t = roofline_terms(r)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['chips']} "
            f"| {fmt_s(t['compute'])} | {fmt_s(t['memory'])} "
            f"| {fmt_s(t['collective'])} | {t['dominant']} "
            f"| {t['roofline_fraction']*100:.1f}% "
            f"| {t['mfu_bound']*100:.2f}% "
            f"| {t['flops_ratio']*100:.1f}% |")
    return "\n".join(rows)


def memory_table(records: List[dict], *, multi_pod=False) -> str:
    rows = [f"| arch | shape | args GiB/dev | temp GiB/dev | "
            f"fits {HBM_GB} GB? |",
            "|---|---|---|---|---|"]
    for r in _ran(records, multi_pod):
        m = r["memory"]
        total = m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
        args = m["argument_bytes"] / 2**30
        temp = m["temp_bytes"] / 2**30
        rows.append(f"| {r['arch']} | {r['shape']} | {args:.2f} "
                    f"| {temp:.2f} | "
                    f"{'YES' if total < HBM_GB * 1e9 else 'NO'} |")
    return "\n".join(rows)


def cells_table(records: List[dict]) -> str:
    """Every untagged cell, one row an (arch, shape) with the (16, 16)
    and (2, 16, 16) meshes' values as "a / b": params, counted over
    model flops, collective MiB per device, args and temp GiB per
    device, whether it fits the card, the dominant term and its seconds
    a step (skipped cells name their reason)."""
    cells = {}
    for r in records:
        if not r.get("tag", ""):
            cells.setdefault((r["arch"], r["shape"]), {})[r["multi_pod"]] = r
    rows = ["| arch | shape | params (G) | counted / model | coll MiB/dev "
            "| args GiB/dev | temp GiB/dev "
            f"| fits {HBM_GB} GB | dominant (s/step) |",
            "|---|---|---|---|---|---|---|---|---|"]

    def one(r, what):
        if r is None:
            return "not run"
        m, t = r["memory"], roofline_terms(r)
        total = m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
        return {
            "ratio": f"{r['counted_flops'] / r['model_flops']:.4f}",
            "coll": f"{r['collective_bytes_per_device'] / 2**20:,.0f}",
            "args": f"{m['argument_bytes'] / 2**30:.2f}",
            "temp": f"{m['temp_bytes'] / 2**30:.2f}",
            "fits": "yes" if total < HBM_GB * 1e9 else "NO",
            "dom": f"{t['dominant']} {t['step_time_bound']:.3g}",
        }[what]

    for (arch, shape), by_mesh in sorted(cells.items()):
        single, multi = by_mesh.get(False), by_mesh.get(True)
        first = single or multi
        if first.get("skipped"):
            rows.append(f"| {arch} | {shape} | skipped: {first['skipped']}"
                        " |||||||")
            continue
        pair = {w: f"{one(single, w)} / {one(multi, w)}"
                for w in ("ratio", "coll", "args", "temp", "fits", "dom")}
        rows.append(f"| {arch} | {shape} | {first['params'] / 1e9:.2f} "
                    f"| {pair['ratio']} | {pair['coll']} | {pair['args']} "
                    f"| {pair['temp']} | {pair['fits']} | {pair['dom']} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", default="artifacts/dryrun_torch")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    recs = load_artifacts(args.artifacts)
    print(table(recs, multi_pod=args.multi_pod, tag=args.tag))
    print()
    print(memory_table(recs, multi_pod=args.multi_pod))
    print()
    print(cells_table(recs))


if __name__ == "__main__":
    main()
