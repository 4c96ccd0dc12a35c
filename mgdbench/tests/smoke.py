"""A benchmark tree at smoke sizes, for the CPU tests: ``BENCHMARK.json``
and ``mgdbench``'s data files copied into a directory, each configuration
cut to a width a CPU step takes milliseconds at (2 layers, d 64, vocab
128) and each traffic mix to batch 2 × 16 tokens.  The cells keep their
own limits, but for the cost's in bfloat16 (``SMOKE_COST_GAP``)."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
for entry in (REPO / "src", REPO):
    if str(entry) not in sys.path:
        sys.path.insert(0, str(entry))

BENCH = REPO / "mgdbench"
# The cells' limits are set from readings at their own sizes; at these
# sizes the bf16 program's probe costs read up to 3.6e-3 from the float32
# reference (rwkv6; qwen3 1.2e-3) and half a batch 2e-2 or more, so the
# bf16 smoke tree's cost limit lies between.  In float32 the program
# reads ~1e-6 and the cells' limits stand as they are.
SMOKE_COST_GAP = 5e-3
SMOKE_SIZES = {
    "qwen3": dict(hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, vocab_size=128),
    "rwkv6": dict(n_layer=2, n_embd=64, head_size=16, dim_ffn=128,
                  vocab_size=128),
}


def smoke_tree(dest: pathlib.Path, dtype: str = "bfloat16",
               batch: int = 2, seq: int = 16) -> pathlib.Path:
    """A copy of the benchmark's data at smoke sizes under ``dest``."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    out = dest / "mgdbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, out / sub)
    for path in (out / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        conf.update(SMOKE_SIZES[conf["reference"]], dtype=dtype)
        if "la_chunk" in conf.get("assumed", {}):
            conf["assumed"]["la_chunk"] = 8
        path.write_text(json.dumps(conf))
    if dtype == "bfloat16":
        for path in (out / "limits").glob("*.json"):
            lim = json.loads(path.read_text())
            lim["cost_gap"] = SMOKE_COST_GAP
            path.write_text(json.dumps(lim))
    for path in (out / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(batch=batch, seq=seq)
        path.write_text(json.dumps(tr))
    return dest


def add_cell(dest: pathlib.Path, config: str, traffic: str,
             limits: dict) -> str:
    """A cell of the configuration file ``configs/<config>.json`` under
    ``traffic`` added to a smoke tree as new entries and a new limits
    file, as a later benchmark change adds one; returns its name."""
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    name = f"{config}.{traffic}"
    if config not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({
            "name": config, "source": "test", "reduced": [], "why": "test",
            "file": f"mgdbench/configs/{config}.json"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    (dest / "mgdbench" / "limits" / f"{name}.json").write_text(
        json.dumps(limits))
    return name


def load(dest: pathlib.Path, workload: str):
    from mgdbench import harness
    return harness.load_cell(workload, dest)
