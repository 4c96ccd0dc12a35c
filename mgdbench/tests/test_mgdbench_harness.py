"""The harness on the CPU at smoke sizes: ``BENCHMARK.json`` keeps the
contract's names and units, every name finds its file, a cell, a
configuration, a traffic mix and a metric added as new files are found by
name with no file edited, the traffic law's closed form equals its
sequential definition, weights redraw bit for bit, the import guard
compares whole top-level names, and a run without a card prints
nothing."""
import hashlib
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from mgdbench.tests.smoke import BENCH, REPO, load, smoke_tree
from mgdbench import harness, traffic, weights
from mgdbench.reference import family

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contracts_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["mgdbench"] and 1 <= b["run_seconds"] <= 51
    assert all(LINE.match(w) for w in b["command"])
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("mgdbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_name_of_a_cell_finds_its_file(workload):
    cell = harness.load_cell(workload, REPO)
    fam = family(cell.conf["reference"])
    assert cell.conf["name"] == cell.work["config"]
    assert {"change_gap", "nonfinite"} <= set(cell.limits) <= {
        "cost_gap", "change_gap", "nonfinite"}
    assert cell.traffic["name"] == cell.work["traffic"]
    for m in cell.per_layer:
        assert callable(harness.load_reader(cell.metrics_dir, m["name"]))
    assert fam.leaf_specs(cell.conf)


def _digest(root: pathlib.Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_config_mix_and_metric_added_as_files_are_found(tmp_path):
    smoke_tree(tmp_path)
    before = _digest(tmp_path)
    bench_dir = tmp_path / "mgdbench"
    conf = json.loads((bench_dir / "configs" / "qwen3-14b.json").read_text())
    conf["name"] = "qwen3-mini"
    (bench_dir / "configs" / "qwen3-mini.json").write_text(json.dumps(conf))
    mix = json.loads((bench_dir / "traffic" / "central.8x512.json").read_text())
    mix.update(name="central.4x8", batch=4, seq=8)
    (bench_dir / "traffic" / "central.4x8.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "qwen3-mini.central.4x8.json").write_text(
        (bench_dir / "limits" / "qwen3-14b.central.8x512.json").read_text())
    (bench_dir / "metrics" / "tokens.seen.py").write_text(
        "def read(ctx):\n    return ctx.tokens_per_step * ctx.trace_steps\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # new entries only: later benchmark changes add, they edit no file
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(dict(
        b, configs=b["configs"] + [dict(b["configs"][0], name="qwen3-mini",
                                        file="mgdbench/configs/qwen3-mini.json")],
        workloads=b["workloads"] + [{"name": "qwen3-mini.central.4x8",
                                     "config": "qwen3-mini",
                                     "traffic": "central.4x8", "chips": 1,
                                     "why": "test"}],
        per_layer=b["per_layer"] + [{"name": "tokens.seen", "unit": "tokens",
                                     "better": "higher",
                                     "source": "program_counter",
                                     "layer": "MGD step",
                                     "moves": "train_tokens_per_s",
                                     "workloads": ["qwen3-mini.central.4x8"]}])))
    after = _digest(tmp_path)
    edited = [p for p, h in before.items()
              if p != pathlib.Path("BENCHMARK.json") and after[p] != h]
    assert not edited
    cell = load(tmp_path, "qwen3-mini.central.4x8")
    result, lines, _ = harness.run_cell(cell, 5, 0.2, True, "cpu", 0.0)
    steps = int(mix["trace_steps"])
    assert result["metrics"]["tokens.seen"] == {"value": 32.0 * steps,
                                                "unit": "tokens"}
    assert "train_mfu" in result["metrics"]
    assert list(result)[-1] == "checks"
    assert lines[0].startswith("check cost_gap: ")
    assert result["correct"] is True


def _loop_law(tr, vocab, seed):
    """The Zipf-Markov law as its sequential definition, from the same
    draws as ``traffic.sampler``."""
    law = tr["law"]
    b, s = tr["batch"], tr["seq"] + 1

    def sample(n):
        gen = torch.Generator().manual_seed(weights.mix64(seed, 0xBA7C, n))
        u = law["u_min"] + (1.0 - law["u_min"]) * torch.rand(
            (b, s), generator=gen)
        z = (torch.exp(u * torch.tensor(float(vocab), dtype=torch.float64)
                       .log().float()).long() - 1).clamp(0, vocab - 1)
        cont = torch.rand((b, s), generator=gen) < law["continue_p"]
        cols = [z[:, 0]]
        for t in range(1, s):
            cols.append(torch.where(
                cont[:, t], (cols[-1] * law["chain_mul"] + law["chain_add"])
                % vocab, z[:, t]))
        toks = torch.stack(cols, 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return sample


@pytest.mark.parametrize("vocab", [128, 151936])
def test_traffic_closed_form_is_the_sequential_law(vocab):
    tr = json.loads((BENCH / "traffic" / "central.8x512.json").read_text())
    fast = traffic.sampler(tr, vocab, 2 ** 31 + 11, "cpu")
    slow = _loop_law(tr, vocab, 2 ** 31 + 11)
    for n in (0, 1, 7):
        a, b = fast(n), slow(n)
        assert torch.equal(a["tokens"], b["tokens"])
        assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(fast(0)["tokens"], fast(1)["tokens"])
    rows = fast(0)["tokens"]
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_weights_redraw_bit_for_bit():
    conf = json.loads((BENCH / "configs" / "rwkv6-port-7b.json").read_text())
    from mgdbench.tests.smoke import SMOKE_SIZES
    conf.update(SMOKE_SIZES["rwkv6"])
    specs = family("rwkv6").leaf_specs(conf)
    made = weights.make(specs, 2 ** 33 + 1, "cpu")
    again = weights.leaf_slices(specs, 2 ** 33 + 1, "cpu")
    for path, leaf in made.items():
        flat = leaf.reshape(-1)
        for part, start in again(path):
            assert torch.equal(flat[start:start + part.numel()],
                               part.reshape(-1))
    other = weights.make(specs, 2 ** 33 + 2, "cpu")
    key = ("layers", "att", "wr", "w")
    assert not torch.equal(made[key], other[key])


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    port = ["repro_torch", "repro_torch.core.mgd", "mgdbench.harness",
            "jax_utils", "reprox", "torch"]
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules(port + ["repro.core"]) == ["repro"]
    assert harness.forbidden_modules(port + ["jaxlib.xla_client", "flax",
                                             "jax"]) == ["flax", "jax",
                                                         "jaxlib"]
    monkeypatch.setitem(sys.modules, "repro", object())
    assert "repro" in harness.forbidden_modules()


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(REPO / "mgdbench" / "run.py"), "--workload",
         "qwen3-14b.central.8x512", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_busy_intervals_and_idle_gaps_from_trace_events():
    device = [("gemm", 0.0, 10.0), ("add", 5.0, 10.0), ("hash", 40.0, 5.0),
              ("gemm", 100.0, 20.0)]
    host = [("aten::mm", 0.0, 16.0), ("aten::add", 20.0, 2.0),
            ("aten::cat", 60.0, 50.0)]
    assert harness.merge_intervals(device) == [[0.0, 15.0], [40.0, 45.0],
                                               [100.0, 120.0]]
    bd = harness.breakdown(device, host)
    assert bd["device_ops"][0] == ["gemm", 30.0 / 1e6]
    assert bd["idle_gaps"] == [["after aten::add", 55.0 / 1e6],
                               ["aten::mm", 25.0 / 1e6]]
