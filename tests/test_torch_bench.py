"""The port's benchmark helpers and its Table 2 twin, on the CPU.

``repro_torch.benchmarks.common`` is the twin of ``benchmarks/common.py``;
``repro_torch.benchmarks.table2_datasets --smoke`` runs Table 2 with
every step budget cut by 100 and must write the reference's rows, name
for name (read from ``benchmarks/table2_datasets.py``), with its
parameter counts.  The full budgets run on the card.
"""
import json
import pathlib
import re

import repro_torch as rt
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import table2_datasets as t2


def test_benchmark_helpers():
    assert tcommon.median([3, 1, 2]) == 2 and tcommon.median([]) is None
    cfg = rt.DriverConfig(dtheta=1e-2, eta=1.0, seed=0)
    steps = tcommon.time_to_solve_xor(cfg, 1, max_steps=400, chunk=200,
                                      device="cpu")
    assert steps is None or steps in (200, 400)
    params, loss_fn, sample = tcommon.xor_setup(1, device="cpu")
    assert loss_fn is tcommon.xor_loss and sample(0)["x"].shape == (1, 2)
    assert 0.0 <= tcommon.xor_mse(params) <= 1.0


def test_table2_twin_smoke_on_cpu(tmp_path):
    """``python -m repro_torch.benchmarks.table2_datasets --smoke`` writes
    the reference's rows, name for name, with its parameter counts."""
    ref = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
           / "table2_datasets.py").read_text()
    names = re.findall(r'"name": "(\w+)"', ref)
    assert t2.main(["--smoke", "--device", "cpu", "--out",
                    str(tmp_path)]) == 0
    out = json.loads((tmp_path / "table2_datasets.json").read_text())
    assert out["smoke"] and out["device"] == "cpu"
    assert [r["name"] for r in out["rows"]] == names
    values = {r["name"]: r["value"] for r in out["rows"]}
    assert values["fashion_cnn_params"] == 20490
    assert values["cifar_cnn_params"] == 26154
    assert all(0.0 <= v <= 1.0 for k, v in values.items()
               if k.endswith(("_acc", "_solved")))
    assert [r["run"] for r in out["runs"]][:2] == ["xor_mgd",
                                                   "nist7x7_mgd_1e4"]
    assert all(r["steps"] >= 1 for r in out["runs"])
