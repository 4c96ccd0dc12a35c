"""The drift-aging bench's twin on the CPU.

``python -m repro_torch.benchmarks.drift_aging --smoke`` (σ_d ∈ {0.01,
0.08}, the committed baseline's grid and budgets; ~2 min on this CPU)
must write the reference's rows, name for name, and its exact rows (the
projected seconds) must pass the reference's ``check_regression``
against ``artifacts/bench``, unedited.  Its accuracy rows come from the
port's own ``mlp_init`` and are reported, not gated here: the committed
baseline's accuracies do not reproduce under the installed jax 0.9.0
even for the reference's own run (ROADMAP C).  The parity test ties the
twin to the reference: from the reference's initial weights the port's
drift-free run and each strategy's window (incl. recalibration) land on
the reference's accuracies, at a cut budget (200 + 200 steps).
"""
import json
import pathlib

import jax
import numpy as np
import pytest

from benchmarks import check_regression
from benchmarks import drift_aging as jbench
from repro.hardware import DriftingPlant as JDriftingPlant
from repro.hardware import IdealPlant as JIdealPlant
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.benchmarks import drift_aging as tbench
from repro_torch.hardware import DriftingPlant, IdealPlant

ROOT = pathlib.Path(__file__).resolve().parent.parent
ACC_ATOL = 2 / 512                      # two of the 512 eval samples


def test_drift_aging_twin_smoke_on_cpu(tmp_path):
    assert tbench.main(["--smoke", "--device", "cpu", "--out",
                        str(tmp_path)]) == 0
    out = json.loads((tmp_path / "drift_aging.json").read_text())
    base = json.loads((ROOT / "artifacts" / "bench" /
                       "drift_aging.json").read_text())["rows"]
    assert [r["name"] for r in out["rows"]] == [r["name"] for r in base]
    rows = {r["name"]: r["value"] for r in out["rows"]}
    assert all(0.0 <= rows[k] <= 1.0 for k in rows if "acc" in k)
    assert rows["collapse_rate_none"] == 0.08
    assert rows["acc_mgd_rate0.08"] > rows["acc_none_rate0.08"]
    _, checked, findings = check_regression.compare_file(
        "drift_aging", out["rows"], base)
    status = {name: s for s, name, _ in findings}
    assert checked == 7
    for name in rows:
        if name.startswith("projected_"):
            assert status[name] == "ok", findings


def _ref_init(seed, sizes, device=None):
    p = jax.tree_util.tree_map(np.asarray,
                               jmlp_init(jax.random.PRNGKey(seed), sizes))
    return convert.to_torch(p, device=device)


@pytest.mark.parametrize("strategy", tbench.STRATEGIES)
def test_twin_reproduces_reference_window(strategy, monkeypatch):
    monkeypatch.setattr(tbench, "mlp_init", _ref_init)
    j_theta, j_a0 = jbench._reference(0, 200)
    t_theta, t_a0 = tbench.reference(0, 200, "cpu")
    assert abs(t_a0 - j_a0) <= ACC_ATOL
    theta = convert.to_torch(jax.tree_util.tree_map(np.asarray, j_theta),
                             device="cpu")
    want = jbench._strategy_run(
        strategy, j_theta, JDriftingPlant(JIdealPlant(jbench._loss),
                                          mode="walk", drift_rate=0.08,
                                          seed=41), 0, 200)
    got = tbench.strategy_run(
        strategy, theta, DriftingPlant(IdealPlant(tbench._loss),
                                       mode="walk", drift_rate=0.08,
                                       seed=41), 0, 200, "cpu")
    assert abs(got - want) <= ACC_ATOL, (got, want)
