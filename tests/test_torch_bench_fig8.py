"""The ``fig8_noise`` twin against the reference's bench, the six figure
twins' sources, and the runner over the fifteen twins, on the CPU.

fig8 is cut alike in both packages, by monkeypatching each module's own
names: ``N_SEEDS`` = 1, ``train_until`` (fig8's and ``common``'s, which
``time_to_solve_xor`` calls) to the run spy of
``tests/test_torch_bench_windows.py`` at 200 steps in chunks of 100; the
twin's ``mlp_init`` (and ``common``'s) is the reference's, converted.
Two runs go on to 1500 steps, within which the reference's init solves
them (1400 each): fig8's ideal device (σ_C = 0) and fig10's σ_a = 0.1, so
a steps row and a converged row hold an outcome and fig10's < 0.05
plant-loss threshold is held along the line to a solution.  ``run()`` of
each yields the same 11 rows in order, ``detail`` and values included,
and the names of the committed baseline; every run is held against the
reference's (``hold_runs``: config, budget, plant meta, final params).
The runner lists fifteen twins in the reference's order and runs
``--only fig8 --device cpu`` (cut the same way) into a record.
"""
import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from benchmarks import fig8_noise as jfig8
from benchmarks import run as jrun
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import fig8_noise as tfig8
from repro_torch.benchmarks import run as trun
from test_torch_bench_windows import (cut_budget, hold_runs, outcome_rows,
                                      spy_runs)

REPO = pathlib.Path(__file__).resolve().parent.parent
TWINS = ("hardware_plants", "fig4_equivalence", "fig5_angle",
         "fig6_tau_theta", "fig7_perturbations", "fig8_noise")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Thousands of tiny ops: one intra-op thread a test (see
    ``tests/test_torch_bench_twins.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_init(seed, sizes, device=None):
    p = jax.tree_util.tree_map(np.asarray,
                               jmlp_init(jax.random.PRNGKey(seed), sizes))
    return convert.to_torch(p, device=device)


# the runs, in fig8's call order, that go on to a solve: σ_C = 0 and σ_a = 0.1
LONG = {0: 1500, 9: 1500}


def _cut_fig8(monkeypatch, pairs, long=None):
    """Each (fig8 module, its package's ``common``) cut: one seed and the
    run spy on both modules' ``train_until``; returns each package's runs."""
    runs = []
    for fig8, common in pairs:
        monkeypatch.setattr(fig8, "N_SEEDS", 1)
        runs.append(spy_runs(monkeypatch, (fig8, common), cut_budget(long)))
    return runs


def test_fig8_rows_match_reference_at_a_cut(monkeypatch):
    assert tfig8.N_SEEDS == jfig8.N_SEEDS
    want_runs, got_runs = _cut_fig8(monkeypatch, ((jfig8, jcommon),
                                                  (tfig8, tcommon)), LONG)
    for mod in (tfig8, tcommon):
        monkeypatch.setattr(mod, "mlp_init", _ref_init)
    want, got = jfig8.run(), tfig8.run(device="cpu")
    assert got == want
    hold_runs(want_runs, got_runs)
    assert [r["name"] for r in outcome_rows(want)] == [
        "sigma_c_0.0_steps", "sigma_a_0.1_converged"]
    base = json.loads((REPO / "artifacts" / "bench" /
                       "fig8_noise.json").read_text())["rows"]
    assert [r["name"] for r in got] == [r["name"] for r in base]


@pytest.mark.parametrize("twin", TWINS)
def test_figure_twin_sources_stand_alone(twin):
    """No twin imports JAX or the reference package; each runs on the card
    unless asked otherwise and has the twins' CLI without ``--smoke``."""
    src = (REPO / "src" / "repro_torch" / "benchmarks" /
           f"{twin}.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert not [m for m in imports if m.split(".")[0] in ("jax", "repro")]
    assert "resolve_device(device)" in src
    mod = __import__(f"repro_torch.benchmarks.{twin}", fromlist=["main"])
    with pytest.raises(SystemExit) as e:
        mod.main(["--smoke"])
    assert e.value.code == 2


def test_runner_lists_fourteen_twins_in_the_reference_order(capsys):
    """Named when roofline_report waited for the dry run; the runner now
    lists all fifteen of the reference's benches, in its order."""
    assert trun.main(["--list"]) == 0
    names = capsys.readouterr().out.split()
    assert len(names) == 15
    assert names == list(jrun.BENCHES)


def test_runner_runs_fig8_on_the_cpu_into_a_record(monkeypatch, tmp_path,
                                                   capsys):
    _cut_fig8(monkeypatch, ((tfig8, tcommon),))
    assert trun.main(["--only", "fig8", "--device", "cpu", "--out",
                      str(tmp_path)]) == 0
    out = json.loads((tmp_path / "fig8_noise.json").read_text())
    assert out["device"] == "cpu" and out["seed"] is None
    assert not out["smoke"]
    assert [r["name"] for r in out["rows"]][:2] == ["sigma_c_0.0_steps",
                                                    "sigma_c_0.001_steps"]
    assert len(out["rows"]) == 11
    assert "fig8,sigma_c_0.0_steps," in capsys.readouterr().out
