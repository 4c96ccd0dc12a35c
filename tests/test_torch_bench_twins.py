"""The Table 3, fused-probe, farm-scaling and scaling-laws twins and the
twins' runner, on the CPU.

* The twins write the reference's rows, name for name and in order (those
  of the committed baselines), and their gated deterministic rows pass
  the reference's ``check_regression`` against ``artifacts/bench``,
  unedited: ``table3 *_seconds``, ``*_wread_ratio``, ``projected_*``,
  ``params_*``, ``mesh_farm_bitmatch_f32``.
* ``fused_probe``'s fused and materialized runs end on bitwise-equal f32
  params (the plain kernel versions on the CPU).
* The farm's variance section, from the reference's initial weights
  (carried by ``convert`` in place of the port's ``mlp_init``), lands on
  the reference's own run's rows within their gate bands.  The committed
  baselines' variance rows do not reproduce under the installed jax even
  for the reference's own run (ROADMAP C7), so that run is the yardstick
  (``tests/test_torch_bench_scaling.py`` does the same for the scaling
  laws, and runs both twins' ``--smoke`` through the runner).
* The runner: ``--list``, an unknown ``--only`` → 2, a raising twin → 1
  after the rest have run; a twin asked for the card without one raises.

The host-timing rows (``wallclock_flat_*``, ``pipeline_utilization_*``,
``thread_over_process_*``) are not gated here: the test workers' load
moves them.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benchmarks import check_regression
from benchmarks import farm_scaling as jfarm
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.benchmarks import farm_scaling as tfarm
from repro_torch.benchmarks import fused_probe as tfused
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import scaling_laws as tscaling
from repro_torch.benchmarks import table3_hardware as ttable3
from repro_torch.core.utils import tree_leaves

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: these runs are thousands of tiny ops,
    which idle OpenMP threads slow 10-100× when xdist's workers share the
    cores (table3's test took 178 s so, 1.3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _baseline(bench):
    return json.loads((REPO / "artifacts" / "bench" /
                       f"{bench}.json").read_text())["rows"]


def _gate(bench, rows, names):
    """``check_regression``'s verdict on each of ``names``."""
    _, _, findings = check_regression.compare_file(bench, rows,
                                                   _baseline(bench))
    status = {name: s for s, name, _ in findings}
    return {n: status[n] for n in names}


def _ref_init(seed, sizes, device=None):
    p = jax.tree_util.tree_map(np.asarray,
                               jmlp_init(jax.random.PRNGKey(seed), sizes))
    return convert.to_torch(p, device=device)


def test_table3_twin_rows_and_gate(monkeypatch):
    # the backprop rows are ungated timings: a cut budget times the same
    # code (2000 and 40 steps in the bench)
    monkeypatch.setattr(ttable3, "XOR_BP_STEPS", 100)
    monkeypatch.setattr(ttable3, "FASHION_BP_STEPS", 2)
    rows = ttable3.run(device="cpu")
    assert [r["name"] for r in rows] == [r["name"]
                                         for r in _baseline("table3_hardware")]
    seconds = [r["name"] for r in rows if r["name"].endswith("_seconds")]
    assert len(seconds) == 21
    assert set(_gate("table3_hardware", rows, seconds).values()) == {"ok"}
    # the arithmetic rows equal the baseline's values exactly
    base = {r["name"]: r["value"] for r in _baseline("table3_hardware")}
    assert all(r["value"] == base[r["name"]] for r in rows
               if r["name"] in seconds)
    bp = [r for r in rows if "backprop" in r["name"]]
    assert all(r["value"] > 0 and "on cpu" in r["detail"] for r in bp)


def test_fused_probe_twin_rows_gate_and_bitwise_paths(monkeypatch):
    # 10 + 20 steps a run in place of the bench's 20 + 60: the rows and
    # the bitwise law do not depend on the count
    monkeypatch.setattr(tfused, "CHUNK", 10)
    monkeypatch.setattr(tfused, "STEPS", 20)
    runs, dev = tfused.measure("cpu")
    rows = tfused.rows_of(runs, dev)
    assert [r["name"] for r in rows] == [r["name"]
                                         for r in _baseline("fused_probe")]
    ratios = [r["name"] for r in rows if r["name"].endswith("_wread_ratio")]
    assert set(_gate("fused_probe", rows, ratios).values()) == {"ok"}
    for model in tfused.MODELS:
        for mode in tfused.MODES:
            mat, fus = runs[model, mode, False], runs[model, mode, True]
            assert torch.equal(mat["c_tilde"], fus["c_tilde"]), (model, mode)
            assert mat["c_tilde"].numel() == tfused.CHUNK + tfused.STEPS
            for a, b in zip(tree_leaves(mat["params"]),
                            tree_leaves(fus["params"])):
                assert a.dtype == torch.float32 and torch.equal(a, b)
            assert not torch.equal(tree_leaves(fus["params"])[-1],
                                   tree_leaves(fus["params0"])[-1])
    assert all("plain PyTorch on cpu" in r["detail"] for r in rows
               if r["name"].endswith(("_fused", "_materialized")))


@pytest.mark.parametrize("model", tfused.MODELS)
def test_fused_step_update_is_fused_update_tau1(model):
    """Each fused step's params are ``core.mgd.fused_update_tau1`` of its
    own params, step and C̃, bitwise (f32, the twin's setups): the plain
    update the card's phase 15 holds B3 against at every step.  Another
    seed's update differs."""
    import dataclasses

    from repro_torch.api import DriverConfig, driver
    from repro_torch.core import mgd

    params, batch, loss, probe_fn = tfused.SETUPS[model](torch.device("cpu"))
    for mode in tfused.MODES:
        drv = driver("discrete", DriverConfig(
            mode=mode, dtheta=1e-3, eta=1e-2, fused=True), loss,
            probe_fn=probe_fn, device="cpu")
        other_cfg = dataclasses.replace(drv.config, seed=1)
        p, s = params, drv.init(params)
        for _ in range(3):
            n = s.step
            p_next, s, aux = drv.step(p, s, batch)
            want = mgd.fused_update_tau1(drv.config, p, n, aux["c_tilde"])
            other = mgd.fused_update_tau1(other_cfg, p, n, aux["c_tilde"])
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(p_next), tree_leaves(want)))
            assert not all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(p_next), tree_leaves(other)))
            p = p_next


def test_scaling_laws_arithmetic_rows_are_exact():
    var_by_n = {9: 0.5, 129: 2.0}
    rows = tscaling._projection_rows(var_by_n) + tscaling._bitmatch_rows(
        torch.device("cpu"))
    base = {r["name"]: r["value"] for r in _baseline("scaling_laws")}
    exact = [r["name"] for r in rows
             if r["name"].startswith(("params_", "projected_probe_budget_",
                                      "projected_step_s_"))]
    assert len(exact) == 10
    assert all(r["value"] == base[r["name"]] for r in rows
               if r["name"] in exact)
    bit = next(r for r in rows if r["name"] == "mesh_farm_bitmatch_f32")
    assert bit["value"] == 1.0
    names = exact + ["mesh_farm_bitmatch_f32"]
    assert set(_gate("scaling_laws", rows, names).values()) == {"ok"}


def test_farm_latency_rows_are_exact():
    rows = tfarm._latency_rows(tfarm.SMOKE_KS)
    base = {r["name"]: r["value"] for r in _baseline("farm_scaling")}
    assert [r["value"] for r in rows] == [base[r["name"]] for r in rows]


# --- the variance sections against the reference's own run -----------------


def _within_bands(bench, got_rows, want_rows, prefixes):
    """``check_regression``'s bands around ``want_rows`` (the reference's
    fresh run) hold every gated row of ``got_rows`` named by ``prefixes``."""
    _, checked, findings = check_regression.compare_file(bench, got_rows,
                                                         want_rows)
    gated = {name: s for s, name, _ in findings if s != "info"}
    assert checked and all(n.startswith(prefixes) for n in gated)
    assert set(gated.values()) == {"ok"}, findings
    return checked


def test_farm_variance_from_reference_init_lands_on_reference(monkeypatch):
    monkeypatch.setattr(tfarm, "mlp_init", _ref_init)
    got = tfarm._variance_rows(tfarm.SMOKE_KS, 24, 0, torch.device("cpu"))
    want = jfarm._variance_rows(tfarm.SMOKE_KS, 24, 0)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert _within_bands("farm_scaling", got, want,
                         ("ghat_variance_", "variance_ratio_")) == 10
    # the farm's readouts are the reference chip's: the rows agree far
    # inside the bands
    np.testing.assert_allclose([r["value"] for r in got],
                               [r["value"] for r in want], rtol=1e-4)


# --- the runner ---------------------------------------------------------------


def test_runner_list_and_unknown_only(capsys):
    assert trun.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == trun.BENCHES and len(listed) == 15
    assert trun.main(["--only", "no_such_bench"]) == 2


def test_runner_exits_1_on_a_raising_twin_after_the_rest(monkeypatch,
                                                         tmp_path):
    def boom(device=None):
        raise RuntimeError("boom")

    def tiny(device=None):
        return [{"bench": "fused_probe", "name": "mlp_forward_wread_ratio",
                 "value": 2.0, "detail": "stub"}]

    monkeypatch.setattr(ttable3, "run", boom)
    monkeypatch.setattr(tfused, "run", tiny)
    assert trun.main(["--only", "table3,fused_probe", "--device", "cpu",
                      "--smoke", "--out", str(tmp_path)]) == 1
    assert not (tmp_path / "table3_hardware.json").exists()
    out = json.loads((tmp_path / "fused_probe.json").read_text())
    assert out["seed"] is None and not out["smoke"]
    assert out["rows"][0]["value"] == 2.0


def test_twins_raise_without_a_card_when_asked_for_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for run in (lambda: ttable3.run(device="cuda"),
                lambda: tfused.run(device="cuda"),
                lambda: tfarm.run(smoke=True, device="cuda"),
                lambda: tscaling.run(smoke=True, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA card"):
            run()


def test_new_modules_import_neither_jax_nor_reference():
    """Each module this slice adds, imported in a fresh interpreter, pulls
    in neither ``jax`` nor ``repro`` nor the reference's ``benchmarks``."""
    mods = ["repro_torch.launch.specs", "repro_torch.core.mgd",
            "repro_torch.benchmarks.table3_hardware",
            "repro_torch.benchmarks.fused_probe",
            "repro_torch.benchmarks.farm_scaling",
            "repro_torch.benchmarks.scaling_laws",
            "repro_torch.benchmarks.run"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
