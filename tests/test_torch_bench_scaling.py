"""The scaling-laws twin against the reference's 8-pod meshes, and the
farm-scaling and scaling-laws twins' ``--smoke`` through the runner, on
the CPU.

* The variance sections, from the reference's initial weights (carried
  by ``convert`` in place of the port's ``mlp_init``), land on the rows
  of the reference's own run (8 virtual CPU devices, in a subprocess)
  within their gate bands.  The committed baseline's variance rows do
  not reproduce under the installed jax even for the reference's own run
  (ROADMAP C7), so that run is the yardstick.
* ``python -m repro_torch.benchmarks.run --only farm_scaling,scaling_laws
  --smoke`` writes the reference's rows in order, and every deterministic
  gated row (``projected_*``, ``params_*``, ``mesh_farm_bitmatch_f32``)
  passes the unedited ``check_regression`` against ``artifacts/bench``.
  The host-timing rows are not gated here: the test workers' load moves
  them.
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
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import scaling_laws as tscaling

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


def _within_bands(bench, got_rows, want_rows, prefixes):
    """``check_regression``'s bands around ``want_rows`` (the reference's
    fresh run) hold every gated row of ``got_rows`` named by ``prefixes``."""
    _, checked, findings = check_regression.compare_file(bench, got_rows,
                                                         want_rows)
    gated = {name: s for s, name, _ in findings if s != "info"}
    assert checked and all(n.startswith(prefixes) for n in gated)
    assert set(gated.values()) == {"ok"}, findings
    return checked


_REF_SCALING = """
import json
from benchmarks import scaling_laws as s
rows = s._variance_rows(s._feasible_ks(), 30, 0)
rows += s._variance_vs_n_rows(30, 0)[0]
print(json.dumps(rows))
"""


def test_scaling_variance_from_reference_init_lands_on_reference(
        monkeypatch):
    """The reference's 8-pod meshes need 8 devices: its rows come from a
    subprocess with 8 virtual CPU devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", _REF_SCALING], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    monkeypatch.setattr(tscaling, "mlp_init", _ref_init)
    dev = torch.device("cpu")
    got = (tscaling._variance_rows(30, 0, dev)
           + tscaling._variance_vs_n_rows(30, 0, dev)[0])
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert _within_bands("scaling_laws", got, want,
                         ("mesh_", "ghat_variance_N")) == 14
    np.testing.assert_allclose([r["value"] for r in got],
                               [r["value"] for r in want], rtol=1e-4)



def test_runner_smoke_farm_and_scaling_gate_deterministic_rows(tmp_path):
    """``--smoke`` of the farm-scaling and scaling-laws twins through the
    runner: the reference's row names in order, and every deterministic
    gated row passes the unedited gate against ``artifacts/bench``."""
    assert trun.main(["--only", "farm_scaling,scaling_laws", "--smoke",
                      "--device", "cpu", "--out", str(tmp_path)]) == 0
    for bench, names in (
            ("farm_scaling", ("projected_1e4steps_k1_s",
                              "projected_1e4steps_k2_s",
                              "projected_1e4steps_k4_s")),
            ("scaling_laws", ("mesh_farm_bitmatch_f32", "params_qwen3_14b",
                              "params_deepseek_v3_671b",
                              "params_smoke_qwen3_14b",
                              "projected_probe_budget_qwen3_14b_k8",
                              "projected_step_s_deepseek_v3_671b"))):
        out = json.loads((tmp_path / f"{bench}.json").read_text())
        assert out["seed"] == 0 and out["smoke"] and out["device"] == "cpu"
        assert [r["name"] for r in out["rows"]] == [
            r["name"] for r in _baseline(bench)]
        assert set(_gate(bench, out["rows"], names).values()) == {"ok"}
