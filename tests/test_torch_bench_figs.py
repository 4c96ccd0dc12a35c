"""The ``fig4``, ``fig5`` and ``fig7`` twins against the reference's
benches, on the CPU.

Each pair of modules is cut alike, by monkeypatching each one's own
names: ``N_SEEDS`` = 1; fig4's ``_mgd_curve`` to 200 iterations in chunks
of 100 (backprop keeps its 4000 steps); fig5's ``CHECKPOINTS`` to (100,
1000) and ``_angles`` to one seed and 1000 iterations;
``common.train_until`` of each package (which fig7's
``time_to_solve_xor`` calls) to the run spy of
``tests/test_torch_bench_windows.py`` at 500 steps in chunks of 250
(past τ_x = 250); the twins' ``mlp_init`` (and ``common``'s) is the
reference's, converted.  Then ``run()`` of each
yields the reference's rows in order with the same ``detail``, and the
values agree: final costs within 1e-4, angles within 1e-4 rad, steps
equal; and every fig7 run is held against the reference's
(``hold_runs``: config, budget and chunk asked, final params).  fig6 is
held in ``tests/test_torch_bench_fig6.py``.  fig7's types solve only
after 14750-28000 steps from these inits (the reference's scan; 45-80 s
of the port's steps here), so its rows are the unsolved sentinel in both
and its runs are held on their 500-step params.  The twins keep the
reference's constants.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from benchmarks import fig4_equivalence as jfig4
from benchmarks import fig5_angle as jfig5
from benchmarks import fig6_tau_theta as jfig6
from benchmarks import fig7_perturbations as jfig7
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import fig4_equivalence as tfig4
from repro_torch.benchmarks import fig5_angle as tfig5
from repro_torch.benchmarks import fig6_tau_theta as tfig6
from repro_torch.benchmarks import fig7_perturbations as tfig7
from test_torch_bench_windows import cut_budget, hold_runs, spy_runs

COST_ATOL = 1e-4
ANGLE_ATOL = 1e-4


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


def _same_rows(want, got, close=()):
    assert [(r["bench"], r["name"], r["detail"]) for r in got] == \
        [(r["bench"], r["name"], r["detail"]) for r in want]
    for w, g in zip(want, got):
        tol = next((t for key, t in close if key in w["name"]), None)
        if tol is None:
            assert g["value"] == w["value"], (w, g)
        else:
            assert abs(g["value"] - w["value"]) <= tol, (w, g)


def test_twins_keep_the_reference_constants():
    assert tfig4.N_SEEDS == jfig4.N_SEEDS
    assert (tfig5.N_SEEDS, tfig5.CHECKPOINTS) == (jfig5.N_SEEDS,
                                                  jfig5.CHECKPOINTS)
    assert (tfig6.N_SEEDS, tfig6.TAUS) == (jfig6.N_SEEDS, jfig6.TAUS)
    assert (tfig7.N_SEEDS, tfig7.TYPES) == (jfig7.N_SEEDS, jfig7.TYPES)


def test_fig4_rows_match_reference_at_a_cut(monkeypatch):
    for mod in (jfig4, tfig4):
        monkeypatch.setattr(mod, "N_SEEDS", 1)

        def curve(tau, seed, iters=40000, chunk=2000, _f=mod._mgd_curve,
                  **kw):
            return _f(tau, seed, iters=200, chunk=100, **kw)
        monkeypatch.setattr(mod, "_mgd_curve", curve)
    monkeypatch.setattr(tfig4, "mlp_init", _ref_init)
    _same_rows(jfig4.run(), tfig4.run(device="cpu"),
               close=[("final_cost", COST_ATOL)])


def test_fig5_rows_match_reference_at_a_cut(monkeypatch):
    for mod in (jfig5, tfig5):
        monkeypatch.setattr(mod, "CHECKPOINTS", (100, 1000))

        def angles(sizes, batch, seeds=5, iters=10000, _f=mod._angles,
                   **kw):
            return _f(sizes, batch, seeds=1, iters=1000, **kw)
        monkeypatch.setattr(mod, "_angles", angles)
    monkeypatch.setattr(tfig5, "mlp_init", _ref_init)
    want, got = jfig5.run(), tfig5.run(device="cpu")
    assert len(want) == 6
    _same_rows(want, got, close=[("angle", ANGLE_ATOL)])


def test_fig7_rows_match_reference_at_a_cut(monkeypatch):
    for mod in (jfig7, tfig7):
        monkeypatch.setattr(mod, "N_SEEDS", 1)
    want_runs, got_runs = (spy_runs(monkeypatch, (c,), cut_budget(
        steps=500, chunk=250)) for c in (jcommon, tcommon))
    monkeypatch.setattr(tcommon, "mlp_init", _ref_init)
    _same_rows(jfig7.run(), tfig7.run(device="cpu"))
    hold_runs(want_runs, got_runs)
    assert [w["steps"] for w in want_runs] == [500] * 4
