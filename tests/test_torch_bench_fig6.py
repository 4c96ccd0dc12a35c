"""The ``fig6_tau_theta`` twin against the reference's bench, on the CPU.

Both modules are cut alike, by monkeypatching each one's own names:
``N_SEEDS`` = 1, ``TAUS`` = (1, 16), and ``common.train_until`` of each
package (which ``time_to_solve_xor`` calls) to the run spy of
``tests/test_torch_bench_windows.py`` at 100 steps in chunks of 100; the
twin's ``mlp_init`` (``common``'s) is the reference's, converted.  Two
runs go on to a solve (the reference's init solves each within the
longer cut): batch 4 at τ_θ = 16 (τ_x = 4, 1700 steps) and τ_θ = 1 at η =
1 (1400), which ends part (b)'s η grid at its > 50 % stop, so
``batch4_tau16_steps`` and ``max_eta_tau1`` hold outcomes.  ``run()`` of
each yields the reference's rows in order with the same ``detail`` and
values, and each run is held against the reference's (``hold_runs``:
config with its τ_x and η, budget and chunk asked, final params,
threshold).  η = 8 and 4 at τ_θ = 1 are chaotic: the port lands 1.58
from the reference's η = 4 run after 100 steps, as the reference's own
run computed eagerly does (1.53), the witness that holds it.
"""
import pytest
import torch

from benchmarks import common as jcommon
from benchmarks import fig6_tau_theta as jfig6
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import fig6_tau_theta as tfig6
from test_torch_bench_figs import _ref_init, _same_rows
from test_torch_bench_windows import (cut_budget, hold_runs, outcome_rows,
                                      spy_runs)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Thousands of tiny ops: one intra-op thread a test (see
    ``tests/test_torch_bench_twins.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fig6's runs in call order at TAUS = (1, 16): (a) batch 1 τ 1, 16, batch
# 4 τ 1, 16; (b) τ 1 at η 8, 4, 2, 1 (solved: the grid stops), τ 16 at all
# five η.  The two that solve, and the steps they are given:
FIG6_LONG = {3: 1800, 7: 1500}


def test_fig6_rows_match_reference_at_a_cut(monkeypatch):
    for mod in (jfig6, tfig6):
        monkeypatch.setattr(mod, "N_SEEDS", 1)
        monkeypatch.setattr(mod, "TAUS", (1, 16))
    want_runs, got_runs = (spy_runs(monkeypatch, (c,), cut_budget(
        FIG6_LONG, steps=100)) for c in (jcommon, tcommon))
    monkeypatch.setattr(tcommon, "mlp_init", _ref_init)
    want = jfig6.run()
    _same_rows(want, tfig6.run(device="cpu"))
    hold_runs(want_runs, got_runs)
    assert len(want_runs) == 13
    assert [(r["name"], r["value"]) for r in outcome_rows(want)] == [
        ("batch4_tau16_steps", 1700), ("max_eta_tau1", 1.0)]
