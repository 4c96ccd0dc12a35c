"""The ``hardware_plants`` twin against the reference's bench, on the CPU.

Both modules are cut alike, by monkeypatching each one's own names:
``N_SEEDS`` = 1, the stability grid to τ_w ∈ {0, 4} × τ_θ ∈ {1, 4},
``train_until`` to a spy (``tests/test_torch_bench_windows.py``) that
runs each call at 200 steps in chunks of 100, ``_nist_accuracy`` to 60
steps and ``_bound_ratio`` to 4 writes; the twin's ``mlp_init`` is the
reference's, converted.  Then ``run()`` of each yields the same rows in
the same order with the same ``detail``, and the values agree: steps and
solved counts equal, NIST7x7 accuracies within two of the 512 eval
samples, bound ratios and the frontier within 1e-4 relative, the
``*_projected_s`` rows exact (and equal to the committed baseline's).
Every run through ``train_until`` is held against the reference's same
run (config, budget and chunk asked, plant, final params, threshold).

The twin's device tables are the reference's, so every XOR row's name
is too.  ``run()`` is held with each XOR table cut to its first device
(each XOR row compiles the reference's scan anew, ~1-2 s here); those
three rows and the stability cell τ_w = 0, τ_θ = 1 run 1500 steps, within
which the reference's init solves each (1100-1400 steps), so the rows
hold outcomes and the frontier both of its sides.  Every XOR row is held
on its own, at the same cut, in ``tests/test_torch_bench_plants_xor.py``.
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from benchmarks import hardware_plants as jhp
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.benchmarks import hardware_plants as thp
from test_torch_bench_windows import (cut_budget, hold_runs, outcome_rows,
                                      spy_runs)

REPO = pathlib.Path(__file__).resolve().parent.parent
ACC_ATOL = 2 / 512
BOUND_RTOL = 1e-4


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


def test_twin_keeps_the_reference_tables():
    for name in ("N_SEEDS", "XOR_PLANTS", "XOR_DACS", "XOR_ADCS",
                 "STABILITY_WRITE_TAUS", "STABILITY_TAU_THETAS"):
        assert getattr(thp, name) == getattr(jhp, name), name
    assert [n for n, _, _ in thp.NIST_DEVICES] == ["ideal", "noisy", "dac8"]


def cut(monkeypatch, budget=None):
    """Both modules' budgets cut alike, ``train_until`` spied on with
    ``budget`` (200 steps in chunks of 100 by default); the twin's init the
    reference's.  Returns the reference's and the twin's runs."""
    runs = []
    for mod in (jhp, thp):
        monkeypatch.setattr(mod, "N_SEEDS", 1)
        monkeypatch.setattr(mod, "STABILITY_WRITE_TAUS", (0.0, 4.0))
        monkeypatch.setattr(mod, "STABILITY_TAU_THETAS", (1, 4))
        nist, bound = mod._nist_accuracy, mod._bound_ratio

        def cut_nist(*a, steps=30000, chunk=6000, _f=nist, **kw):
            return _f(*a, steps=60, chunk=60, **kw)

        def cut_bound(*a, writes=100, _f=bound, **kw):
            return _f(*a, writes=4, **kw)

        runs.append(spy_runs(monkeypatch, (mod,), budget or cut_budget()))
        monkeypatch.setattr(mod, "_nist_accuracy", cut_nist)
        monkeypatch.setattr(mod, "_bound_ratio", cut_bound)
    monkeypatch.setattr(thp, "mlp_init", _ref_init)
    return runs


def test_run_rows_match_reference_at_a_cut(monkeypatch):
    # runs 0-2: ideal, dac10, adc12_round; 3: the cell τ_w = 0, τ_θ = 1
    want_runs, got_runs = cut(monkeypatch, cut_budget(
        {i: 1500 for i in range(4)}))
    for mod in (jhp, thp):
        for table in ("XOR_PLANTS", "XOR_DACS", "XOR_ADCS"):
            monkeypatch.setattr(mod, table, getattr(mod, table)[:1])
    want = jhp.run(seed=0)
    got = thp.run(seed=0, device="cpu")
    hold_runs(want_runs, got_runs)
    assert len(outcome_rows(want)) == 4, outcome_rows(want)
    assert [r["name"] for r in want if "frontier" in r["name"]
            and r["value"] == -1] == []
    assert [(r["bench"], r["name"], r["detail"]) for r in got] == \
        [(r["bench"], r["name"], r["detail"]) for r in want]
    for w, g in zip(want, got):
        name, a, b = w["name"], w["value"], g["value"]
        if name.endswith("_accuracy"):
            assert abs(b - a) <= ACC_ATOL, (name, b, a)
        elif name.endswith("_bound") or "frontier" in name:
            assert (a == b == -1) or abs(b - a) <= BOUND_RTOL * abs(a), \
                (name, b, a)
        else:                         # steps and the projections: exact
            assert b == a, (name, b, a)
    base = {r["name"]: r["value"] for r in json.loads(
        (REPO / "artifacts" / "bench" / "hardware_plants.json").read_text()
    )["rows"]}
    for r in got:
        if r["name"].endswith("_projected_s"):
            assert r["value"] == base[r["name"]]
