"""The check can fail: at smoke sizes on the CPU, the lower-precision
control (the reference put in the program's place in fp8, the precision
below the configurations' bf16) and each fault a training cell can have
(a step that returns its state unchanged; half of each batch left out,
the mean taken over the rest) come out not correct, while the program
itself comes out correct.  In float32 the limits are the cells' own, as
they stand in ``limits/``; in bfloat16 the cost's is widened to the
smoke sizes' rounding (``smoke.SMOKE_COST_GAP``).  Each drives the rest
of a run (``harness.run_cell``, without the look for a card) with the
timed path broken underneath.

Besides: a rounding change in the update (the same step computed in
float64 and rounded once) stays under ``change_gap``'s limit at the
cell's magnitudes, where an η 1 % off and a state left unchanged exceed
it; and the rwkv6 reference, which no cell uses yet, holds the port's
materializing path in float32 at the qwen3 cell's limits and catches
half a batch there."""
import json
import math

import pytest
import torch

from mgdbench.tests.smoke import (BENCH, REPO, SMOKE_COST_GAP, add_cell,
                                  load, smoke_tree)
from mgdbench import check, harness
from mgdbench.counts import signs as sg
from mgdbench.reference import mgd as ref_mgd

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]
DTYPES = ["bfloat16", "float32"]
SEEDS = [3, 2 ** 31 + 17]


def _run(tmp_path, workload, seed, dtype, plant=None):
    smoke_tree(tmp_path, dtype)
    cell = load(tmp_path, workload)
    run = harness.CellRun(cell, seed, "cpu")
    run.build()
    if plant:
        plant(run)
    result, _, _ = harness.run_cell(cell, seed, 0.05, False, "cpu", 0.0,
                                    run=run)
    return result


def _frozen(run):
    """Every step returns the parameters it was given."""
    inner = run.run

    def frozen(params, state):
        _, state, aux = inner(params, state)
        return params, state, aux

    run.run = frozen


def _half_batch(run):
    """Every step sees the first half of its batch's rows."""
    sample = run.sample

    def half(n):
        batch = sample(n)
        keep = batch["tokens"].shape[0] // 2
        return {k: v[:keep] for k, v in batch.items()}

    run.sample = half
    run.run = run.rt.make_epoch(run.drv, 1, half)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct(tmp_path, workload, dtype, seed):
    result = _run(tmp_path, workload, seed, dtype)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_is_not_correct(tmp_path, workload, dtype, seed):
    smoke_tree(tmp_path, dtype)
    cell = load(tmp_path, workload)
    run = harness.CellRun(cell, seed, "cpu")
    control = run.reference("fp8")
    followed = run.reference(drive=control["c_tilde"])
    checks, correct = check.judge(run.numbers(control, followed),
                                  cell.limits)
    assert correct is False
    # the control is caught by its costs, not by θ₀ held in fp8 alone
    assert checks["cost_gap"]["value"] > checks["cost_gap"]["limit"]


@pytest.mark.parametrize("fault", [_frozen, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(tmp_path, workload, dtype, fault):
    result = _run(tmp_path, workload, SEEDS[0], dtype, fault)
    assert result["correct"] is False, result["checks"]


# C̃ of the qwen3-14b cell's three checked steps on the chip (seeds 1 and
# 11 of its readings), with its η and Δθ
CHIP_C_TILDE = [[-0.012256622314453125, -0.012359619140625,
                 -0.006310462951660156],
                [0.038233280181884766, 0.022408485412597656,
                 0.0051975250244140625]]
ETA, DTHETA = 1e-3, 1e-2


def _steps(theta0, lseed, c_tildes, how):
    """‖θ₃ − θ₀‖ of one bf16 leaf after the steps along ``c_tildes``."""
    theta = theta0.clone()
    for n, ct in enumerate(c_tildes):
        s = sg.signs(sg.fmix32(lseed + n), 0, theta.numel())
        if how == "unchanged":
            continue
        if how == "float64":
            theta = (theta.double() - ETA * DTHETA * ct / DTHETA ** 2
                     * s.double()).to(torch.bfloat16)
            continue
        eta = ETA * (1.01 if how == "eta_1.01" else 1.0)
        coef = torch.tensor(ct, dtype=torch.float32) * torch.tensor(
            1.0 / (DTHETA * DTHETA), dtype=torch.float32)
        ref_mgd._update(theta, s.to(torch.int8), coef, eta, DTHETA)
    return math.sqrt(((theta.float() - theta0.float()) ** 2).sum(
        dtype=torch.float64).item())


@pytest.mark.parametrize("how,under", [("float64", True),
                                       ("eta_1.01", False),
                                       ("unchanged", False)])
def test_change_gaps_limit_takes_rounding_and_fails_a_wrong_step(how, under):
    limit = json.loads((BENCH / "limits" / f"{CELLS[0]}.json").read_text())[
        "change_gap"]
    gen = torch.Generator().manual_seed(7)
    stds = {"gate": 1 / math.sqrt(5120), "down": 1 / math.sqrt(17408),
            "embed": 0.02}
    for i, (name, std) in enumerate(stds.items()):
        theta0 = (torch.randn(1 << 20, generator=gen) * std).to(
            torch.bfloat16)
        for c_tildes in CHIP_C_TILDE:
            ref = _steps(theta0, 1000 + i, c_tildes, "reference")
            gap = abs(_steps(theta0, 1000 + i, c_tildes, how) - ref) / ref
            assert (gap <= limit) is under, (name, how, gap)


def _rwkv6_cell(tmp_path, dtype):
    smoke_tree(tmp_path, dtype)
    limits = json.loads((BENCH / "limits" / f"{CELLS[0]}.json").read_text())
    if dtype == "bfloat16":
        limits["cost_gap"] = SMOKE_COST_GAP
    return add_cell(tmp_path, "rwkv6-port-7b", "central.8x512", limits)


@pytest.mark.parametrize("fault", [None, _half_batch],
                         ids=["sound", "half_batch"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_rwkv6_reference_holds_the_port(tmp_path, dtype, fault):
    name = _rwkv6_cell(tmp_path, dtype)
    cell = load(tmp_path, name)
    run = harness.CellRun(cell, SEEDS[1], "cpu")
    run.build()
    if fault:
        fault(run)
    result, _, _ = harness.run_cell(cell, SEEDS[1], 0.05, False, "cpu", 0.0,
                                    run=run)
    assert result["correct"] is (fault is None), result["checks"]
