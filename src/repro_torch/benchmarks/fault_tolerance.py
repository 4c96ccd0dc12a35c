"""Fault tolerance on the port: the chip farm surviving hangs, crashes and
garbage.

    python -m repro_torch.benchmarks.fault_tolerance [--out DIR] [--smoke]
                                                     [--device cpu]

The twin of the reference's ``benchmarks/fault_tolerance.py``: the same
rows (``bench``, ``name``, ``value``, ``detail``), farms, fault specs,
policies, seeds and step budgets (2000 steps; ``--smoke`` 400, the
budget of the committed ``artifacts/bench/fault_tolerance.json``),
through ``repro_torch.driver("probe_parallel_external")`` and
``train_mgd``.  The optimizer (params, perturbations, update) runs on
the CUDA card unless ``--device cpu``; the chips are the reference's
numpy chips, so every readout is the reference chip's for the same
params.  Weights come from the port's own ``mlp_init`` of the
reference's seeds and the batches are the reference's, so the rows are
the reference's experiment, not its trajectory.

Rows: ``fault_free_accuracy`` (a clean k = 4 NIST7x7 farm);
``acc_none_silent`` (10 % NaN/outlier faults, no policy — the failure
mode); ``hold_frac_retry_transient`` (10 % transient faults healed by
retries: bit-identical to fault-free, exactly 1.0, checked here);
``hold_frac_full_silent`` (10 % silent faults under retry + quarantine +
MAD, checked ≥ 0.95); ``hold_frac_quarantine_broken_chip`` and
``broken_chip_attempt_frac`` (chip 3 dies at step 20); ``hang_stall_s``
(a hung chip stalls its step by ≈ the timeout); ``resume_bitexact``
(checkpoint/resume through injected faults).

Writes ``DIR/fault_tolerance.json`` (``{"rows", "seconds", "seed"}`` as
the reference's runner does, plus the device and card) and prints the
rows as CSV.  Gate it, unedited, with ``python -m
benchmarks.check_regression --fresh DIR --baseline artifacts/bench``.
"""
from __future__ import annotations

import tempfile
import time

import torch

from repro_torch.api import DriverConfig, driver
from repro_torch.core.rng import prng_key
from repro_torch.core.utils import tree_leaves
from repro_torch.data import tasks
from repro_torch.data.pipeline import generator_sampler
from repro_torch.device import resolve_device
from repro_torch.hardware import (ChipFarm, FaultPolicy, FaultSpec,
                                  FaultyChip, SimulatedAnalogChip,
                                  simulated_chip_farm)
from repro_torch.models.simple import mlp_init
from repro_torch.training.train_loop import TrainLoopConfig, train_mgd

from .common import bench_cli, sync

K = 4
SIZES = (49, 4, 4)
RATE = 0.10                       # headline transient/silent fault rate
HOLD_TARGET = 0.95                # full policy must keep ≥95% of clean acc
STEPS, SMOKE_STEPS = 2000, 400


def _policy(**kw):
    base = dict(timeout_s=5.0, retries=3, backoff_s=0.01,
                backoff_factor=2.0, backoff_max_s=0.1)
    base.update(kw)
    return FaultPolicy(**base)


# the sweep's policy ladder: nothing → retry → +quarantine → +robust agg
POLICIES = {
    "none": None,
    "retry": _policy(),
    "retry_quarantine": _policy(quarantine_after=4, reprobe_every=60),
    "full": _policy(quarantine_after=4, reprobe_every=60,
                    aggregate="mad", mad_threshold=8.0),
}

TRANSIENT = FaultSpec(transient=RATE)
SILENT = FaultSpec(nan=RATE / 2, outlier=RATE / 2, outlier_scale=50.0)


def _farm(seed, *, faults=None, policy=None):
    # σ_θ = 0: the persistent-write draw is the only live-RNG stream;
    # silencing it makes transient-fault + retry runs BIT-identical to
    # the fault-free run (readouts are (step, tag) counter-keyed)
    return simulated_chip_farm(K, SIZES, base_seed=100 * seed, sigma_a=0.15,
                               sigma_theta=0.0, sigma_c=1e-4,
                               faults=faults, fault_seed=1000 + seed,
                               fault_policy=policy)


def _train(farm, seed, steps, dev):
    cfg = DriverConfig(dtheta=2e-2, eta=0.125 * K, mode="central", seed=seed)
    params = mlp_init(seed, SIZES, device=dev)
    try:
        res = train_mgd(
            None, params, cfg,
            generator_sampler(tasks.nist7x7_batch, 8, seed=11 + seed,
                              device=dev), steps,
            loop=TrainLoopConfig(algorithm="probe_parallel_external",
                                 plant=farm, chunk=max(steps // 4, 1),
                                 log=None), device=dev)
        xe, ye = tasks.nist7x7_batch(prng_key(99), 512, device=dev)
        acc = farm.measure_accuracy(res.params, {"x": xe, "y": ye})
    finally:
        farm.close()
    return float(acc), res


def _sweep_rows(seed, steps, dev):
    rows = []
    acc_clean, _ = _train(_farm(seed), seed, steps, dev)
    rows.append({"bench": "fault_tolerance", "name": "fault_free_accuracy",
                 "value": acc_clean,
                 "detail": f"k={K} nist7x7 farm, {steps} steps, no faults"})

    # the failure mode: silent NaN/outlier corruption, no policy at all
    acc_none, _ = _train(_farm(seed, faults=SILENT), seed, steps, dev)
    rows.append({"bench": "fault_tolerance", "name": "acc_none_silent",
                 "value": acc_none,
                 "detail": f"{RATE:.0%} NaN/outlier faults, no policy — "
                           f"one NaN poisons every chip's update "
                           f"(clean: {acc_clean:.3f})"})

    # transient faults healed by retries: bit-identical to fault-free
    acc_retry, _ = _train(
        _farm(seed, faults=TRANSIENT, policy=POLICIES["retry"]), seed,
        steps, dev)
    hold_retry = acc_retry / acc_clean if acc_clean else 0.0
    rows.append({"bench": "fault_tolerance",
                 "name": "hold_frac_retry_transient", "value": hold_retry,
                 "detail": f"{RATE:.0%} transient faults + retry policy; "
                           f"counter-keyed retries make this exactly 1.0"})
    if hold_retry != 1.0:
        raise RuntimeError(
            f"transient faults healed by retries must be bit-invisible "
            f"(hold fraction 1.0), got {hold_retry}")

    # the headline: silent corruption under the full policy
    farm_full = _farm(seed, faults=SILENT, policy=POLICIES["full"])
    acc_full, _ = _train(farm_full, seed, steps, dev)
    hold_full = acc_full / acc_clean if acc_clean else 0.0
    rows.append({"bench": "fault_tolerance", "name": "hold_frac_full_silent",
                 "value": hold_full,
                 "detail": f"{RATE:.0%} NaN/outlier faults + retry + "
                           f"quarantine + MAD aggregation; "
                           f"{farm_full.fault_summary()['by_kind']}"})
    if hold_full < HOLD_TARGET:
        raise RuntimeError(
            f"full policy held only {hold_full:.3f} of fault-free accuracy "
            f"at {RATE:.0%} silent faults (target ≥ {HOLD_TARGET})")

    # a permanently-broken chip: quarantine + masked average (η rescale)
    broken = FaultSpec(transient=1.0, only_steps=(20, 10 ** 9))
    farm_q = _farm(seed, faults=[None] * (K - 1) + [broken],
                   policy=POLICIES["retry_quarantine"])
    acc_broken, _ = _train(farm_q, seed, steps, dev)
    rows.append({"bench": "fault_tolerance",
                 "name": "hold_frac_quarantine_broken_chip",
                 "value": acc_broken / acc_clean if acc_clean else 0.0,
                 "detail": f"chip {K - 1} dies at step 20; survivors train "
                           f"on the masked average; "
                           f"{farm_q.fault_summary()['by_kind']}"})
    broken_chip = farm_q.devices[-1]
    assert isinstance(broken_chip, FaultyChip)
    rows.append({"bench": "fault_tolerance",
                 "name": "broken_chip_attempt_frac",
                 "value": broken_chip.readouts / steps,
                 "detail": f"broken chip readout attempts per step; without "
                           f"quarantine every step would burn "
                           f"{POLICIES['retry_quarantine'].retries + 1} "
                           f"attempts (+timeouts) on it"})
    return rows


def _small_chip(seed):
    return SimulatedAnalogChip((2, 2, 1), seed=seed, sigma_a=0.1,
                               sigma_theta=0.0, sigma_c=1e-3)


def _xor(dev):
    x, y = tasks.xor_dataset(device=dev)
    return {"x": x, "y": y}


def _hang_row(dev):
    """A hung chip stalls one step by ≈timeout_s, not hang_s: tiny xor
    farm, chip 0 hangs 1.0 s at step 1, policy timeout 0.2 s."""
    batch = _xor(dev)
    hang_s, timeout_s = 1.0, 0.2
    devices = [FaultyChip(
        _small_chip(s), FaultSpec(hang=1.0, hang_s=hang_s,
                                  only_steps=(1, 2)) if s == 0 else
        FaultSpec(), seed=s) for s in range(3)]
    with ChipFarm(devices, fault_policy=_policy(timeout_s=timeout_s,
                                                retries=0)) as farm:
        cfg = DriverConfig(dtheta=1e-2, eta=0.3, mode="central", seed=0)
        mgd = driver("probe_parallel_external", cfg, plant=farm, device=dev)
        p = mlp_init(0, (2, 2, 1), device=dev)
        s = mgd.init(p)
        p, s, _ = mgd.step(p, s, batch)        # step 0: warm up
        sync(dev)
        t0 = time.monotonic()
        p, s, m = mgd.step(p, s, batch)        # step 1: chip 0 hangs
        sync(dev)
        stall = time.monotonic() - t0
    if stall >= 0.85 * hang_s:
        raise RuntimeError(
            f"hung chip stalled the step {stall:.2f}s — the {timeout_s}s "
            f"timeout did not bound it (hang_s={hang_s}s)")
    if int(m["n_valid"]) != 2:
        raise RuntimeError(f"hung chip was not masked: n_valid="
                           f"{int(m['n_valid'])}")
    return {"bench": "fault_tolerance", "name": "hang_stall_s",
            "value": stall,
            "detail": f"step wall-clock with one chip hanging {hang_s}s "
                      f"under timeout_s={timeout_s}; n_valid=2/3"}


def _resume_row(seed, dev):
    """Checkpoint/resume bit-exactness through transient faults healed
    by retries (σ_θ = 0: the trajectory is a pure function of the
    counter-keyed gathered costs)."""
    batch = _xor(dev)

    def loop(**kw):
        farm = simulated_chip_farm(
            2, (2, 2, 1), base_seed=seed, sigma_a=0.1, sigma_theta=0.0,
            sigma_c=1e-3, faults=FaultSpec(transient=0.15),
            fault_seed=500 + seed, fault_policy=_policy())
        return TrainLoopConfig(algorithm="probe_parallel_external",
                               plant=farm, chunk=4, log=None, **kw)

    def run(steps, lp):
        try:
            return train_mgd(None, p0, cfg, lambda i: batch, steps, loop=lp,
                             device=dev)
        finally:
            lp.plant.close()

    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=seed)
    p0 = mlp_init(seed, (2, 2, 1), device=dev)
    cont = run(16, loop())
    with tempfile.TemporaryDirectory() as ckpt_dir:
        run(8, loop(checkpoint_dir=ckpt_dir, checkpoint_every=8))
        res = run(16, loop(checkpoint_dir=ckpt_dir))
    exact = all(torch.equal(a, b) for a, b in
                zip(tree_leaves(cont.params), tree_leaves(res.params)))
    if not exact:
        raise RuntimeError("farm resume through injected faults is not "
                           "bit-exact to the uninterrupted run")
    return {"bench": "fault_tolerance", "name": "resume_bitexact",
            "value": 1.0 if exact else 0.0,
            "detail": "8+8 resumed == 16 uninterrupted, faults injected at "
                      "the same counter-keyed steps, healed by retries"}


def run(seed: int = 0, smoke: bool = False, device=None):
    """The reference's rows, at its budget (``smoke``: 400 steps)."""
    dev = resolve_device(device)
    steps = SMOKE_STEPS if smoke else STEPS
    rows = _sweep_rows(seed, steps, dev)
    rows.append(_hang_row(dev))
    rows.append(_resume_row(seed, dev))
    return rows


def main(argv=None) -> int:
    return bench_cli("fault_tolerance", run, argv, doc=__doc__,
                     smoke_help=f"{SMOKE_STEPS} steps a farm (the committed "
                                f"baseline's budget) instead of {STEPS}")


if __name__ == "__main__":
    raise SystemExit(main())
