"""Hardware-plant robustness curves on the port.

    python -m repro_torch.benchmarks.hardware_plants [--out DIR]
                                                     [--device cpu]
                                                     [--seed N]

The twin of the reference's ``benchmarks/hardware_plants.py``: the same
rows in the same order, device matrix, seeds and budgets.  One optimizer,
many devices: the same driver config drives IdealPlant, NoisyPlant (σ_C
/ σ_θ / σ_a) and QuantizedPlant (k-bit DAC writes, slow-write τ_w, k-bit
ADC cost readout) on xor and nist7x7; two rows project wall-clock per
step from ``PlantMeta`` latency metadata (Table-3 style); the §5
slow-write stability grid measures the bound ratio η·|ĝ|·dt/Δθ beside
steps-to-solve.

Weights come from the port's own ``mlp_init`` of the reference's seeds;
the nist7x7 samplers and eval batch are the reference's draws
(``core.rng``).  The whole budget is hours of eager steps on the card's
host; writes ``DIR/hardware_plants.json`` and prints the rows as CSV.
Gate it with ``python -m benchmarks.check_regression --fresh DIR
--baseline artifacts/bench``.
"""
from __future__ import annotations

import torch

from repro_torch.api import DriverConfig, driver, make_epoch
from repro_torch.core import rng
from repro_torch.core.utils import tree_leaves
from repro_torch.data import tasks
from repro_torch.data.pipeline import dataset_sampler, generator_sampler
from repro_torch.device import resolve_device
from repro_torch.hardware import (PlantMeta, mlp_device_fns, noisy_mlp_plant,
                                  quantized_mlp_plant)
from repro_torch.models.simple import mlp_apply, mlp_init

from .common import bench_cli, median, train_until

N_SEEDS = 3
XOR_PLANTS = [
    ("ideal", dict()),
    ("sigma_c_1e-3", dict(sigma_c=1e-3)),
    ("sigma_c_1e-2", dict(sigma_c=1e-2)),
    ("sigma_theta_0.1", dict(sigma_theta=0.1)),
    ("sigma_a_0.15", dict(sigma_a=0.15)),
]
# w_clip=8: the 2-2-1 XOR solution needs |w| ≈ 5-7, so a ±2 swing makes
# CLIPPING the binding constraint (0/3 solve at any bit depth); at ±8 the
# curve measures quantization itself (LSB 16/(2^bits − 1)).
XOR_DACS = [("dac10", dict(bits=10, w_clip=8.0)),
            ("dac8", dict(bits=8, w_clip=8.0)),
            ("dac6", dict(bits=6, w_clip=8.0)),
            ("dac8_tauw4", dict(bits=8, w_clip=8.0, write_tau=4.0))]
# Mixed-precision READOUT (the DAC's dual): xor cost lives in [0, ~0.3]
# on a unit-range ADC, and the central-mode signal is |C̃| ≈ |g|·Δθ ≈
# 4e-3 at Δθ = 1e-2, so the 8-bit LSB (3.9e-3) is the last depth where
# the error signal clears one code: ≥ 8 bits solves in either rounding
# mode, ≤ 7 bits in neither (deterministic rounding floors C̃; stochastic
# rounding trades the bias for LSB-scale readout variance, ≈ σ_C =
# LSB/√12, which at 7 bits sits in fig8's σ_C ≈ 1e-2 failure band).
XOR_ADCS = [("adc12_round", dict(bits=12, w_clip=8.0, adc_bits=12)),
            ("adc10_round", dict(bits=12, w_clip=8.0, adc_bits=10)),
            ("adc8_round", dict(bits=12, w_clip=8.0, adc_bits=8)),
            ("adc8_stoch", dict(bits=12, w_clip=8.0, adc_bits=8,
                                adc_mode="stochastic")),
            ("adc7_round", dict(bits=12, w_clip=8.0, adc_bits=7)),
            ("adc7_stoch", dict(bits=12, w_clip=8.0, adc_bits=7,
                                adc_mode="stochastic")),
            ("adc6_round", dict(bits=12, w_clip=8.0, adc_bits=6)),
            ("adc6_stoch", dict(bits=12, w_clip=8.0, adc_bits=6,
                                adc_mode="stochastic"))]
# nist7x7: ideal vs the full §3.5 device vs an 8-bit DAC device
NIST_DEVICES = [
    ("ideal", dict(), dict()),
    ("noisy", dict(sigma_c=1e-4, sigma_theta=0.01, sigma_a=0.15), dict()),
    ("dac8", dict(), dict(bits=8)),
]
# Table-3-style projection from plant metadata
PROJECTIONS = [
    ("HW1_chip_in_loop", PlantMeta(name="HW1", read_latency_s=1e-3,
                                   external=True)),
    ("HW2_memcompute", PlantMeta(name="HW2", read_latency_s=10e-9)),
]


def xor_plant(name, seed, device=None):
    """(plant, probe mode) of the XOR row ``name`` of XOR_PLANTS,
    XOR_DACS or XOR_ADCS on device seed ``seed``: a NoisyPlant (or
    IdealPlant) or a QuantizedPlant; the ADC rows probe central."""
    for table, mode in ((XOR_PLANTS, "forward"), (XOR_DACS, "forward"),
                        (XOR_ADCS, "central")):
        kw = dict(table).get(name)
        if kw is None:
            continue
        if table is XOR_PLANTS:
            return noisy_mlp_plant((2, 2, 1), dtheta=1e-2, device_seed=seed,
                                   device=device, **kw), mode
        return quantized_mlp_plant((2, 2, 1), device_seed=seed,
                                   device=device, **kw), mode
    raise KeyError(f"no XOR device row {name!r}")


def _xor_solved(plant, dev):
    """The 'solved' test ON THE DEVICE: the plant's own loss_fn (defects
    included), read before any ADC conversion: judging 'solved' on the
    quantized readout would be undecidable below one LSB, so the bench
    meter, not the chip's ADC, decides."""
    x, y = tasks.xor_dataset(device=dev)

    def thresh(p):
        return float(plant.loss_fn(p, {"x": x, "y": y})) < 0.04
    return thresh


def _xor_row(name, plant_fn, detail, seed0=0, mode="forward", device=None):
    """Steps to solve xor on each of N_SEEDS devices (device seed = param
    seed); the row is the median of the solved runs."""
    dev = resolve_device(device)
    cfg = DriverConfig(dtheta=1e-2, eta=1.0, mode=mode)
    x, y = tasks.xor_dataset(device=dev)
    times = []
    for s in range(seed0, seed0 + N_SEEDS):
        plant = plant_fn(s)
        params = mlp_init(s, (2, 2, 1), device=dev)
        _, steps, ok = train_until(
            None, params, cfg, dataset_sampler(x, y, 1),
            max_steps=60000, threshold_fn=_xor_solved(plant, dev),
            chunk=3000, plant=plant, device=dev)
        times.append(steps if ok else None)
    solved = [t for t in times if t is not None]
    return {
        "bench": "hw_plants", "name": f"xor_{name}_steps",
        "value": median(solved) if solved else -1,
        "detail": f"{len(solved)}/{N_SEEDS} solved; {detail}",
    }


def _nist_accuracy(plant, defects, seed, steps=30000, chunk=6000,
                   device=None):
    """49-4-4 nist7x7 through ``plant``; accuracy read on the device (its
    defects included) over the reference's fixed eval batch."""
    dev = resolve_device(device)
    params = mlp_init(seed, (49, 4, 4), device=dev)
    cfg = DriverConfig(dtheta=1e-2, eta=0.1, seed=seed)
    sample_fn = generator_sampler(tasks.nist7x7_batch, 8, seed=11 + seed,
                                  device=dev)
    mgd = driver("discrete", cfg, None, plant=plant, device=dev)
    run = make_epoch(mgd, chunk, sample_fn)
    state = mgd.init(params)
    for _ in range(steps // chunk):
        params, state, _ = run(params, state)
    xe, ye = tasks.nist7x7_batch(rng.prng_key(99), 512, device=dev)
    with torch.no_grad():
        pred = mlp_apply(params, xe, defects=defects)
    return float(torch.mean((torch.argmax(pred, -1)
                             == torch.argmax(ye, -1)).float()))


def _nist_plant(noisy_kw, dac_kw, dev_seed, dev):
    """(plant, defects) of one nist7x7 device."""
    _, _, defects = mlp_device_fns((49, 4, 4),
                                   sigma_a=noisy_kw.get("sigma_a", 0.0),
                                   device_seed=dev_seed, device=dev)
    if dac_kw:
        plant = quantized_mlp_plant((49, 4, 4), device_seed=dev_seed,
                                    device=dev, **dac_kw)
    else:
        plant = noisy_mlp_plant((49, 4, 4), dtheta=1e-2,
                                device_seed=dev_seed, device=dev,
                                **noisy_kw)
    return plant, defects


def projection_rows():
    return [{
        "bench": "hw_plants", "name": f"xor_{name}_projected_s",
        "value": 1e4 * meta.step_latency_s(reads_per_step=1,
                                           writes_per_step=0),
        "detail": "1e4-step xor budget × PlantMeta read latency",
    } for name, meta in PROJECTIONS]


def run(seed: int = 0, device=None):
    dev = resolve_device(device)
    rows = []
    for table, detail in ((XOR_PLANTS, "NoisyPlant {}"),
                          (XOR_DACS, "QuantizedPlant {}"),
                          (XOR_ADCS, "QuantizedPlant {}")):
        for name, kw in table:
            rows.append(_xor_row(
                name, lambda s, name=name: xor_plant(name, s, dev)[0],
                detail.format(kw or "σ=0"), seed0=seed,
                mode=xor_plant(name, seed, dev)[1], device=dev))

    for name, noisy_kw, dac_kw in NIST_DEVICES:
        accs = []
        for d in range(seed, seed + N_SEEDS):
            plant, defects = _nist_plant(noisy_kw, dac_kw, d, dev)
            accs.append(_nist_accuracy(plant, defects, d, device=dev))
        rows.append({
            "bench": "hw_plants", "name": f"nist7x7_{name}_accuracy",
            "value": median(accs),
            "detail": f"median of {N_SEEDS} devices, 30k steps",
        })
    rows += projection_rows()
    rows += stability_grid_rows(seed, device=dev)
    return rows


# ---------------------------------------------------------------------------
# write_tau × tau_theta stability grid (§5 slow-write bound)
# ---------------------------------------------------------------------------
#
# The analog constraint: the parameter move per persistent write,
# η·|G|·dt (dt = τ_θ steps of accumulated update), must stay well under
# Δθ or the probes measure a plant that has already moved, and a slow
# write (τ_w > 0) makes it worse by low-pass filtering the writes, so the
# chip lags the optimizer by ≈ τ_w additional write periods.  Each grid
# cell reports the MEASURED bound ratio η·|ĝ|·dt_eff/Δθ (mean per-write
# max-abs host update over dt_eff = τ_θ·(1+τ_w), divided by Δθ) next to
# the steps-to-solve, and the frontier separates solving from
# non-solving cells.
STABILITY_WRITE_TAUS = (0.0, 4.0, 16.0)
STABILITY_TAU_THETAS = (1, 8, 32)


def _stability_plant(write_tau, seed, dev):
    return quantized_mlp_plant((2, 2, 1), device_seed=seed, bits=12,
                               w_clip=8.0, write_tau=write_tau, device=dev)


def _flat(params):
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(params)])


def _bound_ratio(write_tau, tau_theta, seed, writes=100, device=None):
    """Measured η·|ĝ|·dt/Δθ: the MEAN max-abs parameter change across a
    write interval, over the first ``writes`` intervals, in Δθ units
    scaled by the slow-write lag factor (1 + τ_w).  Mean, not median:
    through a quantized DAC the update stream goes zero-heavy once the
    driver reaches a code plateau, and the median of a zero-heavy stream
    reads 0.0 even while the transient moved whole LSBs.  One host read
    a write."""
    dev = resolve_device(device)
    plant = _stability_plant(write_tau, seed, dev)
    cfg = DriverConfig(dtheta=1e-2, eta=1.0, mode="forward",
                       tau_theta=tau_theta, seed=seed)
    x, y = tasks.xor_dataset(device=dev)
    batch = {"x": x, "y": y}
    mgd = driver("discrete", cfg, None, plant=plant, device=dev)
    p = mlp_init(seed, (2, 2, 1), device=dev)
    s = mgd.init(p)
    prev = _flat(p)
    deltas = []
    for n in range(writes * tau_theta):
        p, s, _ = mgd.step(p, s, batch)
        if (n + 1) % tau_theta == 0:
            flat = _flat(p)
            deltas.append(float(torch.max(torch.abs(flat - prev))))
            prev = flat
    return (sum(deltas) / len(deltas)) * (1.0 + write_tau) / cfg.dtheta


def stability_grid_rows(seed: int = 0, device=None):
    """One row pair (steps-to-solve, bound ratio) per grid cell, plus the
    measured frontier: the largest bound ratio that still solved and the
    smallest that failed."""
    dev = resolve_device(device)
    rows = []
    solved_ratios, failed_ratios = [], []
    x, y = tasks.xor_dataset(device=dev)
    for wt in STABILITY_WRITE_TAUS:
        for tt in STABILITY_TAU_THETAS:
            cell = f"wtau{wt:g}_tautheta{tt}"
            cfg = DriverConfig(dtheta=1e-2, eta=1.0, mode="forward",
                               tau_theta=tt)
            times = []
            for s in range(seed, seed + N_SEEDS):
                plant = _stability_plant(wt, s, dev)
                params = mlp_init(s, (2, 2, 1), device=dev)
                _, steps, ok = train_until(
                    None, params, cfg, dataset_sampler(x, y, 1),
                    max_steps=40000, threshold_fn=_xor_solved(plant, dev),
                    chunk=2000, plant=plant, device=dev)
                times.append(steps if ok else None)
            solved = [t for t in times if t is not None]
            ratio = _bound_ratio(wt, tt, seed, device=dev)
            (solved_ratios if len(solved) > N_SEEDS // 2
             else failed_ratios).append(ratio)
            rows.append({
                "bench": "hw_plants", "name": f"stability_{cell}_steps",
                "value": median(solved) if solved else -1,
                "detail": f"{len(solved)}/{N_SEEDS} solved; write_tau={wt} "
                          f"tau_theta={tt}"})
            rows.append({
                "bench": "hw_plants", "name": f"stability_{cell}_bound",
                "value": ratio,
                "detail": "measured η·|ĝ|·τ_θ·(1+τ_w)/Δθ (≪1 ⇒ stable)"})
    rows.append({
        "bench": "hw_plants", "name": "stability_frontier_max_solved_bound",
        "value": max(solved_ratios) if solved_ratios else -1,
        "detail": "largest bound ratio among solving cells"})
    rows.append({
        "bench": "hw_plants", "name": "stability_frontier_min_failed_bound",
        "value": min(failed_ratios) if failed_ratios else -1,
        "detail": "smallest bound ratio among non-solving cells"})
    return rows


def main(argv=None) -> int:
    return bench_cli("hardware_plants", run, argv, doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
