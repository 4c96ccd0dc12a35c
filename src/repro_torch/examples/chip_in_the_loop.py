"""Chip-in-the-loop training through ``hardware.ExternalPlant`` (paper §4/§6).

An analog accelerator sits behind an OPAQUE lab-instrument API — write
parameters, present an input, read ONE scalar cost.  The device
internally has per-neuron activation defects (σ_a), parameter-write
noise (σ_θ) and cost-readout noise (σ_C) that the trainer never models —
the regime where model-free MGD shines.  The optimizer runs on the card
(unless ``--device cpu``); the chips are numpy instruments on the host.

* ``--chips 1`` (default): one chip behind ``ExternalPlant`` driven by
  the discrete central-difference driver.
* ``--chips k``: a FARM of k simulated chips with distinct device seeds
  behind ``ChipFarm``, driven by ``driver("probe_parallel_external")`` —
  k probes on the k instruments, the trainer averages the k scalars.

``--drift σ_d`` ages the chip(s) (``DriftingAnalogChip``, keyed on the
optimizer's step counter).  ``--fault-rate p`` makes the instrument(s)
unreliable (``FaultyChip``) and arms the host boundary with a
``FaultPolicy``; the fault summary prints at the end.

    PYTHONPATH=src python -m repro_torch.examples.chip_in_the_loop
    PYTHONPATH=src python -m repro_torch.examples.chip_in_the_loop \\
        --chips 4 --fault-rate 0.1 [--device cpu]
"""
import argparse

import repro_torch as rt
from repro_torch.core import rng
from repro_torch.data.tasks import nist7x7_batch
from repro_torch.hardware import (DriftingAnalogChip, ExternalPlant,
                                  FaultPolicy, FaultSpec, FaultyChip,
                                  SimulatedAnalogChip, simulated_chip_farm)
from repro_torch.hardware.external import host_batch, host_params

SIZES = (49, 4, 4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=1,
                    help="farm size k (1 = single chip via ExternalPlant)")
    ap.add_argument("--steps", type=int, default=4001,
                    help="training iterations")
    ap.add_argument("--eval-every", type=int, default=800,
                    help="on-chip accuracy readout period")
    ap.add_argument("--eta", type=float, default=None,
                    help="learning rate (default: 0.1 single chip; "
                         "0.125·k for a farm)")
    ap.add_argument("--drift", type=float, default=0.0, metavar="SIGMA_D",
                    help="per-step random-walk std of the stored weights")
    ap.add_argument("--fault-rate", type=float, default=0.0, metavar="P",
                    help="per-readout fault probability; arms the "
                         "FaultPolicy host boundary")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    eta = args.eta if args.eta is not None else (
        0.1 if args.chips == 1 else 0.125 * args.chips)

    # central mode: the only step an external plant runs
    cfg = rt.DriverConfig(dtheta=2e-2, eta=eta, tau_theta=1,
                          mode="central", seed=0)
    if args.chips == 1:
        if args.drift:
            chip = DriftingAnalogChip(SIZES, seed=0, sigma_a=0.15,
                                      sigma_theta=0.01, sigma_c=1e-4,
                                      drift_rate=args.drift)
        else:
            chip = SimulatedAnalogChip(SIZES, seed=0, sigma_a=0.15,
                                       sigma_theta=0.01, sigma_c=1e-4)
        device, policy = chip, None
        if args.fault_rate:
            # a single chip cannot be masked — retries must carry it
            device = FaultyChip(chip, FaultSpec(transient=args.fault_rate),
                                seed=99)
            policy = FaultPolicy(timeout_s=10.0, retries=4, backoff_s=0.01)
        plant = ExternalPlant(device, fault_policy=policy)
        mgd = rt.driver("discrete", cfg, plant=plant, device=dev)

        def accuracy(params, batch):
            chip.set_params(host_params(params))   # commit, then read out
            return chip.measure_accuracy(host_batch(batch))

        def writes():
            return chip.writes
    else:
        faults = policy = None
        if args.fault_rate:
            faults = FaultSpec(transient=args.fault_rate / 2,
                               outlier=args.fault_rate / 2,
                               outlier_scale=50.0)
            policy = FaultPolicy(timeout_s=10.0, retries=4, backoff_s=0.01,
                                 quarantine_after=6, reprobe_every=100,
                                 aggregate="mad")
        farm = simulated_chip_farm(args.chips, SIZES, base_seed=0,
                                   sigma_a=0.15, sigma_theta=0.01,
                                   sigma_c=1e-4, drift_rate=args.drift,
                                   faults=faults, fault_policy=policy)
        plant = farm
        mgd = rt.driver("probe_parallel_external", cfg, plant=farm,
                        device=dev)
        accuracy = farm.measure_accuracy

        def writes():
            return farm.total_writes

    # the trainer's view: parameters it *believes* are on the chip(s)
    params = rt.mlp_init(1, SIZES, device=dev)
    state = mgd.init(params)
    key = rng.prng_key(7)
    acc = None
    with plant:
        for it in range(args.steps):
            key, kb = rng.split(key)
            x, y = nist7x7_batch(kb, 8, device=dev)
            params, state, metrics = mgd.step(params, state,
                                              {"x": x, "y": y})
            if it % args.eval_every == 0:
                xe, ye = nist7x7_batch(rng.prng_key(99), 256, device=dev)
                acc = accuracy(params, {"x": xe, "y": ye})
                print(f"iter {it:5d}: on-chip cost "
                      f"{float(metrics['cost']):.4f} accuracy {acc:.3f} "
                      f"(param writes: {writes()})")
        drift_note = (f", re-trimming drift sigma_d={args.drift:g}/step "
                      f"online" if args.drift else "")
        print(f"trained {args.chips} chip(s) through the opaque interface "
              f"only — no gradients, no defect model, no weight "
              f"readback{drift_note}.")
        if args.fault_rate:
            print(f"fault-tolerance summary at fault rate "
                  f"{args.fault_rate:g}: {plant.fault_summary()}")
    return acc


if __name__ == "__main__":
    main()
