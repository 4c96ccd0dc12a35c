"""Readings that set a cell's limits, in one process on the card.

    python mgdbench/calibrate.py --workload <name> --seeds 0-11 \
        --seconds 40 [--control 3] [--half-batch 3] [--eta 1e-4] \
        [--out FILE]

For each seed: the program's set-up and checked steps, a measured window
of ``--seconds`` (its costs must stay finite), then the float32 reference
along the program's C̃, the compared numbers (``check.numbers``) and
``grad_gap``, a reading no cell compares (below).  For
the first ``--control`` seeds the control too: the reference put in the
program's place in fp8, the precision below the configurations' bf16
(``fp8``: parameters, each θ ± θ̃, the updates and every matmul operand;
``fp8_matmul``, a milder reading: the operands alone), each held to the
float32 reference along its own C̃.  For the first ``--half-batch`` seeds
a planted fault: the program's steps on half of each batch, the mean
taken over the rest.  ``--eta`` overrides the traffic's η (the search for
a safe η).  One JSON line a reading; the benchmark's runs do not run
this.
"""
import argparse
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
for entry in (ROOT / "src", ROOT):
    if str(entry) not in sys.path:
        sys.path.insert(0, str(entry))


def seeds_of(text):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def raw(run_readings):
    """A run's readings as JSON: costs, and each leaf's change norms."""
    out = {"costs": run_readings["costs"], "c_tilde": run_readings["c_tilde"]}
    for key in ("change_1", "change_n"):
        out[key] = {"/".join(p): v for p, v in run_readings[key].items()}
    return out


def grad_gap(prog, ref, sizes, *, eta: float, dtheta: float):
    """The first gradient as the optimizer got it, worked out from the
    program's state after one step (‖θ₁ − θ₀‖ of each leaf), against the
    reference's own first step from θ₀, worst leaf, over the steady scale
    of that norm: η/Δθ · √n (the larger of the leaf's and the median
    leaf's) · the RMS of the reference's C̃ over the checked steps.  (A
    leaf's MGD gradient is C̃·θ̃/Δθ², of norm |C̃|·√n/Δθ; C̃ is a random
    projection that can come near 0, so its own step is no steady
    scale.)"""
    from mgdbench import check
    keep, med_root = check._kept(sizes)
    ct = ref["c_tilde"]
    rms = math.sqrt(sum(c * c for c in ct) / len(ct))
    return check._worst(prog["change_1"], ref["change_1"], keep,
                        lambda p: eta / dtheta * rms
                        * max(math.sqrt(sizes[p]), med_root))


def readings(run, prog, ref):
    """The compared numbers of ``run`` and its ``grad_gap``."""
    return dict(run.numbers(prog, ref), grad_gap=grad_gap(
        prog, ref, run.sizes, eta=float(run.tr["eta"]),
        dtheta=float(run.tr["dtheta"])))


def half_batch(sample):
    def half(n):
        batch = sample(n)
        keep = batch["tokens"].shape[0] // 2
        return {k: v[:keep] for k, v in batch.items()}
    return half


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="0-11")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--half-batch", type=int, default=0)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from mgdbench import harness

    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, ROOT)
    if args.eta is not None:
        cell.traffic = dict(cell.traffic, eta=args.eta)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(seeds_of(args.seeds)):
        t0 = time.perf_counter()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
        run = harness.CellRun(cell, seed, dev)
        run.first_change = True
        run.build()
        run.checked_steps()
        run.window(args.seconds)
        prog = run.program_readings()
        costs = [round(c, 4) for c in run.window_costs.tolist()]
        run.free()
        peak = torch.cuda.max_memory_allocated(dev)
        t1 = time.perf_counter()
        ref = run.reference(drive=prog["c_tilde"])
        t2 = time.perf_counter()
        emit({"workload": args.workload, "seed": seed, "kind": "program",
              "eta": cell.traffic["eta"], "numbers": readings(run, prog, ref),
              "prog": raw(prog), "ref": raw(ref),
              "window_steps": run.window_steps, "window_s": run.window_s,
              "window_costs": costs, "program_s": t1 - t0,
              "reference_s": t2 - t1, "peak_gb": peak / 1e9})
        for precision in ("fp8", "fp8_matmul") if i < args.control else ():
            t3 = time.perf_counter()
            ctl = run.reference(precision)
            ctl_ref = run.reference(drive=ctl["c_tilde"])
            emit({"workload": args.workload, "seed": seed,
                  "kind": f"control_{precision}",
                  "numbers": readings(run, ctl, ctl_ref), "control": raw(ctl),
                  "ref": raw(ctl_ref), "s": time.perf_counter() - t3})
        if i < args.half_batch:
            fault = harness.CellRun(cell, seed, dev)
            fault.first_change = True
            fault.build()
            fault.sample = half_batch(fault.sample)
            fault.run = fault.rt.make_epoch(fault.drv, 1, fault.sample)
            fault.checked_steps()
            bad = fault.program_readings()
            fault.free()
            bad_ref = fault.reference(drive=bad["c_tilde"])
            emit({"workload": args.workload, "seed": seed,
                  "kind": "fault_half_batch",
                  "numbers": readings(fault, bad, bad_ref), "fault": raw(bad),
                  "ref": raw(bad_ref)})
    if out:
        out.close()


if __name__ == "__main__":
    main()
