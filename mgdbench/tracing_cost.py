"""What the program's spans cost when they are on, in one process on the
card, and the step's and set-up's time by span.

    python mgdbench/tracing_cost.py --workload <name> --seed <n> \
        --seconds 20 --rounds 2 [--out FILE]

Set-up and the checked steps as a run's, with the program's spans on;
then, with them off and on in turns (off, on, on, off a round), a window
of ``--seconds`` and the cell's traced steps under ``torch.profiler`` (the
device's idle share there, as ``device_idle_share`` reads it), each a
JSON line; last, the cell's traced steps once more with the spans on
(``program_spans.profile_steps``) and a line with the medians, the spans
a step recorded with them on, what ``tracing.span()`` costs a call with
them off (a loop of a million calls on the host), the set-up's first-step
cost (``program_spans.setup_warmup_s``), the signs hashed a parameter and
``program_spans.span_breakdown``'s three lists.  The benchmark's runs do
not run this.
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
for entry in (ROOT / "src", ROOT):
    if str(entry) not in sys.path:
        sys.path.insert(0, str(entry))


def off_cost_us(tracing, calls: int = 1_000_000) -> float:
    """Host µs a ``with tracing.span(...)`` costs with the spans off."""
    tracing.disable()
    t0 = time.perf_counter()
    for _ in range(calls):
        with tracing.span("mgd.probe"):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from mgdbench import harness, program_spans
    from repro_torch import kernels, tracing

    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, ROOT)
    run = harness.CellRun(cell, args.seed, device)
    tracing.clear()
    tracing.enable()
    run.build()
    run.checked_steps()
    tracing.disable()
    setup = program_spans.recorded(tracing)
    lines = []
    rates, idle = {"off": [], "on": []}, {"off": [], "on": []}
    step_s = []
    for r in range(args.rounds):
        for mode in ("off", "on", "on", "off"):
            (tracing.enable if mode == "on" else tracing.disable)()
            run.window(args.seconds)
            tracing.disable()
            spans = len(program_spans.recorded(tracing))
            (tracing.enable if mode == "on" else tracing.disable)()
            run.trace(int(run.tr["trace_steps"]))
            tracing.disable()
            tracing.clear()
            t = run.traced
            busy = sum(b - a for a, b in harness.merge_intervals(
                t.device_ops)) / 1e6
            rate = run.window_steps * run.tokens_per_step / run.window_s
            rates[mode].append(rate)
            if mode == "off":
                step_s.append(run.window_s / run.window_steps)
            idle[mode].append(100.0 * (1.0 - busy / t.wall_s))
            lines.append({"round": r, "spans": mode, "tokens_per_s": rate,
                          "steps": run.window_steps,
                          "spans_a_step": spans / run.window_steps,
                          "traced_idle_share": idle[mode][-1],
                          "traced_s": t.wall_s})
            del run.traced
            print(json.dumps(lines[-1]), flush=True)
    t = program_spans.profile_steps(run.step, int(run.tr["trace_steps"]),
                                    device, tracing, kernels)
    busy = sum(b - a for a, b in harness.merge_intervals(t.device_ops)) / 1e6
    med = {m: statistics.median(v) for m, v in rates.items()}
    summary = {"workload": args.workload, "seed": args.seed,
               "device": torch.cuda.get_device_name(device),
               "median_off": med["off"], "median_on": med["on"],
               "on_over_off": med["on"] / med["off"],
               "idle_share_off": statistics.median(idle["off"]),
               "idle_share_on": statistics.median(idle["on"]),
               "spans_a_step": lines[1]["spans_a_step"],
               "off_span_us": off_cost_us(tracing),
               "setup_warmup_s": program_spans.setup_warmup_s(
                   setup, statistics.median(step_s)),
               "signs_hashed_per_param": sum(t.hashed.values()) / t.steps
               / sum(run.sizes.values()),
               "traced_busy_s": busy, "traced_s": t.wall_s,
               **program_spans.span_breakdown(t.device_ops, t.op_spans,
                                              t.spans, setup)}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
