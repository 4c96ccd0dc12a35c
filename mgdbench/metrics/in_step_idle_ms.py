"""in_step_idle_ms: device idle time a traced step that falls inside the
program's ``mgd.step`` spans on the host's clock, in ms: the card waited
on the program's own dispatch, not on the caller's loop between steps.
Idle is the complement of the device ops' busy intervals
(``program_spans.idle_intervals``), over ``program_spans.traced``'s
steps."""
from mgdbench import program_spans


def read(ctx):
    t = program_spans.traced(ctx)
    if t is None or not t.device_ops:
        return None
    steps = [(ts, ts + dur) for name, ts, dur, _ in t.spans
             if name == "mgd.step"]
    if not steps:
        return None
    us = 0.0
    for a, b in program_spans.idle_intervals(t.device_ops, t.spans):
        for lo, hi in steps:
            us += max(0.0, min(b, hi) - max(a, lo))
    return us / 1e3 / t.steps
