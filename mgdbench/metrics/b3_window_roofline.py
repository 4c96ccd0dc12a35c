"""b3_window_roofline: the window update kernel's (B3) share of its
roofline over the traced steps, in %: every ndim ≥ 2 leaf read and
written once a step, with the hash's INT32-lane instructions
(``counts.peaks.window_bound_s``, one launch a dtype), over the kernel's
device time."""
import math

from mgdbench.counts import peaks


def read(ctx):
    if ctx.launches.get("mgd_update_window", 0) < ctx.trace_steps:
        return None
    keys = peaks.KERNEL_KEYS["mgd_update_window"]
    busy_us = sum(d for n, _, d in ctx.device_ops if any(k in n for k in keys))
    if busy_us <= 0:
        return None
    numel = {}
    for _, shape, dtype, _ in ctx.specs:
        if len(shape) >= 2:
            numel[dtype] = numel.get(dtype, 0) + math.prod(shape)
    bound = sum(peaks.window_bound_s(n, dt) for dt, n in numel.items())
    return 100.0 * bound * ctx.trace_steps / (busy_us / 1e6)
