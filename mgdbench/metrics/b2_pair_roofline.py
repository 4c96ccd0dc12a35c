"""b2_pair_roofline: the antithetic pair kernel's (B2) share of its
roofline over the traced steps, in %: the sum over its launches of
``counts.peaks.pair_bound_s`` over the sum of its device time.  The fused
path launches it once a step for every weight matrix (each stacked
layer's and the head's) at M = batch × seq; where the launch counter
shows another count the shapes are unknown and nothing is read."""
from mgdbench.counts import peaks


def _matrices(specs):
    for path, shape, dtype, _ in specs:
        if path[-1] == "w" and len(shape) >= 2:
            lead = shape[0] if path[0] == "layers" else 1
            yield lead, shape[-2], shape[-1], dtype


def read(ctx):
    mats = list(_matrices(ctx.specs))
    per_step = sum(lead for lead, _, _, _ in mats)
    if ctx.launches.get("perturbed_matmul_pair", 0) != per_step * ctx.trace_steps:
        return None
    keys = peaks.KERNEL_KEYS["perturbed_matmul_pair"]
    busy_us = sum(d for n, _, d in ctx.device_ops if any(k in n for k in keys))
    if busy_us <= 0:
        return None
    m = ctx.tokens_per_step
    bound = sum(lead * peaks.pair_bound_s(m, k, n, dt)
                for lead, k, n, dt in mats) * ctx.trace_steps
    return 100.0 * bound / (busy_us / 1e6)
