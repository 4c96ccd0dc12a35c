"""device_ops_per_step: device ops (kernels, copies, sets) in the traced
steps, a step: what host dispatch has to launch."""


def read(ctx):
    if not ctx.device_ops:
        return None
    return len(ctx.device_ops) / ctx.trace_steps
