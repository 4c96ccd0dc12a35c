"""device_idle_share: the share of the traced steps' wall time in which
no device op ran, in %: 100 · (1 − busy / window), busy the union of the
device ops' intervals."""


def read(ctx):
    if ctx.traced_s <= 0 or not ctx.device_ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s)
