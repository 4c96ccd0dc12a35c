"""train_mfu: the step's model flops (``counts.flops``, two forwards a
central step) over the untraced window's seconds a step, as a share of
the card's dense peak for the configuration's type, in %."""
import math

from mgdbench.counts import flops, peaks


def read(ctx):
    dims = ctx.fam.flop_dims(ctx.conf)
    n_params = sum(math.prod(s[1]) for s in ctx.specs)
    work = flops.model_flops(n_params, dims["n_embed"], int(ctx.traffic["batch"]),
                             int(ctx.traffic["seq"]),
                             attn_layers=dims["attn_layers"],
                             d_attn=dims["d_attn"], n_forwards=2)
    return 100.0 * work / ctx.step_s / peaks.PEAK_OPS[ctx.conf["dtype"]]
