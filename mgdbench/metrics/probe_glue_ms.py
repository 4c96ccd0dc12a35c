"""probe_glue_ms: device time a traced step of the ops launched inside the
program's ``mgd.probe`` spans other than the perturbed-matmul kernels
(B2, by ``counts.peaks.KERNEL_KEYS``) and the attention (``attn.core``):
the eager norms, RoPE, activations, residuals, casts, embedding rows and
loss of the probe's forwards, in ms, over ``program_spans.traced``'s
steps."""
from mgdbench import program_spans
from mgdbench.counts import peaks

KEYS = peaks.KERNEL_KEYS["perturbed_matmul_pair"] + \
    peaks.KERNEL_KEYS["perturbed_matmul"]


def read(ctx):
    t = program_spans.traced(ctx)
    if t is None or not any(p and "mgd.probe" in p.split("/")
                            for p in t.op_spans):
        return None
    us = 0.0
    for p, (name, _, dur) in zip(t.op_spans, t.device_ops):
        names = p.split("/") if p else ()
        if ("mgd.probe" in names and "attn.core" not in names
                and not any(k in name for k in KEYS)):
            us += dur
    return us / 1e3 / t.steps
