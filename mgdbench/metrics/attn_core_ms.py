"""attn_core_ms: device time a traced step of the ops launched inside the
program's ``attn.core`` spans (``models/transformer.py::_attend``, the
chunked causal attention of every layer and stream), in ms, over
``program_spans.traced``'s steps."""
from mgdbench import program_spans


def read(ctx):
    t = program_spans.traced(ctx)
    if t is None:
        return None
    inside = [d for p, (_, _, d) in zip(t.op_spans, t.device_ops)
              if p and "attn.core" in p.split("/")]
    if not inside:
        return None
    return sum(inside) / 1e3 / t.steps
