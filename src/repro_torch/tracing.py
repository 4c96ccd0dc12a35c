"""Program spans: named intervals of the MGD step, off by default.

``span(name, **attrs)`` marks one interval of the program::

    with tracing.span("mgd.probe"):
        ...

Off (the default) it does one check of a module flag and returns a
shared no-op context.  On, it records ``Span(name, start_ns, end_ns,
parent, step, attrs)`` into a bounded buffer on ``time.perf_counter_ns``'s
clock and enters ``torch.profiler.record_function(name)``, so that under
``torch.profiler`` the span lands in the same trace, on the same clock, as
the device ops the host launched inside it (a ``user_annotation`` event).
``parent`` is the name of the enclosing span (None at the top); ``step``
is the MGD step index, set by the ``step`` attribute of ``mgd.step`` and
inherited by the spans inside it.

To read them::

    from repro_torch import kernels, tracing
    tracing.enable()
    params, state, aux = run(params, state)        # a few steps
    tracing.disable()
    for s in tracing.spans():
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.parent, s.step)
    tracing.clear()

Device time by span: enable tracing and wrap the steps in
``torch.profiler.profile(activities=[CPU, CUDA])``; in the exported chrome
trace each device op's ``args.correlation`` names the ``cuda_runtime``
launch event, whose host time falls inside the innermost span that
launched it (``mgdbench/program_spans.py::span_paths`` does this join).

The spans, and what each bounds:

* ``mgd.step`` (attr ``step``): one MGD iteration, ``core/mgd.py``'s
  fused and unfused steps alike;
* ``mgd.data``: ``core/utils.py::epoch_loop``'s wait for a step's batch;
* ``mgd.probe``: the probe, from the perturbed forwards to C̃;
* ``mgd.update``: the update, through ``plant.write_params``;
* ``attn.core``: ``models/transformer.py::_attend``, the chunked causal
  attention of one stream of one layer;
* ``lm.loss``: ``models/transformer.py::_loss_from_logits``;
* ``kernels.build`` (attr ``libs``): nvcc building the missing kernel
  libraries, only when it runs;
* ``kernels.load`` (attr ``lib``): the ``ctypes.CDLL`` of one library.

A slow set-up shows as ``kernels.build`` (nvcc: the libraries were not
built yet) or as a first ``mgd.step`` much longer than the next.  The
sign-hash counters are ``kernels.hash_counts()``.

The buffer keeps the newest ``CAPACITY`` spans; ``dropped()`` counts those
it let go.  Nothing is exported or written: the caller reads ``spans()``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import NamedTuple, Optional

from torch.profiler import record_function

CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    step: Optional[int]
    attrs: dict


_NULL = nullcontext()
_on = False
_buffer: deque = deque(maxlen=CAPACITY)
_dropped = 0
_local = threading.local()   # each thread's stack of open spans


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def spans() -> list:
    """The recorded spans, oldest first, each closed before it is kept."""
    return list(_buffer)


def dropped() -> int:
    """Spans let go since the last ``clear()`` because the buffer was
    full."""
    return _dropped


def clear() -> None:
    global _dropped
    _buffer.clear()
    _dropped = 0


def span(name: str, **attrs):
    """A context marking ``name``'s interval; a no-op while tracing is
    off."""
    if not _on:
        return _NULL
    return _Open(name, attrs)


class _Open:
    __slots__ = ("name", "attrs", "step", "parent", "start", "rf")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.parent = up.name if up else None
        self.step = self.attrs.get("step", up.step if up else None)
        stack.append(self)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        _keep(Span(self.name, self.start, end, self.parent, self.step,
                   self.attrs))
        return False


def _keep(record: Span) -> None:
    global _dropped
    if len(_buffer) == _buffer.maxlen:
        _dropped += 1
    _buffer.append(record)
