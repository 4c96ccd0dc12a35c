"""The program's spans and sign-hash counters on the profiler's clock, for
the per-layer readers of them (``attn_core_ms``, ``probe_glue_ms``,
``in_step_idle_ms``, ``signs_hashed_per_param``) and for
``tracing_cost.py``.

The harness's traced steps run with the program's spans off and keep no
span event, so the first of these readers in a traced run takes steps of
its own (``traced``): a driver built as ``harness.CellRun.build`` builds
one, a fresh state, and each step from the parameters the window left and
that same state, so that no step's output outlives it and the card holds
what it held in the window.  One step warms up; the cell's
``trace_steps`` more run under ``torch.profiler`` with the program's spans
on (``repro_torch.tracing``).  Each device op is then put down to the
spans open on its launching thread at its launch's host time (the
``cuda_runtime`` event of its ``args.correlation``).  The result is kept
on the reader context, so the other readers take the same steps.  A
program without ``repro_torch.tracing`` gets no steps: its readers read
None.  Nothing here runs in an untraced run.
"""
from __future__ import annotations

import importlib
import json
import math
import pathlib
import tempfile
import time
from types import SimpleNamespace

import torch

from mgdbench import harness, traffic as traffic_mod

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"


def program_module(rt, name: str):
    """``<rt>.<name>`` of the program, or None where it has no such
    module (a program from before its spans)."""
    try:
        return importlib.import_module(f"{rt.__name__}.{name}")
    except (ImportError, AttributeError):
        return None


def trace_events(events):
    """From a chrome trace's events: the device ops and host ops as
    (name, ts µs, dur µs), the program's spans as (name, ts, dur, tid),
    each device op's launch correlation id (None where it has none) and
    the launches {correlation: (ts, tid)}."""
    dev, host, spans, corr, launch = [], [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        args = e.get("args") or {}
        if cat in harness.DEVICE_CATS:
            dev.append(item)
            corr.append(args.get("correlation"))
        elif cat == "cpu_op":
            host.append(item)
        elif cat == SPAN_CAT:
            spans.append(item + (e.get("tid"),))
        elif cat in LAUNCH_CATS and args.get("correlation") is not None:
            launch[args["correlation"]] = (float(e["ts"]), e.get("tid"))
    return dev, host, spans, corr, launch


def open_paths(spans, times):
    """For each host time in ``times``, the path ("outer/inner") of the
    spans (name, ts, dur, ...) open at it, or None: one sweep over the
    spans sorted by start, whose nesting a stack keeps."""
    order = sorted(range(len(times)), key=times.__getitem__)
    ordered = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, i = [None] * len(times), [], 0
    for j in order:
        t = times[j]
        while i < len(ordered) and ordered[i][1] <= t:
            while stack and stack[-1][1] + stack[-1][2] <= ordered[i][1]:
                stack.pop()
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1][1] + stack[-1][2] <= t:
            stack.pop()
        if stack:
            out[j] = "/".join(s[0] for s in stack)
    return out


def span_paths(corr, launch, spans):
    """Each device op's span path: the spans open on its launching thread
    at its launch's host time (the launch event of its correlation id),
    or None."""
    by_tid = {}
    for j, c in enumerate(corr):
        if c in launch:
            ts, tid = launch[c]
            by_tid.setdefault(tid, []).append((j, ts))
    out = [None] * len(corr)
    for tid, items in by_tid.items():
        mine = [s for s in spans if s[3] == tid]
        for (j, _), path in zip(items, open_paths(mine, [t for _, t in items])):
            out[j] = path
    return out


def idle_intervals(device_ops, spans=()):
    """(start, end) µs of the device's idle time between the first and
    the last moment the ops or the spans cover: the gaps between busy
    intervals, and before the first and after the last op where spans
    reach past them."""
    busy = harness.merge_intervals(device_ops)
    if not busy:
        return []
    lo = min([busy[0][0]] + [s[1] for s in spans])
    hi = max([busy[-1][1]] + [s[1] + s[2] for s in spans])
    edges = [lo] + [x for b in busy for x in b] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _totals(pairs):
    out = {}
    for key, value in pairs:
        out[key] = out.get(key, 0.0) + value
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])]


def span_breakdown(device_ops, op_spans, spans, setup_spans=()):
    """The traced steps' device seconds by the innermost span their ops
    were launched in ("no span" for the rest), their idle seconds by the
    innermost span open on the host at each idle interval's start
    ("outside" where none was), and the set-up spans' seconds by name
    (``setup_spans`` as ``recorded`` gives them)."""
    inner = [p.rsplit("/", 1)[-1] if p else "no span" for p in op_spans]
    idle = idle_intervals(device_ops, spans)
    at = open_paths(spans, [a for a, _ in idle])
    return {
        "device_s_by_span": _totals(
            (n, dur / 1e6) for n, (_, _, dur) in zip(inner, device_ops)),
        "idle_s_by_span": _totals(
            (p.rsplit("/", 1)[-1] if p else "outside", (b - a) / 1e6)
            for p, (a, b) in zip(at, idle)),
        "setup_s_by_span": _totals((s[0], s[2] - s[1]) for s in setup_spans)}


def recorded(tracing):
    """The program's in-memory spans as (name, start s, end s, parent,
    step), emptying its buffer."""
    out = [(s.name, s.start_ns / 1e9, s.end_ns / 1e9, s.parent, s.step)
           for s in tracing.spans()]
    tracing.clear()
    return out


def setup_warmup_s(setup_spans, step_s: float):
    """What the first step costs beyond a warm one: the first ``mgd.step``
    of ``setup_spans`` (``recorded``'s), less the ``kernels.build`` spans
    inside it (nvcc), less ``step_s``; None without an ``mgd.step``."""
    steps = sorted((s for s in setup_spans if s[0] == "mgd.step"),
                   key=lambda s: s[1])
    if not steps:
        return None
    _, lo, hi, *_ = steps[0]
    build = sum(s[2] - s[1] for s in setup_spans
                if s[0] == "kernels.build" and lo <= s[1] and s[2] <= hi)
    return hi - lo - build - step_s


def profile_steps(step, steps: int, device, tracing, kernels):
    """``steps`` calls of ``step()`` under ``torch.profiler`` with the
    program's spans on: the device ops, the spans, each op's span path,
    the hash-count differences (None where the program counts none) and
    the wall time."""
    from torch.profiler import ProfilerActivity, profile
    hash_counts = getattr(kernels, "hash_counts", None)
    before = hash_counts() if hash_counts else None
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    tracing.clear()
    tracing.enable()
    try:
        with torch.no_grad(), profile(activities=acts) as prof:
            harness._sync(device)
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            harness._sync(device)
            wall = time.perf_counter() - t0
    finally:
        tracing.disable()
    tracing.clear()
    hashed = None
    if before is not None:
        hashed = {k: v - before.get(k, 0) for k, v in hash_counts().items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    del prof
    dev, _, spans, corr, launch = trace_events(events)
    return SimpleNamespace(steps=steps, wall_s=wall, device_ops=dev,
                           spans=spans, op_spans=span_paths(corr, launch,
                                                            spans),
                           hashed=hashed)


def cell_driver(ctx):
    """The cell's driver as ``harness.CellRun.build`` builds it, with a
    sampler drawn from ``ctx.mgd_seed``: ``(drv, run)``."""
    rt, cfg, tr = ctx.rt, ctx.cfg, ctx.traffic
    drv = rt.driver(
        "discrete",
        rt.DriverConfig(dtheta=float(tr["dtheta"]), eta=float(tr["eta"]),
                        mode="central", tau_theta=1, probes=1,
                        seed=ctx.mgd_seed, fused=True),
        lambda p, b: rt.model_loss(p, cfg, b),
        probe_fn=rt.make_transformer_probe_fn(cfg), device=ctx.device)
    sample = traffic_mod.sampler(tr, cfg.vocab, ctx.mgd_seed, ctx.device)
    return drv, rt.make_epoch(drv, 1, sample)


def traced(ctx):
    """The program's spans over the cell's ``trace_steps`` steps of its
    own (the module's docstring), kept as ``ctx.program_spans``; None
    where the program has no spans."""
    if hasattr(ctx, "program_spans"):
        return ctx.program_spans
    ctx.program_spans = None
    rt = getattr(ctx, "rt", None)
    tracing = program_module(rt, "tracing") if rt is not None else None
    if tracing is None:
        return None
    drv, run = cell_driver(ctx)
    state = drv.init(ctx.params)

    def step():
        run(ctx.params, state)

    with torch.no_grad():
        step()
    got = profile_steps(step, int(ctx.trace_steps), ctx.device, tracing,
                        program_module(rt, "kernels"))
    got.n_params = sum(math.prod(s[1]) for s in ctx.specs)
    ctx.program_spans = got
    return got
