"""The program's spans on synthetic chrome traces and at smoke size on
this CPU: the join of each device op to the span that launched it, the
three lists it makes, the four readers of spans and hash counters (and
their None where a program has none), the readers' own steps
(``program_spans.traced``), and that span events leave every list and
reader that was there before them as it was."""
import json
import math
from types import SimpleNamespace

import pytest
import torch

from mgdbench.tests.smoke import BENCH, REPO, load, smoke_tree
from mgdbench import harness, program_spans as ps

CELL = "qwen3-14b.central.8x512"
B2 = "void (anonymous namespace)::perturbed_matmul_tc_kernel<2, 4, bf16>"


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": args.pop("tid", 1), "args": args}


SPANS = [("mgd.data", -10, 8), ("mgd.step", 0, 100), ("mgd.probe", 10, 50),
         ("attn.core", 20, 10), ("lm.loss", 50, 5), ("mgd.update", 70, 20)]
# (correlation, launch ts on the host, device op, its ts and dur)
OPS = [(1, -5, "rand", 0, 4), (2, 5, "copy", 6, 2), (3, 22, "gemm", 12, 30),
       (4, 40, B2, 45, 40), (5, 52, "logsumexp", 90, 5),
       (6, 75, "mgd_update_window_kernel<bf16>", 100, 10),
       (7, 95, "stack", 115, 5), (8, 200, "tail", 200, 5)]


def _events(with_spans=True):
    ev = [_x("cpu_op", "aten::mm", 21, 3), _x("cpu_op", "aten::copy_", 4, 2),
          _x("cpu_op", "aten::add", 96, 1)]
    for corr, launch, name, ts, dur in OPS:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 1,
                     correlation=corr))
        ev.append(_x("kernel", name, ts, dur, correlation=corr))
    if with_spans:
        ev += [_x("user_annotation", n, ts, dur) for n, ts, dur in SPANS]
        ev.append(_x("gpu_user_annotation", "mgd.probe", 12, 80, tid=7))
    return ev


def test_each_device_op_takes_the_innermost_span_open_at_its_launch():
    dev, host, spans, corr, launch = ps.trace_events(_events())
    assert [d[0] for d in dev] == [o[2] for o in OPS]
    assert corr == [o[0] for o in OPS]
    assert [s[0] for s in spans] == [s[0] for s in SPANS]
    assert ps.span_paths(corr, launch, spans) == [
        "mgd.data", "mgd.step", "mgd.step/mgd.probe/attn.core",
        "mgd.step/mgd.probe", "mgd.step/mgd.probe/lm.loss",
        "mgd.step/mgd.update", "mgd.step", None]


def test_a_launch_on_another_thread_takes_that_threads_spans():
    ev = _events() + [_x("cuda_runtime", "cudaLaunchKernel", 25, 1, tid=2,
                         correlation=9),
                      _x("kernel", "other", 130, 1, correlation=9)]
    dev, _, spans, corr, launch = ps.trace_events(ev)
    assert ps.span_paths(corr, launch, spans)[-1] is None


def test_the_three_span_lists_partition_the_device_and_idle_time():
    dev, host, spans, corr, launch = ps.trace_events(_events())
    setup = [("kernels.build", 0.0, 9.0, "mgd.step", 0),
             ("mgd.step", 0.0, 12.5, None, 0), ("kernels.load", 9.0, 9.5,
                                                "mgd.step", 0),
             ("mgd.step", 13.0, 14.0, None, 1)]
    bd = ps.span_breakdown(dev, ps.span_paths(corr, launch, spans),
                                spans, setup)
    by = dict(bd["device_s_by_span"])
    assert by == pytest.approx({"mgd.data": 4e-6, "mgd.step": 7e-6,
                                "attn.core": 30e-6, "mgd.probe": 40e-6,
                                "lm.loss": 5e-6, "mgd.update": 10e-6,
                                "no span": 5e-6})
    assert math.isclose(sum(by.values()),
                        sum(d for _, _, d in dev) / 1e6)
    # busy [0, 4], [6, 8], [12, 42], [45, 85], [90, 95], [100, 110],
    # [115, 120], [200, 205]; the spans reach from -10: idle from there,
    # each gap put down to the innermost span open at its start
    idle = ps.idle_intervals(dev, spans)
    assert idle == [(-10, 0), (4, 6), (8, 12), (42, 45), (85, 90),
                    (95, 100), (110, 115), (120, 200)]
    assert dict(bd["idle_s_by_span"]) == pytest.approx(
        {"mgd.data": 10e-6, "mgd.step": (2 + 4 + 5) * 1e-6,
         "mgd.probe": 3e-6, "mgd.update": 5e-6,
         "outside": (5 + 80) * 1e-6})
    assert bd["setup_s_by_span"] == [["mgd.step", 13.5],
                                     ["kernels.build", 9.0],
                                     ["kernels.load", 0.5]]


def test_without_spans_the_lists_fall_to_no_span_and_outside():
    dev, host, spans, corr, launch = ps.trace_events(_events(False))
    bd = ps.span_breakdown(dev, ps.span_paths(corr, launch, spans),
                                spans, [])
    busy = sum(d for _, _, d in dev) / 1e6
    assert bd["device_s_by_span"] == [["no span", pytest.approx(busy)]]
    assert [k for k, _ in bd["idle_s_by_span"]] == ["outside"]
    assert bd["setup_s_by_span"] == []


def _traced(events, steps=1, hashed=None, n_params=10):
    dev, _, spans, corr, launch = ps.trace_events(events)
    return SimpleNamespace(steps=steps, wall_s=400e-6, device_ops=dev,
                           spans=spans,
                           op_spans=ps.span_paths(corr, launch, spans),
                           hashed=hashed, n_params=n_params)


def _ctx(events, **kw):
    """A reader context whose spans ``program_spans.traced`` has taken."""
    dev, _, _, _, _ = ps.trace_events(events)
    busy = harness.merge_intervals(dev)
    base = dict(device_ops=dev, trace_steps=1,
                busy_s=sum(b - a for a, b in busy) / 1e6, traced_s=400e-6,
                launches={"perturbed_matmul_pair": 0,
                          "mgd_update_window": 1}, step_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


def _reader(name):
    return harness.load_reader(BENCH / "metrics", name)


def test_the_span_readers_on_a_synthetic_trace():
    ctx = _ctx(_events(), program_spans=_traced(_events(), steps=2))
    assert _reader("attn_core_ms")(ctx) == pytest.approx(30e-3 / 2)
    # mgd.probe's ops but B2 and attn.core: the loss's
    assert _reader("probe_glue_ms")(ctx) == pytest.approx(5e-3 / 2)
    # idle inside mgd.step [0, 100]: (4, 6), (8, 12), (42, 45), (85, 90),
    # (95, 100)
    assert _reader("in_step_idle_ms")(ctx) == pytest.approx(19e-3 / 2)


def test_the_counter_reader_and_the_set_up_warm_up():
    ctx = _ctx(_events(), program_spans=_traced(
        _events(), steps=2, n_params=1000,
        hashed={"perturbed_matmul_pair": 16000, "mgd_update_window": 2000,
                "rademacher_signs": 10}))
    assert _reader("signs_hashed_per_param")(ctx) == pytest.approx(
        18010 / 2 / 1000)
    setup = [("mgd.step", 100.0, 107.0, None, 0),
             ("kernels.build", 100.5, 103.5, "mgd.step", 0),
             ("kernels.build", 90.0, 99.0, None, None),
             ("mgd.step", 107.0, 108.5, None, 1)]
    assert ps.setup_warmup_s(setup, 1.5) == pytest.approx(7 - 3 - 1.5)
    assert ps.setup_warmup_s(setup[1:3], 1.5) is None


READERS = ["attn_core_ms", "probe_glue_ms", "in_step_idle_ms",
           "signs_hashed_per_param"]


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_or_counters_reads_none(name):
    # spans taken, but none of them and no counter: a trace of the parent
    bare = _ctx(_events(False), program_spans=_traced(_events(False)))
    assert _reader(name)(bare) is None
    # a program with no span module: nothing is stepped
    old = _ctx(_events(False), rt=SimpleNamespace(__name__="no_such_program"))
    assert _reader(name)(old) is None
    assert old.program_spans is None


def _smoke_run(tmp_path):
    smoke_tree(tmp_path, dtype="float32")
    run = harness.CellRun(load(tmp_path, "qwen3-14b.central.8x512"), 5, "cpu")
    run.build()
    run.checked_steps()
    run.trace(1)
    return run, harness.reader_context(run, 1.0)


def test_the_readers_steps_are_their_own_and_leave_the_run_as_it_was(
        tmp_path):
    from repro_torch import kernels, tracing
    run, ctx = _smoke_run(tmp_path)
    before = {k: v.clone() for k, v in harness.weights.flatten(
        ctx.params).items()}
    t = ps.traced(ctx)
    assert ps.traced(ctx) is t
    # spans off again (the shared no-op) and the buffer left empty
    assert tracing.span("a") is tracing.span("b") and tracing.spans() == []
    names = [s[0] for s in t.spans]
    steps = ctx.trace_steps
    assert t.steps == steps and names.count("mgd.step") == steps
    for name in ("mgd.data", "mgd.probe", "mgd.update", "attn.core",
                 "lm.loss"):
        assert name in names
    # 2 layers x 2 signs of the attention and 2 losses a step
    assert names.count("attn.core") == 4 * steps
    assert names.count("lm.loss") == 2 * steps
    assert t.n_params == sum(run.sizes.values())
    assert set(t.hashed) == set(kernels.hash_counts())
    assert sum(t.hashed.values()) > 0
    for k, v in harness.weights.flatten(ctx.params).items():
        assert torch.equal(v, before[k]), k


def test_the_readers_driver_is_the_harness_s(tmp_path):
    run, ctx = _smoke_run(tmp_path)
    drv, _ = ps.cell_driver(ctx)
    batch = run.sample(0)
    with torch.no_grad():
        a = run.drv.step(run.params, run.state, batch)
        b = drv.step(run.params, run.state, batch)
    assert torch.equal(a[2]["cost"], b[2]["cost"])
    assert torch.equal(a[2]["c_tilde"], b[2]["c_tilde"])
    for k, v in harness.weights.flatten(a[0]).items():
        assert torch.equal(v, harness.weights.flatten(b[0])[k]), k


def test_span_events_change_no_list_or_reader_that_was_there():
    plain = ps.trace_events(_events(False))
    spanned = ps.trace_events(_events())
    assert plain[0] == spanned[0] and plain[1] == spanned[1]
    assert (harness.breakdown(plain[0], plain[1])
            == harness.breakdown(spanned[0], spanned[1]))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    old = [m["name"] for m in bench["per_layer"]][:5]
    assert old == ["train_mfu", "b2_pair_roofline", "b3_window_roofline",
                   "device_idle_share", "device_ops_per_step"]
    conf = json.loads((BENCH / "configs" / "qwen3-14b.json").read_text())
    from mgdbench.reference import family
    fam = family(conf["reference"])
    tr = json.loads((BENCH / "traffic" / "central.8x512.json").read_text())
    for name in old:
        got = [_reader(name)(_ctx(
            ev, conf=conf, traffic=tr, fam=fam, specs=fam.leaf_specs(conf),
            tokens_per_step=4096)) for ev in (_events(False), _events())]
        assert got[0] == got[1]
    # the benchmark's other readers read no field the span readers add
    assert [m["name"] for m in bench["per_layer"]][5:9] == READERS
