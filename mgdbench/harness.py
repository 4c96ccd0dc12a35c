"""One run of one cell: set-up, the measured window, the traced steps,
the per-layer readers and the check against the reference.

The cell's configuration is a training run of the port's normal path:
``repro_torch.driver("discrete", DriverConfig(mode="central",
tau_theta=1, fused=True, ...), model_loss, probe_fn=
make_transformer_probe_fn(cfg))`` driven a step at a time by
``repro_torch.make_epoch(drv, 1, sample)``.  The dense decoders probe
through the fused pair kernel (B2), the other families materialize
θ ± θ̃ (``perturbed_tree``); both update through the window kernel (B3).

Set-up draws the weights and builds the driver, then runs the checked
steps through that same ``run``: they warm up every shape the window
uses, and the check follows them.  The window then steps until
``--seconds`` have passed.  Nothing the benchmark reads is made by the
program except its outputs: costs, C̃, the parameters after a step.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from mgdbench import check, traffic as traffic_mod, weights
from mgdbench.reference import family as ref_family
from mgdbench.reference import mgd as ref_mgd

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: pathlib.Path = ROOT):
    """The cell's entries and files, found by the names in
    ``BENCHMARK.json``."""
    bench = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if work is None:
        raise SystemExit(f"mgdbench: no workload {workload!r} in "
                         f"BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    bench_dir = root / "mgdbench"
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    return SimpleNamespace(
        bench=bench, work=work, cfg_entry=cfg_entry,
        conf=_json(root / cfg_entry["file"]),
        traffic=_json(bench_dir / "traffic" / f"{work['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{workload}.json"),
        per_layer=per_layer, end_to_end=e2e, metrics_dir=bench_dir / "metrics")


def forbidden_modules(names=None):
    """Loaded modules (``names``: those of ``sys.modules``) whose top-level
    name, the part before the first dot, is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_reader(metrics_dir: pathlib.Path, name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "mgdbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CellRun:
    """One run of a cell on ``device``, stage by stage."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.conf, self.tr = cell.conf, cell.traffic
        self.fam = ref_family(self.conf["reference"])
        self.specs = self.fam.leaf_specs(self.conf)
        self.sizes = {s[0]: math.prod(s[1]) for s in self.specs}
        self.mgd_seed = weights.mix64(self.seed, 0x36D) & 0xFFFFFFFF
        self.n_checked = int(self.tr["checked_steps"])
        self.first_change = False   # calibrate.py's grad_gap reads it
        self.tokens_per_step = int(self.tr["batch"]) * int(self.tr["seq"])
        self.check_s = 0.0

    # -- the program -------------------------------------------------------

    def build(self):
        import repro_torch as rt
        from repro_torch.launch.specs import abstract_params
        self.rt = rt
        self.cfg = rt.get_config(self.conf["program"]).replace(
            **self.fam.program_fields(self.conf))
        self._check_layout(weights.flatten(abstract_params(self.cfg)))
        self.params = weights.nest(weights.make(self.specs, self.seed,
                                                self.device))
        self.sample = traffic_mod.sampler(self.tr, self.cfg.vocab, self.seed,
                                          self.device)
        cfg = self.cfg
        self.drv = rt.driver(
            "discrete",
            rt.DriverConfig(dtheta=float(self.tr["dtheta"]),
                            eta=float(self.tr["eta"]), mode="central",
                            tau_theta=1, probes=1, seed=self.mgd_seed,
                            fused=True),
            lambda p, b: rt.model_loss(p, cfg, b),
            probe_fn=rt.make_transformer_probe_fn(cfg), device=self.device)
        self.state = self.drv.init(self.params)
        self.run = rt.make_epoch(self.drv, 1, self.sample)

    def _check_layout(self, program_leaves):
        """The program's tree must be the one the weights are drawn for."""
        mine = {s[0]: (tuple(s[1]), weights.DTYPES[s[2]]) for s in self.specs}
        theirs = {p: (tuple(t.shape), t.dtype)
                  for p, t in program_leaves.items()}
        if mine != theirs:
            diff = sorted(set(mine.items()) ^ set(theirs.items()))
            raise SystemExit(f"mgdbench: the program's parameter tree is not "
                             f"the configuration's: {diff[:6]}")

    def step(self):
        self.params, self.state, aux = self.run(self.params, self.state)
        return aux

    def _change_norms(self):
        t0 = time.perf_counter()
        norms = ref_mgd.change_norms(
            weights.flatten(self.params),
            weights.leaf_slices(self.specs, self.seed, self.device))
        _sync(self.device)
        self.check_s += time.perf_counter() - t0
        return norms

    def checked_steps(self):
        """Set-up's steps: the check's first steps and every shape's
        warm-up, through the window's own ``run``."""
        self.checked = []
        with torch.no_grad():
            for n in range(self.n_checked):
                aux = self.step()
                self.checked.append(aux)
                if n == 0 and self.first_change:
                    self.change_1 = self._change_norms()
            self.change_n = self._change_norms()

    def window(self, seconds: float):
        """Steps until ``seconds`` have passed, each ended by a
        synchronize; the rate is over all of them and all that time."""
        costs, steps = [], 0
        with torch.no_grad():
            _sync(self.device)
            t0 = time.perf_counter()
            while True:
                costs.append(self.step()["cost"])
                _sync(self.device)
                steps += 1
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds:
                    break
        self.window_steps, self.window_s = steps, elapsed
        self.window_costs = torch.cat(costs).float()

    def trace(self, steps: int):
        """``steps`` more steps under ``torch.profiler``: the device ops,
        the host ops, the launch counters and the traced wall time."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch import kernels
        before = kernels.launch_counts()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with torch.no_grad(), profile(activities=acts) as prof:
            _sync(self.device)
            t0 = time.perf_counter()
            for _ in range(steps):
                self.step()
            _sync(self.device)
            wall = time.perf_counter() - t0
        after = kernels.launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = _json(path).get("traceEvents", [])
        del prof
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
            if e.get("cat") in DEVICE_CATS:
                dev.append(item)
            elif e.get("cat") == "cpu_op":
                host.append(item)
        self.traced = SimpleNamespace(
            steps=steps, wall_s=wall, device_ops=dev, host_ops=host,
            launches={k: after[k] - before[k] for k in after})

    # -- the reference -----------------------------------------------------

    def numbers(self, prog, ref):
        return check.numbers(prog, ref, self.sizes)

    def program_readings(self):
        costs = [[(a["cost"] + a["c_tilde"]).item(),
                  (a["cost"] - a["c_tilde"]).item()] for a in self.checked]
        nonfinite = 0
        if hasattr(self, "window_costs"):
            nonfinite = int((~torch.isfinite(self.window_costs)).sum())
        out = {"costs": costs, "c_tilde": [a["c_tilde"].item()
                                           for a in self.checked],
               "change_n": self.change_n, "nonfinite": nonfinite}
        if self.first_change:
            out["change_1"] = self.change_1
        return out

    def free(self):
        """Drop the program's state so that the reference has the card."""
        for name in ("params", "state", "drv", "run", "checked"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", drive=None):
        """The reference's first steps from θ₀ drawn again, along the
        C̃s ``drive`` where given (``reference.mgd.follow``)."""
        params = weights.make(self.specs, self.seed, self.device)
        sample = traffic_mod.sampler(self.tr, self.fam.dims(self.conf)
                                     ["vocab"], self.seed, self.device)
        out = ref_mgd.follow(
            self.fam, self.conf, params, sample,
            weights.leaf_slices(self.specs, self.seed, self.device),
            dtheta=float(self.tr["dtheta"]), eta=float(self.tr["eta"]),
            seed=self.mgd_seed, steps=self.n_checked, precision=precision,
            drive=drive, first_change=self.first_change)
        del params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


# ---------------------------------------------------------------------------
# the traced window's reductions
# ---------------------------------------------------------------------------


def merge_intervals(ops):
    """Disjoint busy intervals (start, end) in µs of (name, ts, dur) ops."""
    spans = sorted((ts, ts + dur) for _, ts, dur in ops)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def breakdown(device_ops, host_ops, top: int = 10):
    """The device ops that took most time and the longest idle gaps,
    each gap named by the innermost host op running at its start, or, in
    Python between ops, by the last op the host had finished."""
    by_name = {}
    for name, _, dur in device_ops:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merge_intervals(device_ops)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted(host_ops, key=lambda h: h[1])
    named = []
    for a, b in gaps:
        inner, last = None, None
        for name, ts, dur in host:
            if ts > a:
                break
            if ts + dur >= a and (inner is None or ts >= inner[1]):
                inner = (name, ts)
            elif ts + dur < a and (last is None or ts + dur >= last[1]):
                last = (name, ts + dur)
        label = inner[0] if inner else (
            f"after {last[0]}" if last else "no host op")
        named.append([label, (b - a) / 1e6])
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": named}


def reader_context(run: CellRun, step_s: float):
    t = run.traced
    busy = merge_intervals(t.device_ops)
    return SimpleNamespace(
        conf=run.conf, traffic=run.tr, fam=run.fam, cfg=run.cfg,
        specs=run.specs, device_ops=t.device_ops, trace_steps=t.steps,
        busy_s=sum(b - a for a, b in busy) / 1e6, traced_s=t.wall_s,
        launches=t.launches, step_s=step_s, params=run.params, rt=run.rt,
        step=run.state.step, mgd_seed=run.mgd_seed,
        tokens_per_step=run.tokens_per_step, device=run.device)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, run=None):
    """Every stage of one run; returns (result dict, check lines).
    ``run`` may be a prepared ``CellRun`` (the tests plant faults in
    one)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    run = run or CellRun(cell, seed, device)
    if not hasattr(run, "drv"):
        run.build()
    run.checked_steps()
    _sync(device)
    setup_s = time.time() - t_start - run.check_s
    run.window(seconds)
    step_s = run.window_s / run.window_steps
    metrics, extra = {}, {}
    if trace:
        run.trace(int(run.tr["trace_steps"]))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if trace:
        ctx = reader_context(run, step_s)
        for m in cell.per_layer:
            value = load_reader(cell.metrics_dir, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.traced_s}
        bd = breakdown(run.traced.device_ops, run.traced.host_ops)
        del ctx, run.traced      # the readers' hold on the parameters
    else:
        rate = run.window_steps * run.tokens_per_step / run.window_s
        values = {"train_tokens_per_s": rate, "peak_mem_gb": peak / 1e9,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    prog = run.program_readings()
    run.free()
    ref = run.reference(drive=prog["c_tilde"])
    checks, correct = check.judge(run.numbers(prog, ref), cell.limits)
    result = {"correct": correct, "attempted": run.window_steps,
              "failed": int(prog["nonfinite"]), "metrics": metrics,
              "device": device_info(device, peak, extra)}
    if trace:
        result["breakdown"] = bd
    result["checks"] = checks
    lines = [f"check {name}: {c['value']!r} limit {c['limit']!r}"
             for name, c in checks.items()]
    return result, lines, {"program": prog, "reference": ref}


def device_info(device, peak: int, extra):
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info.update(extra)
    return info
