#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--steps N] [--out FILE]

Phases, each fatal on failure (nothing is caught):

1. Device and build: require a CUDA card, print ``nvidia-smi``'s name and
   power limit, compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, in parallel) and print ptxas's register,
   shared-memory and spill report.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (x [B,49]·W [49,4], x [B,4]·W [4,4], B ∈ {1, 8}), at a
   ragged shape (5, 127, 257) and at one sizing shape, x [256,5120]·W
   [5120,17408] f32.  Pass: f32 max relative error ≤ 1e-4, bf16 ≤ 0.15,
   window update bitwise.  Each is timed with CUDA events after warm-up,
   beside its plain version, a library yardstick (``torch.matmul`` /
   ``Tensor.add_``) and the card's bound for the same work.
3. Training, the main path: NIST7x7 49-4-4 with the paper's Δθ = 1e-2,
   η = 0.1, seed 1, fused, through ``repro_torch.driver`` and
   ``make_epoch``: central τ_θ = 1, forward τ_θ = 1 and central replay
   τ_θ = 4.  The launch counters are zeroed before each run and must equal
   the per-step counts the path implies; the first 32 C̃ must agree with
   the same run through the plain versions on the card (atol 1e-5); costs
   must stay finite.  Steps/s and held-out accuracy on 512 samples are
   printed.
4. Where a main-path step's time goes: wall time per step, and device
   time per step and per kernel from ``torch.profiler`` (central and
   forward τ_θ = 1, 40 steps each).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing neither, when
there is no CUDA card or the repo's sources are not beside this file.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3

MAIN_SHAPES = [(1, 49, 4), (1, 4, 4), (8, 49, 4), (8, 4, 4)]
RAGGED = (5, 127, 257)
SIZING = (256, 5120, 17408)
TRAIN_STEPS = 3000
CT_CHECK_STEPS = 32
CT_ATOL = 1e-5
TOL = {"float32": 1e-4, "bfloat16": 0.15}
# substrings of each kernel's demangled name in a profiler trace
KERNEL_KEYS = {"perturbed_matmul": "perturbed_matmul_kernel<1",
               "perturbed_matmul_pair": "perturbed_matmul_kernel<2",
               "mgd_update_window": "mgd_update_window_kernel"}

SOURCES = {
    "perturbed_matmul": ("src/repro_torch/kernels/csrc/perturbed_matmul.cu",
                         "src/repro/kernels/perturbed_matmul.py:137"),
    "perturbed_matmul_pair": (
        "src/repro_torch/kernels/csrc/perturbed_matmul.cu",
        "src/repro/kernels/perturbed_matmul.py:234"),
    "mgd_update_window": ("src/repro_torch/kernels/csrc/mgd_update.cu",
                          "src/repro/kernels/mgd_update.py:159"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _demangle(names):
    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()
    return {n: d.replace("(anonymous namespace)::", "").split("(")[0]
            for n, d in zip(names, out)}


def ptxas_summary(reports):
    """One line per compiled kernel: registers, shared memory, spills."""
    found = []
    for lib, rep in reports.items():
        entry, info = None, []
        for line in rep.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry, info = m.group(1), []
            elif entry and "spill" in line:
                info.append(line.strip())
            elif entry and "Used" in line:
                info.append(line.split(":", 1)[-1].strip())
                found.append((lib, entry, "; ".join(info)))
                entry = None
    names = _demangle([e for _, e, _ in found])
    return [f"ptxas [{lib}] {names[e]}: {info}" for lib, e, info in found]


def time_ms(fn, budget_ms: float = 60.0) -> float:
    """Mean device time of ``fn`` over a run of launches, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(200, max(3, budget_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max().item()
            / max(1.0, b.float().abs().max().item()))


def compare_kernels(torch, rt_ops, pert, dev):
    """Phase 2: every kernel against its plain version on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    lseed = pert.leaf_seed(1, 0, 3)
    cases = [(s, "float32") for s in MAIN_SHAPES] + [
        (RAGGED, "float32"), (RAGGED, "bfloat16"), (SIZING, "float32")]
    recs = {name: [] for name in SOURCES}
    windows_done = set()
    for (m, k, n), dname in cases:
        dt = getattr(torch, dname)
        esz = torch.tensor([], dtype=dt).element_size()
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        xm = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.1).to(dt)
        shape = [m, k, n]

        def single(impl=None):
            return rt_ops.perturbed_matmul(x, w, lseed, dtheta=1e-2,
                                           sign=-1.0, impl=impl)

        def pair(impl=None):
            return rt_ops.perturbed_matmul_pair(x, xm, w, lseed, dtheta=1e-2,
                                                impl=impl)

        err = rel_err(single(), single("ref"))
        yp, ym = pair()
        rp, rm = pair("ref")
        err_p = max(rel_err(yp, rp), rel_err(ym, rm))
        torch.cuda.synchronize()
        for name, e in (("perturbed_matmul", err), ("perturbed_matmul_pair",
                                                     err_p)):
            if not e <= TOL[dname]:
                fail(f"{name} {shape} {dname}: rel err {e} > {TOL[dname]}")
        xs2 = torch.stack([x, xm])
        b1 = bound(2.0 * m * k * n, (m * k + k * n + m * n) * esz)
        b2 = bound(4.0 * m * k * n, (2 * m * k + k * n + 2 * m * n) * esz)
        recs["perturbed_matmul"].append(dict(
            shape=shape, dtype=dname, max_abs_err=(
                single().float() - single("ref").float()).abs().max().item(),
            max_rel_err=err, ms=time_ms(single),
            plain_ms=time_ms(lambda: single("ref")),
            library_ms=time_ms(lambda: torch.matmul(x, w)),
            bound_ms=b1[0], bound_by=b1[1]))
        recs["perturbed_matmul_pair"].append(dict(
            shape=shape, dtype=dname, max_abs_err=max(
                (yp.float() - rp.float()).abs().max().item(),
                (ym.float() - rm.float()).abs().max().item()),
            max_rel_err=err_p, ms=time_ms(pair),
            plain_ms=time_ms(lambda: pair("ref")),
            library_ms=time_ms(lambda: torch.matmul(xs2, w)),
            bound_ms=b2[0], bound_by=b2[1]))
        for j in ((1, 4) if dname == "float32" else (4,)):
            if (k, n, dname, j) in windows_done:
                continue
            windows_done.add((k, n, dname, j))
            seeds = rt_ops.seeds_tensor(
                [pert.leaf_seed(1, t, 3) for t in range(j)], dev)
            coefs = torch.randn((j,), generator=gen, device=dev)

            def window(impl=None):
                return rt_ops.mgd_update_window(w, seeds, coefs, alpha=-0.1,
                                                dtheta=1e-2, impl=impl)

            got, want = window(), window("ref")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"mgd_update_window {[k, n]} J={j} {dname}: not "
                     f"bitwise equal to the plain version (max abs diff "
                     f"{(got.float() - want.float()).abs().max().item()})")
            w2 = w.clone()
            d = torch.randn_like(w)
            b3 = bound(2.0 * j * k * n, 2 * k * n * esz + 8 * j)
            recs["mgd_update_window"].append(dict(
                shape=[k, n], dtype=dname, window=j, max_abs_err=0.0,
                max_rel_err=0.0, ms=time_ms(window),
                plain_ms=time_ms(lambda: window("ref")),
                library_ms=time_ms(lambda: w2.add_(d)),
                bound_ms=b3[0], bound_by=b3[1]))
        del x, xm, w, xs2
        torch.cuda.empty_cache()
    return recs


def train(torch, rt, kernels, tasks, pipeline, card, steps, dev):
    """Phase 3: the main path, three fused runs on the card."""
    base = dict(dtheta=1e-2, eta=0.1, seed=1, fused=True)
    runs = {
        "central_tau1": (dict(mode="central"), dict(
            perturbed_matmul_pair=2 * steps, mgd_update_window=2 * steps,
            perturbed_matmul=0)),
        "forward_tau1": (dict(mode="forward"), dict(
            perturbed_matmul=2 * steps, mgd_update_window=2 * steps,
            perturbed_matmul_pair=0)),
        "central_replay4": (dict(mode="central", replay=True, tau_theta=4),
                            dict(perturbed_matmul_pair=2 * steps,
                                 mgd_update_window=2 * (steps // 4),
                                 perturbed_matmul=0)),
    }
    xe, ye = tasks.nist7x7_batch(pipeline.sample_generator(99, 0, dev), 512)

    def loss(p, b):
        return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])

    totals = {name: 0 for name in SOURCES}
    results = {}
    for name, (kw, expected) in runs.items():
        sample = pipeline.generator_sampler(tasks.nist7x7_batch, 1, seed=7,
                                            device=dev)
        p0 = rt.mlp_init(2, (49, 4, 4), device=dev)

        def make(impl):
            return rt.driver("discrete",
                             rt.DriverConfig(kernel_impl=impl, **base, **kw),
                             loss, probe_fn=rt.make_mlp_probe_fn(),
                             device=dev)

        ref = make("ref")
        _, _, ref_aux = rt.make_epoch(ref, CT_CHECK_STEPS, sample)(
            p0, ref.init(p0))
        drv = make(None)
        kernels.reset_launch_counts()
        params, state, aux = rt.make_epoch(drv, CT_CHECK_STEPS, sample)(
            p0, drv.init(p0))
        ct_err = (aux["c_tilde"] - ref_aux["c_tilde"]).abs().max().item()
        if not ct_err <= CT_ATOL:
            fail(f"{name}: first {CT_CHECK_STEPS} C̃ differ from the plain "
                 f"route by {ct_err} > {CT_ATOL}")
        finite = bool(torch.isfinite(aux["cost"]).all())
        epoch = rt.make_epoch(drv, 250, sample)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = CT_CHECK_STEPS
        while done < steps:
            n = min(250, steps - done)
            run = epoch if n == 250 else rt.make_epoch(drv, n, sample)
            params, state, aux = run(params, state)
            finite = finite and bool(torch.isfinite(aux["cost"]).all())
            done += n
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if counts != expected:
            fail(f"{name}: launches {counts} != expected {expected}")
        if not finite:
            fail(f"{name}: a cost went non-finite")
        out = rt.mlp_apply(params, xe)
        if tuple(out.shape) != (512, 4) or not bool(torch.isfinite(out).all()):
            fail(f"{name}: held-out outputs {tuple(out.shape)} not finite")
        acc = (out.argmax(-1) == ye.argmax(-1)).float().mean().item()
        for k, v in counts.items():
            totals[k] += v
        results[name] = dict(
            steps=steps, steps_per_s=(steps - CT_CHECK_STEPS) / dt,
            heldout_acc_512=acc, final_cost=aux["cost"][-1].item(),
            c_tilde_max_abs_err_vs_plain=ct_err, launches=counts, card=card)
        print(json.dumps({"train": name, **results[name]}), flush=True)
    return results, totals


def profile_main_path(torch, rt, tasks, pipeline, card, dev, steps=40):
    """Phase 4: where a main-path step's time goes.  Wall time per step
    without the profiler, then device time per step and per kernel from
    ``torch.profiler``'s CUDA activity over the same number of steps."""
    from torch.profiler import ProfilerActivity, profile

    def loss(p, b):
        return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])

    out = {}
    for name, mode in (("central_tau1", "central"),
                       ("forward_tau1", "forward")):
        drv = rt.driver("discrete", rt.DriverConfig(
            dtheta=1e-2, eta=0.1, seed=1, fused=True, mode=mode), loss,
            probe_fn=rt.make_mlp_probe_fn(), device=dev)
        sample = pipeline.generator_sampler(tasks.nist7x7_batch, 1, seed=7,
                                            device=dev)
        p = rt.mlp_init(2, (49, 4, 4), device=dev)
        run = rt.make_epoch(drv, steps, sample)
        p, s, _ = run(p, drv.init(p))                      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, _ = run(p, s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            p, s, _ = run(p, s)
            torch.cuda.synchronize()
        dev_evts = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in dev_evts)
        top = sorted(dev_evts, key=lambda e: -e.self_device_time_total)
        # no CUDA activity in the trace means the profiler saw no device
        # time: report it as not measured, not as an idle device
        device_ms = total_us / 1e3 / steps if total_us else None
        out[name] = dict(
            steps=steps, wall_ms_per_step=wall_ms,
            device_ms_per_step=device_ms,
            device_busy_share=device_ms / wall_ms if device_ms else None,
            device_ops_per_step=sum(e.count for e in dev_evts) / steps,
            top=[dict(name=e.key[:90], us_per_step=e.self_device_time_total
                      / steps, calls_per_step=e.count / steps,
                      us_per_call=e.self_device_time_total / max(1, e.count))
                 for e in top[:8]],
            kernel_us_per_launch={
                kname: e.self_device_time_total / e.count
                for e in dev_evts for kname, key in KERNEL_KEYS.items()
                if key in e.key and e.count},
            card=card)
        print(json.dumps({"profile": name, **out[name]}), flush=True)
    return out


def kernel_device_us(profiles):
    """Device µs per launch of each kernel on the main path (profiler)."""
    found = {}
    for prof in profiles.values():
        for name, us in prof["kernel_us_per_launch"].items():
            found.setdefault(name, us)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS,
                    help="training steps per run (multiple of 4, >= 32)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write every record to this JSON file")
    args = ap.parse_args(argv)
    if args.steps < CT_CHECK_STEPS or args.steps % 4:
        fail("--steps must be a multiple of 4 and at least 32")

    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch as rt
    from repro_torch import kernels
    from repro_torch.core import perturbations as pert
    from repro_torch.data import pipeline, tasks
    from repro_torch.kernels import _build, ops

    # -- phase 1: device and build ------------------------------------------
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s ({_build.BUILD_DIR})")
    for line in ptxas_summary(reports):
        print(line)

    # -- phase 2: kernels against plain, on the card ------------------------
    dev = torch.device("cuda")
    recs = compare_kernels(torch, ops, pert, dev)

    # -- phase 3: training on the card --------------------------------------
    results, totals = train(torch, rt, kernels, tasks, pipeline, card,
                            args.steps, dev)

    # -- phase 4: where the main path's step time goes ----------------------
    profiles = profile_main_path(torch, rt, tasks, pipeline, card, dev)
    device_us = kernel_device_us(profiles)

    entries = []
    for name, (source, replaces) in SOURCES.items():
        main_rec = recs[name][0]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=totals[name], max_abs_err=main_rec["max_abs_err"],
            ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
            bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"], shape=main_rec["shape"],
            max_err=main_rec["max_rel_err"], kernel_ms=main_rec["ms"],
            device_us_per_launch_main_path=device_us.get(name),
            card=card, shapes=recs[name]))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=card, build_s=build_s, kernels=entries, train=results,
            profile=profiles, ptxas=ptxas_summary(reports)), indent=1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
