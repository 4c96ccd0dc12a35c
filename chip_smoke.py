#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--steps N] [--out FILE]

Phases, each fatal on failure (nothing is caught):

1. Device and build: require a CUDA card, print ``nvidia-smi``'s name and
   power limit, compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, in parallel) and print ptxas's register,
   shared-memory and spill report (both perturbed-matmul kernels, the
   SIMT one and the tensor-core one, and the updates).  From ``cuobjdump
   -sass`` of the built update library (where the toolkit has it): each
   update kernel's instructions on the INT32 lanes (``INT_OPCODES``) an
   element a window step, counted in its J loop, for its bound.
2. Kernels against their plain PyTorch versions on the card, at the MLP
   path's shapes (x [B,49]·W [49,4], x [B,4]·W [4,4], B ∈ {1, 8}), at a
   ragged shape (5, 127, 257), at one sizing shape, x [256,5120]·W
   [5120,17408] f32, and at the transformer path's bf16 shapes, x
   [512,5120]·W for W ∈ {[5120,5120], [5120,1024], [5120,17408],
   [17408,5120], [5120,151936]}; the sum-then-subtract update
   ``mgd_update`` at (128, 256, J=4), (96, 80, 7) and [5120, 17408] J=4,
   f32 and bf16.  The matmuls take the kernel ``perturbed_matmul.route``
   picks: the tensor-core kernel for the bf16 LM shapes, the SIMT kernel
   for the rest; at the LM shapes the SIMT kernel is checked and timed as
   well, as the previous design.  Pass: matmul max error ≤ 1e-4 of
   max|y| in f32 and ≤ 2⁻⁶ (two bf16 ulps of max|y|) in bf16, and the
   unperturbed product x·W must miss that limit (so a kernel that drops θ̃
   cannot pass); at the LM shapes, bf16 in and f32 out, the tensor-core
   kernel (single and pair) within 1e-4 of max|y|, a limit that x @ θ̃
   with θ̃ = W + amp·S rounded to bf16 must miss (only the exact split form
   passes); both updates bitwise.  Each is timed with CUDA events after
   warm-up, beside its plain version, a library yardstick
   (``torch.matmul`` / ``Tensor.add_`` / ``torch.sub``) and the card's
   bound for the same work: for the updates the longest of their bytes
   at 3.35 TB/s and their sign hash's INT32-lane instructions (phase 1)
   at 132 SMs × 64 INT32 lanes × 1.98 GHz.
3. Training, the main path: NIST7x7 49-4-4 with the paper's Δθ = 1e-2,
   η = 0.1, seed 1, fused, through ``repro_torch.driver`` and
   ``make_epoch``: central τ_θ = 1, forward τ_θ = 1 and central replay
   τ_θ = 4.  The launch counters are zeroed before each run and must equal
   the per-step counts the path implies (all on the SIMT kernel: f32; one
   window-update launch an update for both weight matrices); the
   first 32 C̃ must agree with the same run through the plain versions on
   the card (atol 1e-5); costs must stay finite.  Steps/s and held-out accuracy on 512 samples are
   printed.
4. Where a main-path step's time goes: wall time per step, and device
   time per step and per kernel from ``torch.profiler`` (central and
   forward τ_θ = 1, 40 steps each).
5. The transformer slice: Qwen3-14B at full width (d_model 5120, GQA
   40/8 × 128, d_ff 17408, vocab 151936, bf16), 4 of its 40 layers, random
   weights from seed 0, ``launch/train.py``'s batch 8 × seq 64, Δθ = η =
   1e-2, fed by ``lm_sampler``: central τ_θ = 1, forward τ_θ = 1 and
   central replay τ_θ = 4, 20 steps each, through ``repro_torch.driver``
   and ``make_epoch``.  Each of the first 4 steps is probed again through
   the plain route from the same params, state and batch; its C̃ must
   agree within 2⁻¹¹ of that step's own cost, and two controls must miss
   that limit: C̃ = 0 and the kernel route probing another seed's signs.
   The remaining 16 steps are the main path: launch counters zeroed before
   them must equal the path's counts (29 matmul launches a step, every one
   on the tensor-core kernel, one window-update launch an update for all
   13 matrix leaves); costs stay finite.  Then the grouped window update
   of the 4-layer tree on its own: one launch, bitwise the plain version's
   leaf by leaf at J = 1, timed at J = 1 and 4 with the bytes/s it reaches;
   and the ``kernels.ops.mgd_update`` entry point updates every ndim ≥ 2
   leaf once (13 launches).  Printed: steps/s, peak device memory, and the
   device's busy share under ``torch.profiler`` for central.
6. Full depth: all 40 layers, central, 2 steps, kernel route only, with
   its launch counts (281 matmul launches a step, all tensor-core, one
   window update), peak device memory and seconds per step; then the
   grouped window update of all 40 layers timed on its own (J = 1).
7. An imperfect device at full width: phase 5's model (4 layers, bf16,
   central τ_θ = 1) through ``DriftingPlant(NoisyPlant(σ_C = 1e-4,
   σ_θ = 0.1), mode="walk", drift_rate=1e-3)``.  The first 3 steps are
   C̃-gated against the plain route as in phase 5 (the two probes read
   through the device's readout, with its cost noise); 2 more steps are
   the counted main path, whose launches must equal phase 5's counts
   (the device adds none).  Then the noisy write and the drift transition
   are timed alone, the share of bf16 elements a write moves is printed,
   one write's ~2.9 G draws must have |mean| and |std − 1| below 1e-3,
   and the first and last 2²⁰ draws of every leaf made on the card must
   equal the CPU's (bits bitwise, normals within ``rng.NORMAL_ULPS``).
   Printed: seconds a step, a noisy write and a drift; peak memory.
8. Resume at full width: the same model and device, kernel route, 3
   steps uninterrupted against 2 steps with a checkpoint (in a temporary
   directory, removed afterwards; fails if the disk lacks the space) and
   a fresh driver resuming to 3: params and state bitwise equal.
   Printed: checkpoint bytes, free disk, and the save and restore
   seconds that ``train_mgd`` reports (``TrainResult.checkpoint_s``).
9. The paper's model: NIST7x7 49-4-4 fused central τ_θ = 1 through
   ``noisy_mlp_plant(σ_C = 1e-4, σ_θ = 0.01, σ_a = 0.15)`` and
   ``quantized_mlp_plant(bits=8, adc_bits=8, adc_mode="stochastic")``,
   32 steps, each step's kernel route against the plain route from the
   same state (C̃ to 1e-5 and params to 1e-4, or one ADC / DAC LSB);
   a drifting noisy device with recalibration every 8 steps, kernel
   route against plain route over 32 steps; then 200 ticks of
   ``driver("analog", ...)`` on the card against the CPU (1e-5).
10. The paper's Table 2 CNNs at full width: the Fashion CNN (20,490
   params, 28×28×1) and the CIFAR CNN (26,154, 32×32×3), batch 64,
   Table 2's configs (Δθ = 1e-3, η = 1e-4 / 5e-5, seed 1, sampler seeds
   3 / 4, forward mode), MGD through ``driver`` and ``make_epoch`` on the
   unfused path (θ̃ materialized, as in the reference: no kernel
   launches), then ``train_backprop`` (η = 0.02, 400 steps).  Gates: the
   first 16 batches drawn on the card equal the CPU's (labels and shifts
   bitwise, noise within ``rng.NORMAL_ULPS``); the first 16 MGD and
   backprop steps on the card against the CPU from the same params and
   sampler indices, C̃, cost and params within ``CNN_LIMITS`` (printed as
   fractions of them), and a control that must miss: the MGD gate rerun
   with cuDNN's TF32 under ``conv2d``.  Printed: MGD and backprop
   steps/s, the sampler's ms a batch, held-out accuracy on 512 samples
   after 2000 MGD and 400 backprop steps, peak memory.

11. Probe parallelism and the chip farm (4 pods or chips).  11a: NIST7x7
   49-4-4 through ``driver("probe_parallel", ..., mesh=LocalMesh(pod=4))``,
   fused central, Δθ = 1e-2, η = 0.1, seed 1, batch 4 (one sample a pod),
   32 steps each against the plain route from the same state (phase 9's
   limits: C̃ 1e-5, params 1e-4) and 32 timed: 8 SIMT pair launches and
   one window-update launch with J = 4 over both weight matrices a step.
   11b: phase 5's Qwen3-14B at 4 layers, bf16, 4 pods of batch 8 × seq 64
   (global 32 × 64): 3 steps C̃-gated as in phase 5 (both controls must
   miss), then 8 counted steps, 4 × 29 = 116 tensor-core pair launches
   and one window-update launch (J = 4, 13 matrix leaves) a step; steps/s,
   peak memory and the busy share under ``torch.profiler``.  11c:
   ``simulated_chip_farm(4, (49, 4, 4))`` under ``driver(
   "probe_parallel_external")`` with params and update on the card, 50
   steps through the serial, thread, process and cluster-loopback
   backends and a pipelined thread farm, each trajectory (C̃ and params)
   bitwise the serial one's; the dyadic 4-chip ``LinearLaneChip`` farm
   (``shard_batch=True``) bitwise the 4-pod step over 5 steps; a farm
   with 10 % silent faults under retry + quarantine + MAD stays finite.
   Printed: steps/s per backend, the share of it spent copying to the
   host, ``pipeline_stats()``, ``n_used`` and the fault counts.

Phase 3 also prints the NIST7x7 sampler's ms a batch (batch 1): the
samplers draw the reference's batches with ``core.rng``'s threefry in
eager torch ops.  Every phase prints its seconds.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing neither, when
there is no CUDA card or the repo's sources are not beside this file.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12          # HBM3

PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # per input type
# INT32 instructions: 132 SMs × 64 INT32 lanes × 1.98 GHz boost clock
PEAK_INT32 = 132 * 64 * 1.98e9
# SASS opcodes (the part before the first dot) that take those lanes.  Not
# counted, so that the bound stays a least time: the IMAD family, which
# issues to the FMA pipe (on an H100 the window kernel at J = 4 ran faster
# than a bound that counted it); VIADD, whose pipe is not documented; the
# uniform datapath's U… opcodes, which run once a warp.
INT_OPCODES = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF",
               "SHL", "SHR", "PRMT", "LEA", "ISETP", "SEL", "IMNMX", "IABS",
               "BMSK", "BREV", "FLO", "POPC"}

MAIN_SHAPES = [(1, 49, 4), (1, 4, 4), (8, 49, 4), (8, 4, 4)]
RAGGED = (5, 127, 257)
SIZING = (256, 5120, 17408)
LM_TOKENS = 8 * 64          # launch/train.py's batch 8 × seq 64
LM_SHAPES = [(LM_TOKENS, 5120, 5120), (LM_TOKENS, 5120, 1024),
             (LM_TOKENS, 5120, 17408), (LM_TOKENS, 17408, 5120),
             (LM_TOKENS, 5120, 151936)]
LM_MAIN = (LM_TOKENS, 5120, 17408)          # gate/up: the kernels line
UPDATE_SHAPES = [(128, 256, 4), (96, 80, 7), (5120, 17408, 4)]
TRAIN_STEPS = 3000
CT_CHECK_STEPS = 32
CT_ATOL = 1e-5
# matmul max error / max|y|: f32 the reference tests' 1e-4; bf16 two ulps of
# max|y| (each output is summed in f32 and rounded to bf16 once, so the two
# versions land at most one ulp of an element, ≤ 2⁻⁷ of max|y|, apart)
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
LM_LAYERS = 4
LM_STEPS = 20
LM_CT_STEPS = 4
# C̃ gate: |C̃ − C̃_plain| ≤ 2⁻¹¹·|C| for each step's own cost C.  The two
# routes sum each logit in another f32 order before it is rounded to bf16,
# so a logit may land one bf16 ulp (2⁻⁸ of itself) apart; the cost averages
# 512 tokens, which shrinks such flips by about √512 ≈ 2⁴·⁵.
LM_CT_REL = 2.0 ** -11
LM_PER_LAYER = 7            # wq wk wv wo gate up down
LM_WINDOW_LEAVES = 13       # ndim ≥ 2 leaves of the stacked param tree
# substrings of each kernel's demangled name in a profiler trace (both
# routes of the perturbed matmuls)
KERNEL_KEYS = {"perturbed_matmul": ("perturbed_matmul_kernel<1",
                                    "perturbed_matmul_tc_kernel<1"),
               "perturbed_matmul_pair": ("perturbed_matmul_kernel<2",
                                         "perturbed_matmul_tc_kernel<2"),
               "mgd_update_window": ("mgd_update_window_kernel",),
               "mgd_update": ("mgd_update_kernel<",)}

# the kernel that runs each entry on the main path (the LM path is bf16:
# the perturbed matmuls take the tensor-core kernel there)
SOURCES = {
    "perturbed_matmul": ("src/repro_torch/kernels/csrc/perturbed_matmul_tc.cu",
                         "src/repro/kernels/perturbed_matmul.py:137"),
    "perturbed_matmul_pair": (
        "src/repro_torch/kernels/csrc/perturbed_matmul_tc.cu",
        "src/repro/kernels/perturbed_matmul.py:234"),
    "mgd_update_window": ("src/repro_torch/kernels/csrc/mgd_update.cu",
                          "src/repro/kernels/mgd_update.py:159"),
    "mgd_update": ("src/repro_torch/kernels/csrc/mgd_update.cu",
                   "src/repro/kernels/mgd_update.py:75"),
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


def parse_sass(text):
    """{mangled function: [(address, opcode, operands)]} from ``cuobjdump
    -sass`` (which gives branch targets as addresses)."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P(?:T|\d)\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def loop_int_ops(ins):
    """INT32-lane instructions (INT_OPCODES) in the innermost loop with the
    most LOP3s: the J loop of an update kernel's vector path, one window
    step of UNROLL vectors a thread.  None if the function has no loop."""
    loops = []
    for addr, op, operands in ins:
        m = re.search(r"0x([0-9a-f]+)", operands)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in loops)]
    best = None
    for a, b in inner:
        body = [op.split(".")[0] for addr, op, _ in ins if a <= addr <= b]
        key = (body.count("LOP3"), sum(o in INT_OPCODES for o in body))
        best = max(best or key, key)
    return None if best is None else best[1]


def update_int_ops(torch, _build, mgd_update, sass_out=None):
    """INT32-lane instructions per element and window step of each update
    kernel, from ``cuobjdump -sass`` of the built library:
    {(kernel, dtype): count}.  Empty, with a note, where the toolkit has
    no cuobjdump; a SASS without the kernels' J loops fails."""
    tool = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        print("phase 1: no cuobjdump beside nvcc: the update kernels' "
              "bounds count bytes only", flush=True)
        return {}
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.lib_path("mgd_update"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    if sass_out:
        sass_out.parent.mkdir(parents=True, exist_ok=True)
        sass_out.write_text(sass)
    funcs = parse_sass(sass)
    names = _demangle(list(funcs))
    found = {}
    for fname, ins in funcs.items():
        dem = names[fname]
        for kernel in ("mgd_update_window", "mgd_update"):
            for dname, targ in (("float32", "<float>"),
                                ("bfloat16", "<__nv_bfloat16>")):
                mangled = {"float32": "IfE",
                           "bfloat16": "I13__nv_bfloat16E"}[dname]
                if (f"{kernel}_kernel{targ}" in dem
                        or f"{kernel}_kernel{mangled}" in fname):
                    ops = loop_int_ops(ins)
                    if ops is None:
                        fail(f"no J loop in the SASS of {dem}")
                    per = ops / mgd_update.vector_elems(getattr(torch, dname))
                    found[(kernel, dname)] = per
                    print(f"phase 1: {dem}: {ops} INT32-lane instructions a "
                          f"window step for {ops / per:.0f} elements a "
                          f"thread, {per:.3g} an element", flush=True)
    if len(found) != 4:
        fail(f"SASS of the update kernels: found {sorted(found)}")
    return found


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


def bound(flops: float, nbytes: float, dtype: str = "float32",
          int_ops: float = 0.0):
    t_ops = max(flops / PEAK_OPS[dtype], int_ops / PEAK_INT32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max().item()
            / max(1.0, b.float().abs().max().item()))


def print_rec(name, r):
    window = f" J={r['window']}" if "window" in r else ""
    kernel = f" [{r['kernel']}]" if "kernel" in r else ""
    extra = ""
    if "simt_ms" in r:
        extra = (f"; in turns: cluster {r['cluster']} {r['cluster_ab_ms']:.4g} "
                 f"ms, cluster 1 {r['cluster1_ms']:.4g} ms; "
                 f"simt {r['simt_ms']:.4g} ms, split bound "
                 f"{r['split_bound_ms']:.4g}, f32-out rel err "
                 f"{r['f32_out_rel_err']:.3g} (θ̃-in-bf16 control "
                 f"{r['bf16_theta_control_rel_err']:.3g})")
    if r.get("int_ops_per_element_step"):
        extra = (f"; copy_ {r['copy_ms']:.4g} ms, bytes bound "
                 f"{r['bytes_bound_ms']:.4g} ms, "
                 f"{r['int_ops_per_element_step']:.3g} INT32-lane "
                 f"instructions an element a step")
    print(f"phase 2: {name}{kernel} {r['shape']} {r['dtype']}{window}: "
          f"{r['ms']:.4g} ms, plain {r['plain_ms']:.4g}, library "
          f"{r['library_ms']:.4g}, bound {r['bound_ms']:.4g} "
          f"({r['bound_by']}), max abs err {r['max_abs_err']:.3g}{extra}",
          flush=True)


def compare_kernels(torch, rt_ops, pert, dev, int_ops):
    """Phase 2: every kernel against its plain version on the card;
    ``int_ops`` holds the update kernels' INT32-lane instructions per
    element and window step (``update_int_ops``) for their bounds."""
    from repro_torch.kernels import perturbed_matmul as pm
    gen = torch.Generator(device=dev).manual_seed(0)
    lseed = pert.leaf_seed(1, 0, 3)
    cases = [(s, "float32") for s in MAIN_SHAPES] + [
        (RAGGED, "float32"), (RAGGED, "bfloat16"), (SIZING, "float32")] + [
        (s, "bfloat16") for s in LM_SHAPES]
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

        kernel = pm.route(x, w)
        y, r = single(), single("ref")
        err = rel_err(y, r)
        abs_1 = (y.float() - r.float()).abs().max().item()
        yp, ym = pair()
        rp, rm = pair("ref")
        err_p = max(rel_err(yp, rp), rel_err(ym, rm))
        abs_2 = max((yp.float() - rp.float()).abs().max().item(),
                    (ym.float() - rm.float()).abs().max().item())
        # control: what a kernel that drops θ̃ would return
        dropped = rel_err((x.float() @ w.float()).to(dt), r)
        torch.cuda.synchronize()
        for name, e in (("perturbed_matmul", err), ("perturbed_matmul_pair",
                                                     err_p)):
            if not e <= TOL[dname]:
                fail(f"{name} {shape} {dname}: rel err {e} > {TOL[dname]}")
        if not dropped > TOL[dname]:
            fail(f"perturbed_matmul {shape} {dname}: the unperturbed product "
                 f"is within the tolerance ({dropped} ≤ {TOL[dname]}), so "
                 f"the check cannot see θ̃")
        del y, r, yp, ym, rp, rm
        xs2 = torch.stack([x, xm])
        b1 = bound(2.0 * m * k * n, (m * k + k * n + m * n) * esz, dname)
        b2 = bound(4.0 * m * k * n, (2 * m * k + k * n + 2 * m * n) * esz,
                   dname)
        recs["perturbed_matmul"].append(dict(
            shape=shape, dtype=dname, kernel=kernel, max_abs_err=abs_1,
            max_rel_err=err, tol=TOL[dname], dropped_theta_rel_err=dropped,
            ms=time_ms(single), plain_ms=time_ms(lambda: single("ref")),
            library_ms=time_ms(lambda: torch.matmul(x, w)),
            bound_ms=b1[0], bound_by=b1[1]))
        recs["perturbed_matmul_pair"].append(dict(
            shape=shape, dtype=dname, kernel=kernel, max_abs_err=abs_2,
            max_rel_err=err_p, tol=TOL[dname], dropped_theta_rel_err=dropped,
            ms=time_ms(pair), plain_ms=time_ms(lambda: pair("ref")),
            library_ms=time_ms(lambda: torch.matmul(xs2, w)),
            bound_ms=b2[0], bound_by=b2[1]))
        del xs2
        if kernel == "tc":
            tc_extras(torch, rt_ops, pm, recs, x, xm, w, lseed, dname)
        for name in ("perturbed_matmul", "perturbed_matmul_pair"):
            print_rec(name, recs[name][-1])
        for j in ((1, 4) if dname == "float32" or m == LM_TOKENS else (4,)):
            if (k, n, dname, j) in windows_done:
                continue
            windows_done.add((k, n, dname, j))
            recs["mgd_update_window"].append(
                compare_window(torch, rt_ops, pert, gen, w, j, dname, esz,
                               int_ops.get(("mgd_update_window", dname))))
        del x, xm, w
        torch.cuda.empty_cache()
    for (k, n, j) in UPDATE_SHAPES:
        for dname in ("float32", "bfloat16"):
            recs["mgd_update"].append(
                compare_update(torch, rt_ops, pert, gen, dev, k, n, j, dname,
                               int_ops.get(("mgd_update", dname))))
    return recs


def tc_extras(torch, rt_ops, pm, recs, x, xm, w, lseed, dname):
    """At a shape the tensor-core kernel takes: the SIMT kernel checked and
    timed there too (the previous design), and the bf16-in, f32-out gate
    that only the exact split form passes, with its control."""
    from repro_torch.kernels import ref as rt_ref
    m, k = x.shape
    n = w.shape[1]
    f32 = torch.float32

    def simt_single():
        return pm.perturbed_matmul(x, w, lseed, amp=-1e-2, kernel="simt")

    def simt_pair():
        return pm.perturbed_matmul_pair(x, xm, w, lseed, dtheta=1e-2,
                                        kernel="simt")

    def single_at(cluster):
        return lambda: pm.perturbed_matmul(x, w, lseed, amp=-1e-2,
                                           cluster=cluster)

    def pair_at(cluster):
        return lambda: pm.perturbed_matmul_pair(x, xm, w, lseed, dtheta=1e-2,
                                                cluster=cluster)

    def f32_single(impl=None):
        return rt_ops.perturbed_matmul(x, w, lseed, dtheta=1e-2, sign=-1.0,
                                       impl=impl, out_dtype=f32)

    def f32_pair(impl=None):
        return rt_ops.perturbed_matmul_pair(x, xm, w, lseed, dtheta=1e-2,
                                            impl=impl, out_dtype=f32)

    r = rt_ops.perturbed_matmul(x, w, lseed, dtheta=1e-2, sign=-1.0,
                                impl="ref")
    simt_err = rel_err(simt_single(), r)
    del r
    rp, rm = rt_ops.perturbed_matmul_pair(x, xm, w, lseed, dtheta=1e-2,
                                          impl="ref")
    sp, sm = simt_pair()
    simt_err_p = max(rel_err(sp, rp), rel_err(sm, rm))
    del rp, rm, sp, sm
    y32, r32 = f32_single(), f32_single("ref")
    err32 = rel_err(y32, r32)
    yp32, ym32 = f32_pair()
    rp32, rm32 = f32_pair("ref")
    err32_p = max(rel_err(yp32, rp32), rel_err(ym32, rm32))
    signs = rt_ref.leaf_signs(lseed, (k, n), device=w.device)
    # control: the same products with θ̃ = W ± Δθ·S rounded to bf16 first
    ctl = min(rel_err(x.float() @ (w.float() - 1e-2 * signs)
                      .to(torch.bfloat16).float(), r32),
              rel_err(x.float() @ (w.float() + 1e-2 * signs)
                      .to(torch.bfloat16).float(), rp32))
    del y32, r32, yp32, ym32, rp32, rm32, signs
    torch.cuda.synchronize()
    shape = [m, k, n]
    for name, e in (("perturbed_matmul", simt_err),
                    ("perturbed_matmul_pair", simt_err_p)):
        if not e <= TOL[dname]:
            fail(f"{name} (simt) {shape} {dname}: rel err {e} > {TOL[dname]}")
    for name, e in (("perturbed_matmul", err32),
                    ("perturbed_matmul_pair", err32_p)):
        if not e <= TOL["float32"]:
            fail(f"{name} (tc) {shape} bf16 in, f32 out: rel err {e} > "
                 f"{TOL['float32']}")
    if not ctl > TOL["float32"]:
        fail(f"perturbed_matmul {shape}: θ̃ rounded to bf16 is within the "
             f"f32-out tolerance ({ctl} ≤ {TOL['float32']}), so the gate "
             f"cannot tell the split form from it")
    ops = {"perturbed_matmul": 4.0 * m * k * n,
           "perturbed_matmul_pair": 8.0 * m * k * n}
    for name, streams, e_simt, e32, fn, at in (
            ("perturbed_matmul", 1, simt_err, err32, simt_single, single_at),
            ("perturbed_matmul_pair", 2, simt_err_p, err32_p, simt_pair,
             pair_at)):
        # each sign is hashed once per cluster of row blocks
        blocks = -(-m // (64 if streams == 2 else 128))
        cluster = pm.tc_cluster(streams, m)
        # the chosen cluster size against clusters of one CTA, timed in
        # turns (A B B A) so that clock and power drift fall on both
        ab = [time_ms(at(c)) for c in (cluster, 1, 1, cluster)]
        recs[name][-1].update(
            simt_max_rel_err=e_simt, simt_ms=time_ms(fn),
            f32_out_rel_err=e32, f32_out_tol=TOL["float32"],
            bf16_theta_control_rel_err=ctl,
            split_bound_ms=ops[name] / PEAK_OPS["bfloat16"] * 1e3,
            cluster=cluster, sign_hashes_per_launch=-(-blocks // cluster),
            cluster_ab_ms=(ab[0] + ab[3]) / 2, cluster1_ms=(ab[1] + ab[2]) / 2,
            cluster1_sign_hashes_per_launch=blocks)


def update_bound(flops, nbytes, ints, j, numel):
    """The update kernels' bound: bytes, f32 adds, or the sign hash's
    INT32-lane instructions (``ints`` an element and step, None if unknown)
    at PEAK_INT32, whichever takes longest."""
    return bound(flops, nbytes, int_ops=(ints or 0.0) * j * numel)


def compare_window(torch, rt_ops, pert, gen, w, j, dname, esz, ints):
    k, n = w.shape
    seeds = rt_ops.seeds_tensor([pert.leaf_seed(1, t, 3) for t in range(j)],
                                w.device)
    coefs = torch.randn((j,), generator=gen, device=w.device)

    def window(impl=None):
        return rt_ops.mgd_update_window(w, seeds, coefs, alpha=-0.1,
                                        dtheta=1e-2, impl=impl)

    got, want = window(), window("ref")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"mgd_update_window {[k, n]} J={j} {dname}: not bitwise equal "
             f"to the plain version (max abs diff "
             f"{(got.float() - want.float()).abs().max().item()})")
    del got, want
    w2 = w.clone()
    d = torch.randn_like(w)
    o = torch.empty_like(w)
    b3 = update_bound(1.0 * j * k * n, 2 * k * n * esz + 8 * j, ints, j,
                      k * n)
    rec = dict(shape=[k, n], dtype=dname, window=j, max_abs_err=0.0,
               max_rel_err=0.0, int_ops_per_element_step=ints,
               bytes_bound_ms=(2 * k * n * esz + 8 * j) / PEAK_BYTES * 1e3,
               ms=time_ms(window),
               plain_ms=time_ms(lambda: window("ref")),
               library_ms=time_ms(lambda: w2.add_(d)),
               copy_ms=time_ms(lambda: o.copy_(w)),
               bound_ms=b3[0], bound_by=b3[1])
    print_rec("mgd_update_window", rec)
    return rec


def compare_update(torch, rt_ops, pert, gen, dev, k, n, j, dname, ints):
    """The sum-then-subtract update against its plain version; the
    yardstick is ``torch.sub`` of a materialized direction (the update's
    bytes plus the direction's read, with no sign generation)."""
    dt = getattr(torch, dname)
    esz = torch.tensor([], dtype=dt).element_size()
    w = torch.randn((k, n), generator=gen, device=dev).to(dt)
    seeds = rt_ops.seeds_tensor([pert.leaf_seed(7, t, 0) for t in range(j)],
                                dev)
    coefs = torch.randn((j,), generator=gen, device=dev)

    def update(impl=None):
        return rt_ops.mgd_update(w, seeds, coefs, eta=0.1, dtheta=0.01,
                                 impl=impl)

    got, want = update(), update("ref")
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    # same sum order and one rounded multiply-subtract in both versions
    if not torch.equal(got, want):
        fail(f"mgd_update {[k, n]} J={j} {dname}: not bitwise equal to the "
             f"plain version (max abs diff {max_abs})")
    del got, want
    direction = torch.randn((k, n), generator=gen, device=dev).to(dt)
    o = torch.empty_like(w)
    b4 = update_bound((j + 2.0) * k * n, 2 * k * n * esz + 8 * j, ints, j,
                      k * n)
    rec = dict(shape=[k, n], dtype=dname, window=j, max_abs_err=max_abs,
               int_ops_per_element_step=ints,
               bytes_bound_ms=(2 * k * n * esz + 8 * j) / PEAK_BYTES * 1e3,
               ms=time_ms(update), plain_ms=time_ms(lambda: update("ref")),
               library_ms=time_ms(lambda: torch.sub(w, direction, alpha=10.0)),
               copy_ms=time_ms(lambda: o.copy_(w)),
               bound_ms=b4[0], bound_by=b4[1])
    print_rec("mgd_update", rec)
    del w, direction, o
    torch.cuda.empty_cache()
    return rec


def train(torch, rt, kernels, tasks, pipeline, card, steps, dev):
    """Phase 3: the main path, three fused runs on the card."""
    from repro_torch.core import rng
    base = dict(dtheta=1e-2, eta=0.1, seed=1, fused=True)
    runs = {
        "central_tau1": (dict(mode="central"), dict(
            perturbed_matmul_pair=2 * steps, mgd_update_window=steps,
            perturbed_matmul=0, mgd_update=0)),
        "forward_tau1": (dict(mode="forward"), dict(
            perturbed_matmul=2 * steps, mgd_update_window=steps,
            perturbed_matmul_pair=0, mgd_update=0)),
        "central_replay4": (dict(mode="central", replay=True, tau_theta=4),
                            dict(perturbed_matmul_pair=2 * steps,
                                 mgd_update_window=steps // 4,
                                 perturbed_matmul=0, mgd_update=0)),
    }
    xe, ye = tasks.nist7x7_batch(rng.prng_key(99), 512, device=dev)

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
        by_route = check_routes(kernels, counts, "simt", name)
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
            sampler_ms_per_batch=time_ms(lambda: sample(7)),
            heldout_acc_512=acc, final_cost=aux["cost"][-1].item(),
            c_tilde_max_abs_err_vs_plain=ct_err, launches=counts,
            launches_by_kernel=by_route, card=card)
        print(json.dumps({"train": name, **results[name]}), flush=True)
    return results, totals


def check_routes(kernels, counts, route, what):
    """Every perturbed-matmul launch in ``counts`` went through ``route``
    (``"tc"`` or ``"simt"``); returns the counts by route."""
    by_route = kernels.route_launch_counts()
    for name in kernels.MATMUL_WRAPPERS:
        if by_route[name][route] != counts[name]:
            fail(f"{what}: {name} launches by kernel {by_route[name]}, "
                 f"expected all {counts[name]} on {route}")
    return by_route


def device_profile(torch, run, steps):
    """Device time per step and per kernel of ``run()`` (``steps`` steps)
    from ``torch.profiler``'s CUDA activity, and the device's busy share:
    that device time over the wall time of the same profiled steps.  No
    CUDA activity in the trace means the profiler saw no device time: that
    is reported as not measured (None), not as an idle device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev_evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev_evts)
    top = sorted(dev_evts, key=lambda e: -e.self_device_time_total)
    dev_ms = total_us / 1e3 / steps if total_us else None
    return dict(
        device_ms_per_step=dev_ms, profiled_wall_ms_per_step=wall_ms,
        device_busy_share=dev_ms / wall_ms if dev_ms else None,
        device_ops_per_step=sum(e.count for e in dev_evts) / steps,
        top=[dict(name=e.key[:90], us_per_step=e.self_device_time_total
                  / steps, calls_per_step=e.count / steps,
                  us_per_call=e.self_device_time_total / max(1, e.count))
             for e in top[:8]],
        kernel_us_per_launch=kernel_us(dev_evts))


def kernel_us(dev_evts):
    """Device µs per launch of each kernel in a profiler's events, over
    both routes of the perturbed matmuls."""
    sums = {}
    for e in dev_evts:
        for kname, keys in KERNEL_KEYS.items():
            if e.count and any(key in e.key for key in keys):
                us, n = sums.get(kname, (0.0, 0))
                sums[kname] = (us + e.self_device_time_total, n + e.count)
    return {kname: us / n for kname, (us, n) in sums.items()}


def profile_main_path(torch, rt, tasks, pipeline, card, dev, steps=40):
    """Phase 4: where a main-path step's time goes.  Wall time per step
    without the profiler, then device time per step, per kernel and as a
    share of the profiled steps' wall time from ``torch.profiler``."""

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
        prof = device_profile(torch, lambda: run(p, s), steps)
        out[name] = dict(steps=steps, wall_ms_per_step=wall_ms, **prof,
                         card=card)
        print(json.dumps({"profile": name, **out[name]}), flush=True)
    return out


def lm_expected(n_layers, mode, steps, tau_theta=1):
    """Launch counts the transformer path implies for ``steps`` steps."""
    per_step = LM_PER_LAYER * n_layers + 1        # + the untied head
    updates = steps // tau_theta
    return dict(
        perturbed_matmul=per_step * steps if mode == "forward" else 0,
        perturbed_matmul_pair=per_step * steps if mode == "central" else 0,
        mgd_update_window=updates, mgd_update=0)   # all leaves, one launch


def lm_driver(rt, cfg, dev, impl=None, seed=0, plant=None, **kw):
    return rt.driver(
        "discrete", rt.DriverConfig(dtheta=1e-2, eta=1e-2, seed=seed,
                                    fused=True, kernel_impl=impl, **kw),
        None if plant else (lambda p, b: rt.model_loss(p, cfg, b)),
        plant=plant, probe_fn=rt.make_transformer_probe_fn(cfg), device=dev)


def c_tilde_gate(torch, rt, cfg, dev, sample, p0, kw, steps=LM_CT_STEPS,
                 plant=None, read_plant=None, make=None):
    """The first ``steps`` steps of the kernel run, each probed again
    from the same params, state and batch through the plain route and, as
    a control, through the kernel route with another seed's signs.  Fails
    unless the kernel's C̃ is within LM_CT_REL of the step's cost of the
    plain route's, and both controls (C̃ = 0, the other seed) miss it.
    With a ``plant``, the run writes through it and the two probes read
    through ``read_plant``, its readout alone (the same cost noise; their
    writes are discarded).  ``make(impl, seed)`` builds the three drivers
    in place of ``lm_driver`` (phase 11's k-pod step).  Returns the params
    and state after those steps, and the record."""
    if make is None:
        def make(impl, seed):
            return lm_driver(rt, cfg, dev, impl, seed=seed,
                             plant=read_plant if (impl or seed) else plant,
                             **kw)
    drv, ref, other = make(None, 0), make("ref", 0), make(None, 1)
    params, state = p0, drv.init(p0)
    cts, plain_cts, other_cts, costs = [], [], [], []
    for n in range(steps):
        batch = sample(n)
        plain_cts.append(ref.step(params, state, batch)[2]["c_tilde"].item())
        other_cts.append(
            other.step(params, state, batch)[2]["c_tilde"].item())
        params, state, aux = drv.step(params, state, batch)
        cts.append(aux["c_tilde"].item())
        costs.append(aux["cost"].item())
    tols = [LM_CT_REL * abs(c) for c in costs]

    def worst(vals):           # largest gap to the plain route, in tols
        return max(abs(v - p) / t for v, p, t in zip(vals, plain_cts, tols))

    rec = dict(c_tilde_first=cts, c_tilde_first_plain=plain_cts,
               c_tilde_first_other_seed=other_cts, first_costs=costs,
               c_tilde_tol=tols,
               c_tilde_max_abs_err_vs_plain=max(
                   abs(a - b) for a, b in zip(cts, plain_cts)),
               c_tilde_err_in_tols=worst(cts),
               control_zero_err_in_tols=worst([0.0] * len(cts)),
               control_other_seed_err_in_tols=worst(other_cts))
    torch.cuda.synchronize()
    if not rec["c_tilde_err_in_tols"] <= 1.0:
        fail(f"transformer {kw}: first {steps} C̃ {cts} differ from "
             f"the plain route's {plain_cts} beyond {tols}")
    for control in ("control_zero", "control_other_seed"):
        if not rec[control + "_err_in_tols"] > 1.0:
            fail(f"transformer {kw}: the C̃ gate passes its {control} "
                 f"({rec})")
    return params, state, drv, rec


def transformer_slice(torch, rt, kernels, card, dev):
    """Phase 5: Qwen3-14B at full width, LM_LAYERS layers, three fused runs
    of LM_STEPS steps (the first LM_CT_STEPS gated against the plain
    route, the rest the counted main path); then the ``mgd_update`` entry
    point."""
    cfg = rt.get_config("qwen3-14b").replace(n_layers=LM_LAYERS)
    sample = rt.lm_sampler(8, 64, cfg.vocab, seed=0, device=dev)
    p0 = rt.model_init(cfg, 0, device=dev)
    runs = {
        "central_tau1": dict(mode="central"),
        "forward_tau1": dict(mode="forward"),
        "central_replay4": dict(mode="central", replay=True, tau_theta=4),
    }
    totals = {name: 0 for name in SOURCES}
    results = {}
    replay_ct = None
    main_steps = LM_STEPS - LM_CT_STEPS
    for name, kw in runs.items():
        params, state, drv, gate = c_tilde_gate(torch, rt, cfg, dev, sample,
                                                p0, kw)
        print(json.dumps({"transformer_c_tilde": name, **gate}), flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()    # the kernel route alone
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, aux = rt.make_epoch(drv, main_steps, sample)(
            params, state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expected = lm_expected(LM_LAYERS, kw["mode"], main_steps,
                               kw.get("tau_theta", 1))
        if counts != expected:
            fail(f"transformer {name}: launches {counts} != expected "
                 f"{expected}")
        by_route = check_routes(kernels, counts, "tc", f"transformer {name}")
        if not bool(torch.isfinite(aux["cost"]).all()):
            fail(f"transformer {name}: a cost went non-finite")
        for k, v in counts.items():
            totals[k] += v
        if name == "central_replay4":
            replay_ct = aux["c_tilde"][-4:]
        results[name] = dict(
            layers=LM_LAYERS, steps=LM_STEPS, main_path_steps=main_steps,
            steps_per_s=main_steps / dt, s_per_step=dt / main_steps,
            peak_mem_gb=peak / 1e9, last_cost=aux["cost"][-1].item(),
            **gate, launches=counts, launches_by_kernel=by_route, card=card)
        print(json.dumps({"transformer": name, **results[name]}), flush=True)
        if name == "central_tau1":
            prof = device_profile(
                torch, lambda: rt.make_epoch(drv, 2, sample)(params, state),
                2)
            results[name]["profile"] = prof
            print(json.dumps({"transformer_profile": name, **prof}),
                  flush=True)
        del params, state, aux, drv
        torch.cuda.empty_cache()
    results["group_update"] = group_update(torch, kernels, p0, card,
                                           f"{LM_LAYERS} layers")
    results["mgd_update_entry"], entry_counts = update_entry_point(
        torch, rt, kernels, p0, replay_ct, card)
    for k, v in entry_counts.items():
        totals[k] += v
    del p0
    torch.cuda.empty_cache()
    return results, totals


def update_entry_point(torch, rt, kernels, params, coefs, card):
    """``kernels.ops.mgd_update`` on every ndim ≥ 2 leaf of the model, with
    the replay run's last 4 C̃ as the window: one launch per leaf."""
    from repro_torch.core import perturbations as pert
    from repro_torch.core.utils import leaf_meta, tree_leaves
    from repro_torch.kernels import ops

    leaves = tree_leaves(params)
    kernels.reset_launch_counts()
    finite = True
    t0 = time.perf_counter()
    for (lid, _, _), leaf in zip(leaf_meta(params), leaves):
        if leaf.dim() < 2:
            continue
        seeds = [pert.leaf_seed(0, s, lid) for s in range(16, 20)]
        out = ops.mgd_update(leaf, seeds, coefs, eta=1e-2, dtheta=1e-2)
        finite = finite and bool(torch.isfinite(out).all())
        del out
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = dict(perturbed_matmul=0, perturbed_matmul_pair=0,
                    mgd_update_window=0, mgd_update=LM_WINDOW_LEAVES)
    if counts != expected:
        fail(f"mgd_update entry point: launches {counts} != {expected}")
    if not finite:
        fail("mgd_update entry point: a non-finite parameter")
    rec = dict(leaves=LM_WINDOW_LEAVES, window=4, wall_s=dt, launches=counts,
               card=card)
    print(json.dumps({"mgd_update_entry": rec}), flush=True)
    return rec, counts


def group_update(torch, kernels, params, card, what, windows=(1, 4),
                 check_plain=True):
    """The grouped window update of every ndim ≥ 2 leaf of ``params``, as
    the training step calls it: one launch for the whole tree, checked
    bitwise against the plain version leaf by leaf (J = 1, if
    ``check_plain``), and timed with CUDA events for each J in ``windows``:
    ms an update and the bytes/s of one read and one write of the leaves."""
    from repro_torch.core import perturbations as pert
    from repro_torch.core.utils import leaf_meta, tree_leaves
    from repro_torch.kernels import ops

    mats = [(lid, leaf) for (lid, _, _), leaf in
            zip(leaf_meta(params), tree_leaves(params)) if leaf.dim() >= 2]
    leaves = [leaf for _, leaf in mats]
    nbytes = 2 * sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    rec = dict(leaves=len(leaves), bytes_moved=nbytes, card=card)
    for j in windows:
        seeds = ops.seeds_tensor([[pert.leaf_seed(0, s, lid)
                                   for s in range(16, 16 + j)]
                                  for lid, _ in mats], leaves[0].device)
        coefs = torch.tensor([0.75, -0.5, 0.25, -1.0][:j],
                             device=leaves[0].device)

        def run(impl=None):
            return ops.mgd_update_window_group(leaves, seeds, coefs,
                                               alpha=-1e-2, dtheta=1e-2,
                                               impl=impl)

        kernels.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["mgd_update_window"]
        if launches != 1:
            fail(f"{what}: the grouped update launched {launches} times")
        if check_plain and j == 1:
            for i, (w, g) in enumerate(zip(leaves, got)):
                want = ops.mgd_update_window(w, seeds[i], coefs, alpha=-1e-2,
                                             dtheta=1e-2, impl="ref")
                if not torch.equal(g, want):
                    fail(f"{what}: grouped update of leaf {i} "
                         f"{list(w.shape)} not bitwise the plain version's")
                del want
            rec["bitwise_vs_plain_J1"] = True
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"{what}: the grouped update wrote a non-finite value")
        del got
        ms = time_ms(run)
        rec[f"J{j}"] = dict(ms=ms, bytes_per_s=nbytes / (ms * 1e-3),
                            share_of_peak_bytes=nbytes / PEAK_BYTES
                            / (ms * 1e-3))
    print(json.dumps({"group_update": what, **rec}), flush=True)
    torch.cuda.empty_cache()
    return rec


def full_depth(torch, rt, kernels, card, dev, steps=2):
    """Phase 6: all 40 layers, central, kernel route only."""
    cfg = rt.get_config("qwen3-14b")
    sample = rt.lm_sampler(8, 64, cfg.vocab, seed=0, device=dev)
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rt.model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = torch.cuda.memory_allocated() / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    drv = lm_driver(rt, cfg, dev, mode="central")
    state = drv.init(params)
    kernels.reset_launch_counts()
    step_s, costs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, aux = rt.make_epoch(drv, 1, sample)(params, state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        costs.append(aux["cost"][0].item())
    counts = kernels.launch_counts()
    expected = lm_expected(cfg.n_layers, "central", steps)
    if counts != expected:
        fail(f"full depth: launches {counts} != expected {expected}")
    by_route = check_routes(kernels, counts, "tc", "full depth")
    if not all(math.isfinite(c) for c in costs):
        fail("full depth: a cost went non-finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window update of the whole model, one launch (not bitwise-checked
    # here: the plain version's f32 temporaries would not fit beside it)
    window = group_update(torch, kernels, params, card,
                          f"{cfg.n_layers} layers", windows=(1,),
                          check_plain=False)
    rec = dict(layers=cfg.n_layers, steps=steps, init_s=init_s,
               s_per_step=step_s, costs=costs, start_mem_gb=start_gb,
               params_gb=params_gb,
               init_peak_mem_gb=init_peak_gb,
               peak_mem_gb=peak_gb, window_update=window,
               launches=counts, launches_by_kernel=by_route, card=card)
    print(json.dumps({"full_depth": rec}), flush=True)
    del params, state, aux, drv
    torch.cuda.empty_cache()
    return rec, counts


# -- phases 7-9: imperfect devices ------------------------------------------

# phase 7's device: σ_C = 1e-4, σ_θ = 0.1 (std σ_θ·Δθ = 1e-3, about eight
# bf16 ulps of a weight of 0.02, so the noise lands), a random walk of
# 1e-3 a write
LM_SIGMA_C, LM_SIGMA_THETA, LM_DRIFT = 1e-4, 0.1, 1e-3
PLANT_CT_STEPS = 3
PLANT_MAIN_STEPS = 2
CHECK_ELEMS = 1 << 20       # card-vs-CPU draws: first and last of each leaf
DRAW_STAT_TOL = 1e-3        # |mean|, |std − 1| of one write's draws
MLP_SIZES = (49, 4, 4)
MLP_STEPS = 32
MLP_RECAL = 8
ANALOG_TICKS = 200
# Algorithm 2 on the card against the CPU: torch's CUDA and CPU sigmoid,
# matmul and sin round apart in the last ulps
ANALOG_ATOL = 1e-5


def lm_plant(rt, cfg):
    """Phase 7's device: a drifting device with noisy writes and reads."""
    from repro_torch.hardware import DriftingPlant, NoisyPlant

    inner = NoisyPlant(lambda p, b: rt.model_loss(p, cfg, b),
                       cost_noise=LM_SIGMA_C, write_noise=LM_SIGMA_THETA,
                       dtheta=1e-2, seed=0)
    return DriftingPlant(inner, mode="walk", drift_rate=LM_DRIFT)


def max_ulps(torch, a, b):
    return (a.view(torch.int32).long() - b.view(torch.int32).long()
            ).abs().max().item()


def draw_checks(torch, rt_rng, plant, params, step, dev):
    """One write's draws over every leaf: their mean and std over all
    elements (f64 sums), and the first and last CHECK_ELEMS of each leaf
    made on the card against the same made on the CPU (bits bitwise,
    normals within ``rng.NORMAL_ULPS``)."""
    from repro_torch.core.utils import tree_leaves

    s1 = torch.zeros((), dtype=torch.float64, device=dev)
    s2 = torch.zeros((), dtype=torch.float64, device=dev)
    n_all, worst_ulps, bit_slices = 0, 0, 0
    t0 = time.perf_counter()
    for i, leaf in enumerate(tree_leaves(params), start=1):
        key = plant.write_key(i, step)
        n = leaf.numel()
        for _, _, xi in rt_rng.normal_chunks(key, n, dev):
            s1 += torch.sum(xi, dtype=torch.float64)
            s2 += torch.sum(xi.double().square())
        n_all += n
    mean = (s1 / n_all).item()
    std = math.sqrt((s2 / n_all).item() - mean * mean)
    stats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, leaf in enumerate(tree_leaves(params), start=1):
        key = plant.write_key(i, step)
        n = leaf.numel()
        for a, b in {(0, min(n, CHECK_ELEMS)), (max(0, n - CHECK_ELEMS), n)}:
            if not torch.equal(rt_rng.bits_slice(key, a, b, dev).cpu(),
                               rt_rng.bits_slice(key, a, b, "cpu")):
                fail(f"threefry bits of leaf {i} [{a}, {b}) differ between "
                     f"the card and the CPU")
            worst_ulps = max(worst_ulps, max_ulps(
                torch, rt_rng.normal_slice(key, a, b, dev).cpu(),
                rt_rng.normal_slice(key, a, b, "cpu")))
            bit_slices += 1
    if worst_ulps > rt_rng.NORMAL_ULPS:
        fail(f"normals differ between the card and the CPU by {worst_ulps} "
             f"ulps > {rt_rng.NORMAL_ULPS}")
    if not (abs(mean) < DRAW_STAT_TOL and abs(std - 1) < DRAW_STAT_TOL):
        fail(f"one write's {n_all} draws: mean {mean}, std {std}")
    return dict(draws=n_all, draw_mean=mean, draw_std=std,
                draw_stats_s=stats_s, card_vs_cpu_slices=bit_slices,
                card_vs_cpu_bits_equal=True,
                card_vs_cpu_normal_max_ulps=worst_ulps,
                card_vs_cpu_s=time.perf_counter() - t0)


def imperfect_device(torch, rt, kernels, card, dev):
    """Phase 7: Qwen3-14B at full width, LM_LAYERS layers, bf16, central
    τ_θ = 1 through a drifting device with noisy writes and reads: the
    first PLANT_CT_STEPS steps C̃-gated against the plain route, then
    PLANT_MAIN_STEPS counted steps; the noisy write and the drift
    transition timed alone; one write's draws checked."""
    from repro_torch.core import rng as rt_rng
    from repro_torch.core.utils import tree_leaves
    from repro_torch.hardware import NoisyPlant

    cfg = rt.get_config("qwen3-14b").replace(n_layers=LM_LAYERS)
    sample = rt.lm_sampler(8, 64, cfg.vocab, seed=0, device=dev)
    p0 = rt.model_init(cfg, 0, device=dev)
    plant = lm_plant(rt, cfg)
    reads = NoisyPlant(lambda p, b: rt.model_loss(p, cfg, b),
                       cost_noise=LM_SIGMA_C, seed=plant.inner.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state, drv, gate = c_tilde_gate(
        torch, rt, cfg, dev, sample, p0, dict(mode="central"),
        steps=PLANT_CT_STEPS, plant=plant, read_plant=reads)
    del p0
    print(json.dumps({"imperfect_c_tilde": "central_tau1", **gate}),
          flush=True)
    kernels.reset_launch_counts()
    step_s, costs = [], []
    for _ in range(PLANT_MAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, aux = rt.make_epoch(drv, 1, sample)(params, state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        costs.append(aux["cost"][0].item())
    counts = kernels.launch_counts()
    expected = lm_expected(LM_LAYERS, "central", PLANT_MAIN_STEPS)
    if counts != expected:
        fail(f"imperfect device: launches {counts} != expected {expected} "
             f"(the plant must add no launch)")
    by_route = check_routes(kernels, counts, "tc", "imperfect device")
    if not all(math.isfinite(c) for c in costs):
        fail("imperfect device: a cost went non-finite")
    # the two parts of a write, alone, at the current step
    n = state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = plant.inner.write_params(params, step=n)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    moved = sum(int((a != b).sum()) for a, b in
                zip(tree_leaves(written), tree_leaves(params)))
    numel = sum(x.numel() for x in tree_leaves(params))
    t0 = time.perf_counter()
    drifted = plant.drift(written, n)
    torch.cuda.synchronize()
    drift_s = time.perf_counter() - t0
    del written, drifted
    draws = draw_checks(torch, rt_rng, plant.inner, params, n, dev)
    rec = dict(layers=LM_LAYERS, sigma_c=LM_SIGMA_C,
               sigma_theta=LM_SIGMA_THETA, drift_rate=LM_DRIFT, **gate,
               main_path_steps=PLANT_MAIN_STEPS, s_per_step=step_s,
               costs=costs, noisy_write_s=write_s, drift_s=drift_s,
               elements=numel, landed_moved_share=moved / numel, **draws,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, launches_by_kernel=by_route, card=card)
    print(json.dumps({"imperfect_device": rec}), flush=True)
    del params, state, aux, drv
    torch.cuda.empty_cache()
    return rec, counts


def resume_full_width(torch, rt, card, dev, steps=3, at=2):
    """Phase 8: phase 7's model and device, kernel route: an
    uninterrupted ``steps``-step run against an ``at``-step run that
    checkpoints, then a fresh driver resuming it to ``steps``.  Params
    and state must be bitwise equal.  The checkpoint lives in a temporary
    directory, removed afterwards."""
    import tempfile
    from repro_torch.core.utils import tree_leaves

    cfg = rt.get_config("qwen3-14b").replace(n_layers=LM_LAYERS)
    sample = rt.lm_sampler(8, 64, cfg.vocab, seed=0, device=dev)
    p0 = rt.model_init(cfg, 0, device=dev)

    def run(n, **loop):
        return rt.train_mgd(
            None, p0, rt.DriverConfig(dtheta=1e-2, eta=1e-2, seed=0,
                                      fused=True, mode="central"),
            sample, n, loop=rt.TrainLoopConfig(
                chunk=1, log=None, plant=lm_plant(rt, cfg),
                probe_fn=rt.make_transformer_probe_fn(cfg), **loop),
            device=dev)

    t0 = time.perf_counter()
    cont = run(steps)
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    param_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(p0))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        free = shutil.disk_usage(d).free
        if free < 1.2 * param_bytes:
            fail(f"resume: {free / 1e9:.2f} GB free under {d}, the "
                 f"checkpoint needs {param_bytes / 1e9:.2f} GB")
        first = run(at, checkpoint_dir=d, checkpoint_every=at)
        save_s = first.checkpoint_s["save"]
        del first
        torch.cuda.empty_cache()
        res = run(steps, checkpoint_dir=d)
        ckpt_bytes = sum(f.stat().st_size
                         for f in pathlib.Path(d).rglob("*") if f.is_file())
    if res.steps_done != steps or res.state.step != steps:
        fail(f"resume: resumed run ended at {res.state.step}")
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(cont.params), tree_leaves(res.params)))
    same_state = all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(tree_leaves(cont.state), tree_leaves(res.state)))
    if not (same and same_state):
        fail(f"resume: the resumed run is not bitwise the uninterrupted one "
             f"(params {same}, state {same_state})")
    rec = dict(layers=LM_LAYERS, steps=steps, checkpoint_at=at,
               uninterrupted_s=cont_s, save_s=save_s,
               restore_s=res.checkpoint_s["restore"],
               checkpoint_bytes=ckpt_bytes,
               param_bytes=param_bytes, disk_free_gb=free / 1e9,
               bitwise_params=same, bitwise_state=same_state, card=card)
    print(json.dumps({"resume": rec}), flush=True)
    del cont, res, p0
    torch.cuda.empty_cache()
    return rec


def same_state_steps(torch, drv, ref, params, state, sample, steps,
                     ct_tol, p_tol, what="paper model"):
    """``steps`` steps of ``drv``, each repeated by ``ref`` from the same
    params, state and batch: returns the largest C̃ and parameter gaps,
    the number of steps where anything differed, and the final params."""
    from repro_torch.core.utils import tree_leaves

    ct_gap = p_gap = 0.0
    differ = 0
    for _ in range(steps):
        batch = sample(state.step)
        p_ref, _, a_ref = ref.step(params, state, batch)
        params, state, aux = drv.step(params, state, batch)
        ct = (aux["c_tilde"] - a_ref["c_tilde"]).abs().item()
        gaps = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(tree_leaves(params), tree_leaves(p_ref))]
        differ += int(ct > 0 or max(gaps) > 0)
        ct_gap, p_gap = max(ct_gap, ct), max(p_gap, *gaps)
        if not bool(torch.isfinite(aux["cost"])):
            fail(f"{what}: a cost went non-finite")
    if not (ct_gap <= ct_tol and p_gap <= p_tol):
        fail(f"{what}: kernel route against plain from the same state: "
             f"C̃ gap {ct_gap} (limit {ct_tol}), params {p_gap} "
             f"(limit {p_tol})")
    return dict(c_tilde_max_gap=ct_gap, param_max_gap=p_gap,
                c_tilde_limit=ct_tol, param_limit=p_tol,
                steps_differing=differ), params


def paper_model(torch, rt, kernels, tasks, pipeline, card, dev):
    """Phase 9: NIST7x7 49-4-4 through the paper's imperfect devices,
    fused central τ_θ = 1, kernel route against the plain route; then
    Algorithm 2 on the card against the CPU."""
    from repro_torch.core.utils import tree_leaves
    from repro_torch.hardware import (DriftingPlant, noisy_mlp_plant,
                                      quantized_mlp_plant)

    base = dict(dtheta=1e-2, eta=0.1, seed=1, fused=True, mode="central")
    sample = pipeline.generator_sampler(tasks.nist7x7_batch, 1, seed=7,
                                        device=dev)
    p0 = rt.mlp_init(2, MLP_SIZES, device=dev)

    def noisy():      # benchmarks/hardware_plants.py:133-135's devices
        return noisy_mlp_plant(MLP_SIZES, sigma_c=1e-4, sigma_theta=0.01,
                               sigma_a=0.15, dtheta=1e-2, device=dev)

    def quantized():
        return quantized_mlp_plant(MLP_SIZES, bits=8, adc_bits=8,
                                   adc_mode="stochastic", device=dev)

    def drv_for(plant, impl):
        return rt.driver("discrete", rt.DriverConfig(kernel_impl=impl,
                                                     **base),
                         None, plant=plant, device=dev)

    q = quantized()
    # the f32 C̃ gate of phase 3, and what one update makes of it
    ct_f32 = CT_ATOL
    p_f32 = base["eta"] * CT_ATOL / base["dtheta"]
    runs = {"noisy": (noisy, ct_f32, p_f32),
            # a one-ulp cost gap can flip one ADC code (C̃ moves by half
            # an ADC LSB) or one DAC rounding (a param moves one LSB)
            "quantized_adc8": (quantized, q.adc_lsb * 1.0001,
                               q.lsb * 1.0001)}
    out, totals = {}, {name: 0 for name in SOURCES}
    for name, (make, ct_tol, p_tol) in runs.items():
        drv, ref = drv_for(make(), None), drv_for(make(), "ref")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rec, params = same_state_steps(torch, drv, ref, p0, drv.init(p0),
                                       sample, MLP_STEPS, ct_tol, p_tol)
        torch.cuda.synchronize()
        rec["s"] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        expected = dict(perturbed_matmul=0,
                        perturbed_matmul_pair=2 * MLP_STEPS,
                        mgd_update_window=MLP_STEPS, mgd_update=0)
        if counts != expected:
            fail(f"paper model {name}: launches {counts} != {expected}")
        check_routes(kernels, counts, "simt", f"paper model {name}")
        for k, v in counts.items():
            totals[k] += v
        out[name] = dict(steps=MLP_STEPS, **rec, launches=counts, card=card)
        print(json.dumps({"paper_model": name, **out[name]}), flush=True)

    # a drifting device re-trimmed every MLP_RECAL steps, both routes
    def drift_run(impl):
        plant = DriftingPlant(noisy(), mode="walk", drift_rate=1e-3, seed=3)
        return rt.train_mgd(None, p0, rt.DriverConfig(kernel_impl=impl,
                                                      **base),
                            sample, MLP_STEPS, loop=rt.TrainLoopConfig(
                                chunk=1, log=None, plant=plant,
                                recal_every=MLP_RECAL), device=dev)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = drift_run(None)
    torch.cuda.synchronize()
    drift_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = dict(perturbed_matmul=0, perturbed_matmul_pair=2 * MLP_STEPS,
                    mgd_update_window=MLP_STEPS, mgd_update=0)
    if counts != expected:
        fail(f"paper model drift+recal: launches {counts} != {expected}")
    for k, v in counts.items():
        totals[k] += v
    plain = drift_run("ref")
    ct_gap = max(abs(a["c_tilde"] - b["c_tilde"])
                 for (_, a), (_, b) in zip(res.history, plain.history))
    p_gap = max((a - b).abs().max().item() for a, b in
                zip(tree_leaves(res.params), tree_leaves(plain.params)))
    if not (ct_gap <= ct_f32 and p_gap <= p_f32):
        fail(f"paper model drift+recal: kernel against plain route: C̃ gap "
             f"{ct_gap} > {ct_f32} or params {p_gap} > {p_f32}")
    out["drifting_recal8"] = dict(
        steps=MLP_STEPS, recal_every=MLP_RECAL, s=drift_s,
        c_tilde_max_gap=ct_gap, param_max_gap=p_gap, launches=counts,
        card=card)
    print(json.dumps({"paper_model": "drifting_recal8",
                      **out["drifting_recal8"]}), flush=True)

    # Algorithm 2, 200 ticks, card against CPU (same batches, made on CPU)
    cpu_sample = pipeline.generator_sampler(tasks.nist7x7_batch, 1, seed=7,
                                            device="cpu")
    runs = []
    for where in (dev, torch.device("cpu")):
        drv = rt.driver("analog", rt.DriverConfig(cost_noise=1e-4),
                        lambda p, b: rt.mse(rt.mlp_apply(p, b["x"]),
                                            b["y"]), device=where)
        p = [{k: v.to(where) for k, v in layer.items()} for layer in p0]
        t0 = time.perf_counter()
        p, s, aux = rt.make_epoch(drv, ANALOG_TICKS, lambda i: {
            k: v.to(where) for k, v in cpu_sample(i).items()})(p, drv.init(p))
        runs.append((p, aux, time.perf_counter() - t0))
    (pc, ac, tc), (ph, ah, th) = runs
    gaps = {k: (ac[k].cpu() - ah[k]).abs().max().item()
            for k in ("cost", "c_tilde")}
    gaps["params"] = max((a.cpu() - b).abs().max().item()
                         for a, b in zip(tree_leaves(pc), tree_leaves(ph)))
    if not (all(v <= ANALOG_ATOL for v in gaps.values())
            and bool(torch.isfinite(ac["cost"]).all())):
        fail(f"analog: card against CPU over {ANALOG_TICKS} ticks: {gaps} "
             f"(limit {ANALOG_ATOL})")
    out["analog"] = dict(ticks=ANALOG_TICKS, max_gap=gaps,
                         limit=ANALOG_ATOL, card_s=tc, cpu_s=th,
                         last_cost=ac["cost"][-1].item(), card=card)
    print(json.dumps({"paper_model": "analog", **out["analog"]}), flush=True)
    return out, totals



# -- phase 10: the paper's CNNs (Table 2) -----------------------------------

CNN_BATCH = 64
CNN_GATE_STEPS = 16
CNN_MGD_STEPS = 2000        # of Table 2's 8000 (Fashion) / 6000 (CIFAR)
CNN_EPOCH = 250
CNN_BP_STEPS = 400          # Table 2's backprop budget, η = 0.02
CNN_BP_ETA = 0.02
CNN_NOISE = 0.6             # tasks.procedural_image_batch's pixel noise
# card against CPU over the first CNN_GATE_STEPS steps from the same
# params and sampler indices (each device draws its own batches)
CNN_LIMITS = dict(c_tilde=1e-6, cost=1e-6, params=1e-6, bp_cost=1e-6,
                  bp_params=1e-6)
# Table 2's configs (benchmarks/table2_datasets.py): model, batch_fn, η,
# sampler seed, held-out key; Δθ = 1e-3, seed 1, forward mode
CNN_CONFIGS = {
    "fashion": ("fashion_cnn", "fashion_batch", 1e-4, 3, 98),
    "cifar": ("cifar_cnn", "cifar_batch", 5e-5, 4, 97),
}


def ulp(torch, x):
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def cnn_batches_card_vs_cpu(torch, rt_rng, batch_fn, seed, dev):
    """Indices 0..CNN_GATE_STEPS-1 drawn on the card and on the CPU:
    labels and shifts bitwise, the noise draws within NORMAL_ULPS, the
    images within that many ulps of the noise term plus one of the
    image."""
    worst_ulps = worst_img = 0.0
    for i in range(CNN_GATE_STEPS):
        key = rt_rng.fold_in(rt_rng.prng_key(seed), i)
        xc, yc = batch_fn(key, CNN_BATCH, device="cpu")
        xd, yd = batch_fn(key, CNN_BATCH, device=dev)
        _, k_shift, k_noise = rt_rng.split(key, 3)
        sh = [rt_rng.randint(k_shift, (CNN_BATCH, 2), -2, 3, device=d).cpu()
              for d in (dev, "cpu")]
        if not (torch.equal(yd.cpu(), yc) and torch.equal(*sh)):
            fail(f"CNN batch {i}: labels or shifts differ card vs CPU")
        nd = rt_rng.normal(k_noise, tuple(xc.shape), device=dev).cpu()
        nc = rt_rng.normal(k_noise, tuple(xc.shape), device="cpu")
        ulps = max_ulps(torch, nd, nc)
        tol = ((rt_rng.NORMAL_ULPS + 1) * ulp(torch, CNN_NOISE * nc)
               + ulp(torch, xc))
        gap = (xd.cpu() - xc).abs()
        if ulps > rt_rng.NORMAL_ULPS or bool((gap > tol).any()):
            fail(f"CNN batch {i}: noise {ulps} ulps apart card vs CPU, "
                 f"images {gap.max().item()} apart")
        worst_ulps = max(worst_ulps, ulps)
        worst_img = max(worst_img, gap.max().item())
    return dict(indices=CNN_GATE_STEPS, labels_shifts_bitwise=True,
                noise_max_ulps=worst_ulps, image_max_abs_gap=worst_img)


def tree_gap(tree_leaves, a, b):
    return max((x.cpu() - y.cpu()).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def cnn_gate(torch, rt, pipeline, batch_fn, init, loss, eta, seed, dev):
    """The first CNN_GATE_STEPS MGD and backprop steps on the card and on
    the CPU from the same params and sampler indices; gaps in limits
    (``CNN_LIMITS``), and the same MGD gate with cuDNN's TF32 switched on
    under ``conv2d`` (a control: what TF32 would do to the gate)."""
    import torch.nn.functional as F
    from repro_torch.core.utils import tree_leaves, tree_map

    where = {"cuda": dev, "cpu": torch.device("cpu")}
    sample = {k: pipeline.generator_sampler(batch_fn, CNN_BATCH, seed=seed,
                                            device=d)
              for k, d in where.items()}

    def mgd(k):
        """CNN_GATE_STEPS MGD steps on ``where[k]``: (params, C̃, cost)."""
        drv = rt.driver("discrete", rt.DriverConfig(dtheta=1e-3, eta=eta,
                                                    seed=1), loss,
                        device=where[k])
        p = tree_map(lambda t: t.to(where[k]), init)
        p, _, aux = rt.make_epoch(drv, CNN_GATE_STEPS, sample[k])(
            p, drv.init(p))
        return p, aux["c_tilde"].cpu(), aux["cost"].cpu()

    def bp(k):
        return rt.train_backprop(
            loss, tree_map(lambda t: t.to(where[k]), init), sample[k],
            CNN_GATE_STEPS, eta=CNN_BP_ETA, chunk=CNN_GATE_STEPS, log=None)

    def gaps_to(cpu, card):
        return dict(c_tilde=(card[1] - cpu[1]).abs().max().item(),
                    cost=(card[2] - cpu[2]).abs().max().item(),
                    params=tree_gap(tree_leaves, card[0], cpu[0]))

    cpu_run = mgd("cpu")
    gaps = gaps_to(cpu_run, mgd("cuda"))
    bp_cpu, bp_card = bp("cpu"), bp("cuda")
    gaps["bp_cost"] = abs(bp_card.history[0][1]["cost"]
                          - bp_cpu.history[0][1]["cost"])
    gaps["bp_params"] = tree_gap(tree_leaves, bp_card.params, bp_cpu.params)

    conv = F.conv2d

    def tf32_conv(*a, **kw):
        torch.backends.cudnn.allow_tf32 = True
        try:
            return conv(*a, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = False

    F.conv2d = tf32_conv
    try:
        tf32 = gaps_to(cpu_run, mgd("cuda"))
    finally:
        F.conv2d = conv
    return dict(steps=CNN_GATE_STEPS, gaps=gaps, limits=CNN_LIMITS,
                gaps_in_limits={k: v / CNN_LIMITS[k]
                                for k, v in gaps.items()},
                c_tilde_first=cpu_run[1].tolist(), tf32_control_gaps=tf32,
                tf32_control_in_limits={k: v / CNN_LIMITS[k]
                                        for k, v in tf32.items()})


def paper_cnns(torch, rt, kernels, tasks, pipeline, card, dev):
    """Phase 10: Table 2's Fashion and CIFAR CNNs at full width on the
    card, MGD (unfused, θ̃ materialized, as in the reference) and the
    backprop baseline."""
    from repro_torch.core import rng as rt_rng
    from repro_torch.core.utils import tree_size

    out = {}
    for name, (model, batch_name, eta, seed, heldout) in CNN_CONFIGS.items():
        init_fn = getattr(rt, model + "_init")
        apply_fn = getattr(rt, model + "_apply")
        batch_fn = getattr(tasks, batch_name)

        def loss(p, b, apply_fn=apply_fn):
            return rt.mse(apply_fn(p, b["x"]), b["y"])

        rec = dict(params=tree_size(init_fn(0, device="cpu")),
                   batch=CNN_BATCH, eta=eta, dtheta=1e-3, sampler_seed=seed)
        rec["batches"] = cnn_batches_card_vs_cpu(torch, rt_rng, batch_fn,
                                                 seed, dev)
        gate = cnn_gate(torch, rt, pipeline, batch_fn,
                        init_fn(0, device="cpu"), loss, eta, seed, dev)
        rec["gate"] = gate
        print(json.dumps({"paper_cnn_gate": name, **gate}), flush=True)
        bad = {k: v for k, v in gate["gaps_in_limits"].items() if not v <= 1}
        if bad:
            fail(f"paper CNN {name}: card against CPU over the first "
                 f"{CNN_GATE_STEPS} steps beyond the limits: {bad}")
        if not gate["tf32_control_in_limits"]["c_tilde"] > 1:
            fail(f"paper CNN {name}: the C̃ gate passes its TF32 control "
                 f"({gate['tf32_control_gaps']}), too loose to guard the "
                 f"conv's precision")

        sample = pipeline.generator_sampler(batch_fn, CNN_BATCH, seed=seed,
                                            device=dev)
        xe, ye = batch_fn(rt_rng.prng_key(heldout), 512, device=dev)
        rec["sampler_ms_per_batch"] = time_ms(lambda: sample(5))
        drv = rt.driver("discrete", rt.DriverConfig(dtheta=1e-3, eta=eta,
                                                    seed=1), loss,
                        device=dev)
        params = init_fn(0, device=dev)
        state = drv.init(params)
        epoch = rt.make_epoch(drv, CNN_EPOCH, sample)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        finite = True
        for _ in range(CNN_MGD_STEPS // CNN_EPOCH):
            params, state, aux = epoch(params, state)
            finite = finite and bool(torch.isfinite(aux["cost"]).all())
        torch.cuda.synchronize()
        mgd_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if any(counts.values()):
            fail(f"paper CNN {name}: the unfused path launched {counts}")
        if not finite:
            fail(f"paper CNN {name}: an MGD cost went non-finite")
        out_mgd = apply_fn(params, xe)
        if tuple(out_mgd.shape) != (512, 10) or \
                not bool(torch.isfinite(out_mgd).all()):
            fail(f"paper CNN {name}: held-out outputs not finite")
        rec.update(
            mgd_steps=CNN_MGD_STEPS, mgd_steps_per_s=CNN_MGD_STEPS / mgd_s,
            mgd_last_cost=aux["cost"][-1].item(),
            mgd_heldout_acc_512=rt.classification_accuracy(
                apply_fn, params, xe, ye).item(),
            mgd_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = rt.train_backprop(loss, init_fn(0, device=dev), sample,
                                CNN_BP_STEPS, eta=CNN_BP_ETA, chunk=200,
                                log=None)
        torch.cuda.synchronize()
        bp_s = time.perf_counter() - t0
        if not all(math.isfinite(h["cost"]) for _, h in res.history):
            fail(f"paper CNN {name}: a backprop cost went non-finite")
        rec.update(
            bp_steps=CNN_BP_STEPS, bp_steps_per_s=CNN_BP_STEPS / bp_s,
            bp_last_cost=res.history[-1][1]["cost"],
            bp_heldout_acc_512=rt.classification_accuracy(
                apply_fn, res.params, xe, ye).item(),
            bp_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=counts, card=card)
        out[name] = rec
        print(json.dumps({"paper_cnn": name, **{k: v for k, v in rec.items()
                                                if k != "gate"}}),
              flush=True)
    return out


# -- phase 11: probe parallelism and the chip farm --------------------------

PODS = 4
PP_MLP_STEPS = 32
PP_LM_CT_STEPS = 3
PP_LM_STEPS = 8
PP_LM_BATCH = 8             # a pod's batch: launch/train.py's 8 × seq 64
FARM_STEPS = 50
FARM_BATCH = 8
FARM_LAW_STEPS = 5
FARM_BACKENDS = ("serial", "thread", "process", "cluster", "thread+pipeline")


class WindowRecorder:
    """Wraps ``kernels.ops.mgd_update_window_group`` to record each call's
    (leaves, J) — the launch counters say how often the window update ran,
    this says how many leaves and windows one launch carried."""

    def __init__(self, ops):
        self.ops, self.orig, self.calls = ops, None, []

    def __enter__(self):
        self.orig = self.ops.mgd_update_window_group

        def wrapped(leaves, lseeds, coefs, **kw):
            leaves = list(leaves)
            self.calls.append((len(leaves), int(coefs.shape[0])))
            return self.orig(leaves, lseeds, coefs, **kw)

        self.ops.mgd_update_window_group = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.mgd_update_window_group = self.orig


def pp_expected(steps, per_pod_pairs, windows=1):
    return dict(perturbed_matmul=0,
                perturbed_matmul_pair=PODS * per_pod_pairs * steps,
                mgd_update_window=windows * steps, mgd_update=0)


def check_window_calls(rec, leaves, what):
    """Every recorded window update carried ``leaves`` leaves and J = PODS
    windows."""
    bad = [c for c in rec.calls if c != (leaves, PODS)]
    if not rec.calls or bad:
        fail(f"{what}: window updates carried (leaves, J) {rec.calls}, "
             f"expected ({leaves}, {PODS}) each")


def pp_mlp(torch, rt, kernels, tasks, pipeline, card, dev):
    """Phase 11a: NIST7x7 49-4-4 through ``driver("probe_parallel")``, 4
    pods on one card, fused central; every step against the plain route
    from the same state; then a timed counted run."""
    from repro_torch.kernels import ops

    def loss(p, b):
        return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])

    def make(impl):
        return rt.driver("probe_parallel", rt.DriverConfig(
            dtheta=1e-2, eta=0.1, seed=1, fused=True, mode="central",
            kernel_impl=impl), loss, probe_fn=rt.make_mlp_probe_fn(),
            mesh=rt.LocalMesh(pod=PODS), device=dev)

    # one sample a pod: batch i of the reference's sampler at batch 4
    sample = pipeline.generator_sampler(tasks.nist7x7_batch, PODS, seed=7,
                                        device=dev)
    p0 = rt.mlp_init(2, MLP_SIZES, device=dev)
    drv, ref = make(None), make("ref")
    expected = pp_expected(PP_MLP_STEPS, 2)
    totals = {name: 0 for name in SOURCES}
    kernels.reset_launch_counts()
    with WindowRecorder(ops) as rec:
        t0 = time.perf_counter()
        # phase 9's limits: C̃ 1e-5, params η·1e-5/Δθ = 1e-4
        gate, params = same_state_steps(
            torch, drv, ref, p0, drv.init(p0), sample, PP_MLP_STEPS, CT_ATOL,
            0.1 * CT_ATOL / 1e-2, what="4-pod MLP")
        torch.cuda.synchronize()
        gate_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if counts != expected:
        fail(f"4-pod MLP gate: launches {counts} != {expected}")
    check_routes(kernels, counts, "simt", "4-pod MLP gate")
    check_window_calls(rec, 2, "4-pod MLP")
    for k, v in counts.items():
        totals[k] += v
    run = rt.make_epoch(drv, PP_MLP_STEPS, sample)
    state = drv.init(params)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, aux = run(params, state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if counts != expected:
        fail(f"4-pod MLP: launches {counts} != {expected}")
    check_routes(kernels, counts, "simt", "4-pod MLP")
    if not bool(torch.isfinite(aux["cost"]).all()):
        fail("4-pod MLP: a cost went non-finite")
    for k, v in counts.items():
        totals[k] += v
    out = dict(pods=PODS, steps=PP_MLP_STEPS, steps_per_s=PP_MLP_STEPS / dt,
               gate_s=gate_s, **gate, launches_per_step={
                   k: v / PP_MLP_STEPS for k, v in counts.items()},
               window_calls=rec.calls[:1], last_cost=aux["cost"][-1].item(),
               card=card)
    print(json.dumps({"probe_parallel_mlp": out}), flush=True)
    return out, totals


def pp_transformer(torch, rt, kernels, card, dev):
    """Phase 11b: Qwen3-14B at full width, LM_LAYERS layers, bf16, 4 pods
    of batch 8 × seq 64 (global 32 × 64): the first PP_LM_CT_STEPS steps
    C̃-gated against the plain route (controls: C̃ = 0, seed 1), then
    PP_LM_STEPS counted steps."""
    from repro_torch.kernels import ops

    cfg = rt.get_config("qwen3-14b").replace(n_layers=LM_LAYERS)
    sample = rt.lm_sampler(PODS * PP_LM_BATCH, 64, cfg.vocab, seed=0,
                           device=dev)
    p0 = rt.model_init(cfg, 0, device=dev)

    def make(impl, seed):
        return rt.driver("probe_parallel", rt.DriverConfig(
            dtheta=1e-2, eta=1e-2, seed=seed, fused=True, mode="central",
            kernel_impl=impl), lambda p, b: rt.model_loss(p, cfg, b),
            probe_fn=rt.make_transformer_probe_fn(cfg),
            mesh=rt.LocalMesh(pod=PODS), device=dev)

    params, state, drv, gate = c_tilde_gate(
        torch, rt, cfg, dev, sample, p0, {"pods": PODS},
        steps=PP_LM_CT_STEPS, make=make)
    print(json.dumps({"probe_parallel_lm_c_tilde": gate}), flush=True)
    per_pod = LM_PER_LAYER * LM_LAYERS + 1
    expected = pp_expected(PP_LM_STEPS, per_pod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with WindowRecorder(ops) as rec:
        t0 = time.perf_counter()
        params, state, aux = rt.make_epoch(drv, PP_LM_STEPS, sample)(
            params, state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts != expected:
        fail(f"4-pod transformer: launches {counts} != {expected}")
    by_route = check_routes(kernels, counts, "tc", "4-pod transformer")
    check_window_calls(rec, LM_WINDOW_LEAVES, "4-pod transformer")
    if not bool(torch.isfinite(aux["cost"]).all()):
        fail("4-pod transformer: a cost went non-finite")
    prof = device_profile(
        torch, lambda: rt.make_epoch(drv, 2, sample)(params, state), 2)
    out = dict(pods=PODS, layers=LM_LAYERS,
               batch_per_pod=[PP_LM_BATCH, 64],
               main_path_steps=PP_LM_STEPS, steps_per_s=PP_LM_STEPS / dt,
               s_per_step=dt / PP_LM_STEPS, peak_mem_gb=peak / 1e9,
               last_cost=aux["cost"][-1].item(), launches=counts,
               launches_by_kernel=by_route, window_calls=rec.calls[:1],
               profile=prof, **gate, card=card)
    print(json.dumps({"probe_parallel_lm": out}), flush=True)
    del params, state, aux, drv, p0
    torch.cuda.empty_cache()
    return out, counts


def farm_run(torch, rt, backend, batches, dev, *, pipeline=False, **kw):
    """FARM_STEPS steps of ``driver("probe_parallel_external")`` over a
    4-chip simulated farm; returns (C̃ per step, final params, seconds,
    pipeline_stats, fault_summary, n_used per step)."""
    from repro_torch.hardware import simulated_chip_farm

    with simulated_chip_farm(PODS, MLP_SIZES, backend=backend,
                             pipeline=pipeline, **kw) as farm:
        drv = rt.driver("probe_parallel_external", rt.DriverConfig(
            dtheta=2e-2, eta=0.125 * PODS, mode="central", seed=1),
            plant=farm, device=dev)
        params = rt.mlp_init(2, MLP_SIZES, device=dev)
        state = drv.init(params)
        cts, used = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            params, state, aux = drv.step(params, state, b)
            cts.append(aux["c_tilde"])
            used.append(aux.get("n_used"))
        farm.fence()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats, faults = farm.pipeline_stats(), farm.fault_summary()
    cts = torch.stack(cts).cpu()
    used = [int(u) for u in used] if used[0] is not None else None
    return cts, params, dt, stats, faults, used


def chip_farm(torch, rt, tasks, pipeline, card, dev):
    """Phase 11c: the chip farm with the optimizer on the card — the four
    backends (and a pipelined thread farm) bitwise against serial, the
    dyadic mesh ≡ farm law on the card, and 10 % silent faults under the
    full policy."""
    from repro_torch.core.utils import tree_leaves
    from repro_torch.hardware import (ChipFarm, DeviceSpec, FaultPolicy,
                                      FaultSpec, LinearLaneChip,
                                      SimulatedAnalogChip)
    from repro_torch.hardware.backend import (ClusterStubBackend,
                                              loopback_transport)

    sample = pipeline.generator_sampler(tasks.nist7x7_batch, FARM_BATCH,
                                        seed=11, device=dev)
    batches = [sample(i) for i in range(FARM_STEPS)]

    def loopback():
        specs = [DeviceSpec(SimulatedAnalogChip, (MLP_SIZES,),
                            dict(seed=i, sigma_a=0.15, sigma_theta=0.01,
                                 sigma_c=1e-4, py_busy_ms=0.0))
                 for i in range(PODS)]
        return ClusterStubBackend(transport=loopback_transport(specs))

    out = {"backends": {}}
    ref = None
    for name in FARM_BACKENDS:
        backend = {"cluster": loopback,
                   "thread+pipeline": lambda: "thread"}.get(
                       name, lambda: name)()
        cts, params, dt, stats, _, _ = farm_run(
            torch, rt, backend, batches, dev,
            pipeline=name.endswith("pipeline"))
        flat = torch.cat([x.reshape(-1).cpu() for x in tree_leaves(params)])
        if ref is None:
            ref = (cts, flat)
        elif not (torch.equal(cts, ref[0]) and torch.equal(flat, ref[1])):
            fail(f"farm {name}: trajectory differs from serial's (C̃ gap "
                 f"{(cts - ref[0]).abs().max().item()}, params "
                 f"{(flat - ref[1]).abs().max().item()})")
        if not bool(torch.isfinite(flat).all()):
            fail(f"farm {name}: params went non-finite")
        out["backends"][name] = dict(
            steps=FARM_STEPS, steps_per_s=FARM_STEPS / dt,
            copy_share=stats["copy_s"] / dt, pipeline_stats=stats,
            bitwise_vs_serial=True)
        print(json.dumps({"farm": name, **out["backends"][name]}),
              flush=True)

    # the dyadic law: 4 pods on their batch blocks ≡ a 4-chip
    # LinearLaneChip farm on the same shards, bitwise, optimizer on the card
    cfg = rt.DriverConfig(dtheta=0.5, eta=0.5, mode="central", seed=5)
    x = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]] * 2,
                     dtype=torch.float32, device=dev)
    y = torch.tensor([[0], [1], [1], [0]] * 2, dtype=torch.float32,
                     device=dev)
    batch = {"x": x, "y": y}

    def dyadic():
        return [{"w": torch.tensor([[0.5], [-0.25]], device=dev),
                 "b": torch.tensor([0.25], device=dev)}]

    pods = rt.driver("probe_parallel", cfg,
                     lambda p, b: rt.core.mae(b["y"],
                                              rt.linear_apply(p, b["x"])),
                     mesh=rt.LocalMesh(pod=PODS), device=dev)
    with ChipFarm([LinearLaneChip() for _ in range(PODS)],
                  shard_batch=True) as farm:
        ext = rt.driver("probe_parallel_external", cfg, plant=farm,
                        device=dev)
        p_m, p_f = dyadic(), dyadic()
        s_m, s_f = pods.init(p_m), ext.init(p_f)
        for step in range(FARM_LAW_STEPS):
            p_m, s_m, a_m = pods.step(p_m, s_m, batch)
            p_f, s_f, a_f = ext.step(p_f, s_f, batch)
            if not (torch.equal(a_m["c_tilde"], a_f["c_tilde"]) and all(
                    torch.equal(a, b) for a, b in
                    zip(tree_leaves(p_m), tree_leaves(p_f)))):
                fail(f"dyadic law: 4 pods and the 4-chip farm differ at "
                     f"step {step}")
    out["dyadic_law"] = dict(steps=FARM_LAW_STEPS, bitwise=True,
                             final_c_tilde=a_m["c_tilde"].item())

    # 10 % silent faults (NaN and outliers) under retry + quarantine + MAD
    policy = FaultPolicy(timeout_s=5.0, retries=3, backoff_s=0.01,
                         backoff_max_s=0.1, quarantine_after=4,
                         reprobe_every=60, aggregate="mad", mad_threshold=8.0)
    cts, params, dt, stats, faults, used = farm_run(
        torch, rt, "thread", batches, dev, sigma_theta=0.0,
        faults=FaultSpec(nan=0.05, outlier=0.05, outlier_scale=50.0),
        fault_seed=1000, fault_policy=policy)
    finite = bool(torch.isfinite(cts).all()) and all(
        bool(torch.isfinite(x).all()) for x in tree_leaves(params))
    if not finite:
        fail(f"faulty farm: non-finite C̃ or params ({faults})")
    out["silent_faults_10pct"] = dict(
        steps=FARM_STEPS, steps_per_s=FARM_STEPS / dt, n_used=used,
        min_n_used=min(used), faults=faults, card=card)
    print(json.dumps({"farm": "silent_faults_10pct",
                      **out["silent_faults_10pct"]}), flush=True)
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
                    help="MLP training steps per run (multiple of 4, >= 32)")
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
    t_start = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t_start
    print(f"kernels built in {build_s:.1f} s ({_build.BUILD_DIR})")
    for line in ptxas_summary(reports):
        print(line)
    from repro_torch.kernels import mgd_update
    int_ops = update_int_ops(
        torch, _build, mgd_update,
        args.out.with_suffix(".mgd_update.sass") if args.out else None)

    phase_s = {1: time.perf_counter() - t_start}
    print(f"phase 1 done in {phase_s[1]:.1f} s", flush=True)

    def done(n, t0):
        phase_s[n] = time.perf_counter() - t0
        print(f"phase {n} done in {phase_s[n]:.1f} s", flush=True)

    # -- phase 2: kernels against plain, on the card ------------------------
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    recs = compare_kernels(torch, ops, pert, dev, int_ops)
    done(2, t0)

    # -- phase 3: MLP training on the card ----------------------------------
    t0 = time.perf_counter()
    results, totals = train(torch, rt, kernels, tasks, pipeline, card,
                            args.steps, dev)
    done(3, t0)

    # -- phase 4: where the MLP path's step time goes -----------------------
    t0 = time.perf_counter()
    profiles = profile_main_path(torch, rt, tasks, pipeline, card, dev)
    device_us = kernel_device_us(profiles)
    done(4, t0)

    # -- phase 5: the transformer slice at full width, 4 layers -------------
    t0 = time.perf_counter()
    lm_results, lm_totals = transformer_slice(torch, rt, kernels, card, dev)
    done(5, t0)

    # -- phase 6: full depth, 40 layers -------------------------------------
    t0 = time.perf_counter()
    deep, deep_counts = full_depth(torch, rt, kernels, card, dev)
    done(6, t0)

    # -- phase 7: an imperfect device at full width, 4 layers ---------------
    t0 = time.perf_counter()
    imperfect, imperfect_counts = imperfect_device(torch, rt, kernels, card,
                                                   dev)
    done(7, t0)

    # -- phase 8: checkpoint and resume at full width -----------------------
    t0 = time.perf_counter()
    resume = resume_full_width(torch, rt, card, dev)
    done(8, t0)

    # -- phase 9: the paper's model through its imperfect devices -----------
    t0 = time.perf_counter()
    paper, paper_counts = paper_model(torch, rt, kernels, tasks, pipeline,
                                      card, dev)
    done(9, t0)

    # -- phase 10: the paper's CNNs, MGD and backprop (Table 2) -------------
    t0 = time.perf_counter()
    cnns = paper_cnns(torch, rt, kernels, tasks, pipeline, card, dev)
    done(10, t0)

    # -- phase 11: probe parallelism (4 pods) and the chip farm -------------
    t0 = time.perf_counter()
    pp = {}
    pp["mlp"], pp_mlp_counts = pp_mlp(torch, rt, kernels, tasks, pipeline,
                                      card, dev)
    t_a = time.perf_counter()
    pp["transformer"], pp_lm_counts = pp_transformer(torch, rt, kernels,
                                                     card, dev)
    t_b = time.perf_counter()
    pp["farm"] = chip_farm(torch, rt, tasks, pipeline, card, dev)
    pp["seconds"] = {"11a": t_a - t0, "11b": t_b - t_a,
                     "11c": time.perf_counter() - t_b}
    print(f"phase 11: 11a {pp['seconds']['11a']:.1f} s, 11b "
          f"{pp['seconds']['11b']:.1f} s, 11c {pp['seconds']['11c']:.1f} s",
          flush=True)
    done(11, t0)

    for counts in (lm_totals, deep_counts, imperfect_counts, paper_counts,
                   pp_mlp_counts, pp_lm_counts):
        for k, v in counts.items():
            totals[k] += v
    main_shape = {"perturbed_matmul": (list(LM_MAIN), "bfloat16", None),
                  "perturbed_matmul_pair": (list(LM_MAIN), "bfloat16", None),
                  "mgd_update_window": (list(LM_MAIN[1:]), "bfloat16", 1),
                  "mgd_update": ([5120, 17408], "bfloat16", 4)}
    by_kernel = {name: {"tc": 0, "simt": 0}
                 for name in kernels.MATMUL_WRAPPERS}
    for rec in [*results.values(), *lm_results.values(), deep, imperfect,
                pp["transformer"]]:
        for name, routes in rec.get("launches_by_kernel", {}).items():
            for r, v in routes.items():
                by_kernel[name][r] += v
    lm_us = lm_results["central_tau1"]["profile"]["kernel_us_per_launch"]
    entries = []
    for name, (source, replaces) in SOURCES.items():
        shape, dname, window = main_shape[name]
        main_rec = next(r for r in recs[name] if r["shape"] == shape
                        and r["dtype"] == dname
                        and r.get("window") == window)
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=totals[name], max_abs_err=main_rec["max_abs_err"],
            ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
            bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"], shape=shape, dtype=dname,
            int_ops_per_element_step=main_rec.get("int_ops_per_element_step"),
            device_us_per_launch_mlp_path=device_us.get(name),
            device_us_per_launch_lm_path=lm_us.get(name), card=card)
        if name in by_kernel:   # the f32 MLP path runs the SIMT kernel
            entry.update(
                kernel=main_rec["kernel"], launches_by_kernel=by_kernel[name],
                simt_source="src/repro_torch/kernels/csrc/perturbed_matmul.cu",
                simt_ms=main_rec["simt_ms"], cluster=main_rec["cluster"],
                cluster_ab_ms=main_rec["cluster_ab_ms"],
                cluster1_ms=main_rec["cluster1_ms"],
                split_bound_ms=main_rec["split_bound_ms"],
                f32_out_rel_err=main_rec["f32_out_rel_err"])
        entries.append(entry)
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: all phases passed in {total_s:.1f} s", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=card, build_s=build_s, total_s=total_s, kernels=entries,
            shapes=recs, train=results, profile=profiles,
            transformer=lm_results, full_depth=deep,
            imperfect_device=imperfect, resume=resume, paper_model=paper,
            paper_cnns=cnns, probe_parallel=pp, phase_s=phase_s,
            ptxas=ptxas_summary(reports)), indent=1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
