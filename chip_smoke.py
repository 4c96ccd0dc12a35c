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
   after 500 MGD and 400 backprop steps, peak memory.

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

12. Serving.  12a: Qwen3-14B at full width and all 40 layers, bf16,
   random weights from seed 0: ``python -m repro_torch.launch.serve``'s
   batch generation (its defaults: batch 4, prompt 32, 32 new tokens,
   through ``serving.greedy_generate``), then prefill and decode timed on
   their own (the decode step also under ``torch.profiler``: device
   time, device ops and busy share) beside its bound
   (the weights, KV cache and logits a step moves at 3.35 TB/s), the
   tokens per second and peak memory.  Gate: teacher-forced decode from a
   16-token prefill of the prompts matches the full forward at every
   later position within 8 bf16 ulps of max|logit|; two controls must
   miss it (the cache's length one short, the last written cache position
   zeroed).  12b: the online service (``repro_torch.serve``, 4 slots)
   over Qwen3-14B at 4 layers with the fused central trimmer (Δθ = η =
   1e-2, ``TrimConfig(..., probe_fn=make_transformer_probe_fn(cfg))``),
   fed ``launch/serve.py``'s synthetic corpus (8 × 33 tokens) with
   feedback: predict launches no kernel; the trimmer's first 3 steps are
   C̃-gated against the plain route from the same state as in phase 5;
   then 4 counted trim steps, 29 tensor-core pair launches and one window
   update a step; then the dispatcher and trainer threads for 5 s
   (served requests, publishes, latency p50/p99, trim steps/s, peak
   memory).  12c: the online-serving bench's MLP service on the card: the
   torn-swap hammer (1024 requests under a publish loop) gives 0, and
   serve → trim → checkpoint (a temporary directory, removed) → restore
   → trim equals the uninterrupted run bitwise (f32).

13. The attention families at full width, bf16, random weights from seed
   0, ``launch/train.py``'s batch 8 × 64, Δθ = η = 1e-2, central.  13a
   qwen2-vl-2b, all 28 layers (patch embeddings and M-RoPE positions
   [8, 64, 3] from a seed, the LM stream's labels) and 13b
   musicgen-medium, all 48 layers (codebook tokens [8, 4, 64], labels
   [8, 64, 4]), and 13e mistral-nemo-12b, granite-34b (MQA) and qwen2-72b
   (QKV bias) at one layer each, on the fused path: 2 steps C̃-gated
   against the plain route from the same state as in phase 5 (both
   controls must miss at the first), then 2 counted steps of 7·L + 1
   tensor-core pair launches and one window update; 13a/13b's decode
   gate as phase 12a's (8 bf16 ulps of max|logit|, two controls) on
   embeddings [8, 1, 1536] and codebook tokens [8, 4].  13c
   llama4-scout-17b-a16e (MoE, 16 experts top-1 + shared), 2 of its 48
   layers: materialized probes and the window update over every matrix
   leaf, the rank-4 expert banks [2, 16, 5120, 8192] included (one launch
   a dtype: bf16 and the f32 router), 3 steps whose params must equal the
   plain update's bitwise and differ from another seed's, then 2 counted
   steps with no perturbed-matmul launch; the share of routings capacity
   drops at each step; peak memory under 80 GB.  13d deepseek-v3-671b
   (MLA + MoE, 256 experts top-8), 1 of its 61 layers, serving only (an
   MGD step's three trees would be 80 GB): the forward of 8 × 64 tokens
   and its drop share, timed absorbed-form decode steps beside their
   bytes bound, and the bf16 decode reading against the forward
   (printed).  The MoE decode gates (13c, 13d) run in f32 at the
   capacity factor at which nothing drops: decode against the full
   forward within 2⁻¹⁶ of max|logit|, a limit one bf16 rounding would
   miss, and both controls (length short; K/V, for MLA c_kv, zeroed at
   the last position) missing it; in bf16, near-tied routings flip
   between the two.

14. The recurrent families (``ssm``: RWKV-6; ``hybrid``: Mamba-2 + one
   shared attention block), probing by materializing θ ± θ̃ (no perturbed
   matmul) and updating through the window update, one launch a dtype.
   14a: the smoke configs of rwkv6-7b and zamba2-7b in f32 on the card
   against the CPU from the same params and batches (8 × 64): forward
   logits and 2 fused central steps (C̃, params) within 2⁻¹⁶ of max|logit|
   / of each step's cost / of their sum, printed as fractions of those
   limits, and the same gate with TF32 allowed (cuBLAS, cuDNN) missing
   it; the card's chunked recurrences against their own step recurrences
   within 2e-3 (the reference's test shapes, and both models' head widths
   at batch 8).  14b rwkv6-7b (all 32 layers, 7.54 G params) and 14c
   zamba2-7b (all 81: 54 Mamba-2 blocks, 27 calls of the shared block;
   4.65 G), bf16, seed 0, batch 8 × 64, Δθ = η = 1e-2, central, through
   ``driver`` and ``make_epoch``: 3 steps whose params must equal the
   plain update's bitwise and differ from another seed's, then 2 counted
   steps with no B1/B2 launch and one B3 launch a dtype a step; s a step,
   one sign's θ ± θ̃ beside its bytes bound, peak memory (under 80 GB),
   the device's busy share of a step.  14d both served at full depth:
   ``launch/serve.py``'s defaults, prefill and decode timed beside the
   decode's bytes bound (weights, the recurrent state read and written,
   zamba2's K/V), tok/s, peak memory, a bf16 decode reading (printed);
   the f32 decode gate, teacher-forced from a 16-token prefill against the
   full forward within 2⁻¹⁶ of max|logit|, with two controls that must
   miss it (rwkv6: the last layer's wkv state, then its token shift,
   zeroed after prefill; zamba2: the last Mamba layer's conv tail zeroed
   after prefill, the shared block's K/V at the last position zeroed).

15. The bench twins on the card (``repro_torch.benchmarks``), each with
   the launch counters zeroed before it and read after: ``fused_probe``
   whole (the MLP (64, 64, 10) and the qwen3-14b smoke config in f32,
   forward and central, materialized against fused, 20 + 60 steps a run),
   ``table3_hardware``, and ``farm_scaling`` and ``scaling_laws`` at
   their ``--smoke`` budgets (the committed baselines').  Gates: each
   fused run's launches equal its path's (B1 forward or B2 central, on
   the SIMT kernel, and one B3 a step), the materializing runs launch
   nothing; each of the first 32 steps of each fused run, run again and
   probed from the same params and state through the plain route on the
   card, gives the twin's C̃ bitwise and the plain route's within 1e-5,
   which both controls (C̃ = 0, another seed's signs) miss, and B3's
   params bitwise the plain update's of the same params, seeds and C̃
   (another seed's update the control); the whole run's first 32 C̃
   against the plain route's run from the same init: within 1e-5 for
   the MLP, and for the transformer (η/Δθ = 10) within 1e-5 or, where
   the plain route itself moves further over those steps from ``wq``
   moved up one ulp or on the CPU (the witness), within 4× the witness;
   ``mesh_farm_bitmatch_f32`` is 1.0; every arithmetic row (``*_seconds``,
   ``*_wread_ratio``, ``projected_*``, ``params_*``) lies in its
   ``check_regression`` band around ``artifacts/bench/<bench>.json``.
   The statistical, accuracy and timing rows are printed; with ``--out
   X.json`` all rows are written to ``X.bench/<bench>.json`` for
   ``python -m benchmarks.check_regression --fresh X.bench --baseline
   artifacts/bench``.

16. The paper's figure benches (``hardware_plants``, ``fig4_equivalence``
   … ``fig8_noise``), which run the unfused driver and launch no kernel:
   the launch counters are zeroed before the phase and it fails if any
   kernel launched.  16a: each of hardware_plants' XOR plant kinds (ideal,
   σ_C, σ_θ, σ_a, 8-bit DAC, the same with τ_w = 4, 8-bit ADC round and
   stochastic, central) runs FIG_GATE_STEPS steps of its row's driver on
   the card, each repeated on the CPU from the card's params, state and
   batch: C̃ within 1e-5 at every step; the σ_C, σ_θ, stochastic-ADC and
   σ_a draws bitwise the CPU's; steps/s of each kind on both.  16b: cut
   calls of the twins' own functions (``time_to_solve_xor(max_steps=,
   chunk=)``, ``_nist_accuracy(steps=, chunk=)``, ``_bound_ratio(writes=)``,
   ``_mgd_curve(iters=, chunk=)``, backprop, ``_angles(seeds=, iters=)``,
   ``train_until``) covering the NIST7x7 device path, the bound ratio,
   fig4's τ = 100 curve, fig5's angles at 100 and 1000 steps, fig6's
   batch-4 path, Walsh and sinusoidal codes at τ_x = 250, fig9 at
   τ_θ = 100 and fig10's defects, each on the card and on the CPU and
   printed side by side, not gated; where they differ, the witness (the
   CPU call from layer 0's W × (1 + 2⁻²⁰)) is printed too.  16c: the
   ``*_projected_s`` rows equal ``artifacts/bench/hardware_plants.json``'s
   exactly.  Printed: steps/s by kind on the card and the CPU, and each
   twin's whole budget in steps (from the committed baselines' solved
   counts, or the reference's budgets as an upper bound) and projected
   seconds at those rates.

17. Distribution on ``torch.distributed``, in two processes of this
   script (``--phase17 a|b``; a fake world and a real one cannot share
   one default process group), each of which must exit 0.  17a, needing
   no card: the dry run of Qwen3-14B
   train_4k on a fake (16, 16) world of 256 ranks at full depth, fake
   CUDA tensors, nothing allocated, started beside phase 13 (``launch.dryrun.run_cell``): its
   params equal ``specs.abstract_params``' count, its counted flops lie
   within DRY_RATIO of ``model_flops`` and its collective bytes are > 0;
   it prints collective MiB by type, args and temp GiB per rank and the
   H100 roofline terms.  17b: a one-rank NCCL world on the card and a
   (1, 1) ("data", "model") mesh: Qwen3-14B at 4 layers, bf16, placed by
   ``param_shardings`` and ``shard_batch``, 3 unfused central and 3
   forward steps with C̃ and params bitwise the unsharded step's from
   the same state; probe pods as ranks (pod = 1), fused, on that model
   and on the NIST7x7 MLP, bitwise ``LocalMesh(pod=1)``, their B2 and B3
   (J = 1) launches counted into the kernels line; the stacked
   attention weights saved from the mesh and restored with no mesh,
   bitwise; and
   ``quantize_int8`` on a [5120, 17408] f32 tensor, card against CPU,
   bitwise.  Phase 16's cut calls run 100 XOR steps (16b) and 50 timed
   steps a kind (16a) to make room for it.  17c, in 17b's process and
   on its mesh: 17c.1 each kernel on the four blocks a (2, 2) mesh gives
   a leaf (the LM's gate/up [5120, 17408] in bf16 on the tensor-core
   route, [1024, 768] f32 on the SIMT one), the block's offset in its
   seed and the leaf's N as ``n_cols``: B1/B2 on a column block bitwise
   the whole leaf's columns, the row blocks' products summing to the
   whole within 1e-4, B3/B4 on every block bitwise the whole update's
   block, each block launch against its plain version with the same
   ``n_cols``; 17c.2 3 fused central and 3 forward steps of 17b's model
   on DTensor params (B1/B2/B3 on the local shards), bitwise the
   unsharded fused steps, with the same launch counts (into the kernels
   line); 17c.3 llama4-scout (1 layer), deepseek-v3 (1), rwkv6 (2) and
   zamba2 (3) at full width on the mesh: forward, prefill and a decode
   token bitwise the unsharded model's, then one MGD step on the mesh
   (unfused, C̃ and params bitwise the unsharded step's; DeepSeek-V3's
   fused, whose probes materialize one θ ± θ̃ at a time: its unfused
   step's three trees would not fit), its peak memory printed.  Each
   family's unsharded step runs first and its C̃ and params are kept on
   the host, so the mesh step need not share the card with them.  17d,
   in 17b's process and on its mesh, the pieces of the four-card run
   (``tests/torch_dist_worker.py cards_full``): 17d.1 the sharded init
   (``model_init(..., shardings=)``) bitwise ``device_put`` of the whole
   init, qwen2-72b at 2 layers under the default rules and llama4-scout
   at 1 under ``MOE_EP_RULES``; 17d.2 the one-card witness of
   ``tests/torch_witness.py`` (the model redrawn a part at a time)
   bitwise qwen2-72b's whole-model fused steps at 2 layers: the cost at
   θ₀, a central step (B2, B3) and a forward step (B1, B3), their probe
   costs, C̃ and every updated leaf, the steps' launches counted into the
   kernels line; 17d.3 llama4-scout's peak through its fused central
   step at 1, 2 and 3 layers (above what the process held before), and
   the deepest depth one card holds by the line through them.

Phase 3 also prints the NIST7x7 sampler's ms a batch (batch 1): the
samplers draw the reference's batches with ``core.rng``'s threefry in
eager torch ops.  Every phase prints its seconds.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing neither, when
there is no CUDA card or the repo's sources are not beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
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
TRAIN_STEPS = 1000
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


def ct_gate_record(cts, plain_cts, other_cts, costs, what):
    """Phase 5's C̃ gate on recorded values: ``cts`` within LM_CT_REL of
    each step's cost of the plain route's, and both controls (C̃ = 0,
    another seed's signs) missing that limit."""
    tols = [LM_CT_REL * abs(c) for c in costs]

    def worst(vals):
        return max(abs(v - p) / t for v, p, t in zip(vals, plain_cts, tols))

    rec = dict(c_tilde_first=cts, c_tilde_first_plain=plain_cts,
               c_tilde_first_other_seed=other_cts, first_costs=costs,
               c_tilde_tol=tols,
               c_tilde_max_abs_err_vs_plain=max(
                   abs(a - b) for a, b in zip(cts, plain_cts)),
               c_tilde_err_in_tols=worst(cts),
               control_zero_err_in_tols=worst([0.0] * len(cts)),
               control_other_seed_err_in_tols=worst(other_cts))
    if not rec["c_tilde_err_in_tols"] <= 1.0:
        fail(f"{what}: C̃ {cts} differ from the plain route's {plain_cts} "
             f"beyond {tols}")
    for control in ("control_zero", "control_other_seed"):
        if not rec[control + "_err_in_tols"] > 1.0:
            fail(f"{what}: the C̃ gate passes its {control} ({rec})")
    return rec


def c_tilde_gate(torch, rt, cfg, dev, sample, p0, kw, steps=LM_CT_STEPS,
                 plant=None, read_plant=None, make=None, what=None):
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
    torch.cuda.synchronize()
    rec = ct_gate_record(cts, plain_cts, other_cts, costs,
                         what or f"transformer {kw}")
    return params, state, drv, rec


def controls_each_step(gate, plain, others, costs, n, what):
    """Both controls of the C̃ gate (C̃ = 0, another seed's C̃) read against
    the plain route's C̃ at every step, in tolerances of the step's cost,
    into ``gate``; each must miss at each of the first ``n`` steps."""
    tols = [LM_CT_REL * abs(c) for c in costs]
    for control, vals in (("zero", [0.0] * len(plain)),
                          ("other_seed", others)):
        per_step = [abs(v - p) / t for v, p, t in zip(vals, plain, tols)]
        gate[f"control_{control}_err_in_tols_per_step"] = per_step
        if not all(m > 1.0 for m in per_step[:n]):
            fail(f"{what}: the C̃ gate passes its control_{control} at one "
                 f"of the first {n} steps ({per_step})")
    return gate


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
CNN_MGD_STEPS = 500         # of Table 2's 8000 (Fashion) / 6000 (CIFAR)
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


def pp_expected(steps, per_pod_pairs, windows=1, pods=PODS):
    return dict(perturbed_matmul=0,
                perturbed_matmul_pair=pods * per_pod_pairs * steps,
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


# -- phase 12: serving ---------------------------------------------------------

GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 32, 32      # launch/serve.py's defaults
GATE_PREFILL = 16
GATE_ULPS = 8              # decode gate: bf16 ulps of max|logit| (full fwd)
PROFILE_DECODE_STEPS = 4
SERVE_LAYERS = 4
SERVE_SLOTS = 4
SERVE_CT_STEPS = 3         # trim steps probed again through the plain route
# of them gated: at eta = dtheta = 1e-2 the trimmer's cost grows ~3-5x a step
# (12.8 -> 36.5 -> 192.7 on the H100), so by step 3 C~ is below the bf16
# cost's resolution and neither control can miss; that step is printed only
SERVE_CT_GATED = 2
SERVE_MAIN_STEPS = 4
SERVE_BACKGROUND_S = 5.0
HAMMER_REQUESTS = 1024


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def decode_errors(torch, tt, params, cfg, seq, full, *, kind="tokens",
                  shift=0, zero_last=False, after_prefill=None):
    """Teacher-forced decode from a GATE_PREFILL-position prefill: the
    largest gap to the full forward's logits at every later position.
    ``seq`` is tokens [B, S] (``kind="tokens"``), codebook tokens [B, nq,
    S] (``"codebooks"``) or stub-frontend embeddings [B, S, d]
    (``"embeds"``).  The controls: ``shift`` makes the cache's length that
    much short; ``zero_last`` zeroes the last written cache position
    before each step, K and V (for MLA the latent c_kv); ``after_prefill``
    tampers with the prefilled cache once (a recurrent state)."""
    length = seq.shape[-1] if kind == "codebooks" else seq.shape[1]

    def at(t0, t1):
        return seq[:, :, t0:t1] if kind == "codebooks" else seq[:, t0:t1]

    zeroed = ("c_kv",) if cfg.use_mla else ("k", "v")
    with torch.no_grad():
        pf, cache = tt.model_prefill(
            params, cfg,
            {"embeds" if kind == "embeds" else "tokens": at(0, GATE_PREFILL)},
            length)
        err = (pf.float() - full[:, :GATE_PREFILL].float()).abs().max().item()
        cache["length"] = cache["length"] - shift
        if after_prefill is not None:
            after_prefill(cache)
        for t in range(GATE_PREFILL, length):
            if zero_last:
                last = int(cache["length"]) - 1
                for key in zeroed:
                    cache[key][:, :, last] = 0
            if kind == "embeds":
                lg, cache = tt.model_decode(params, cfg, None, cache,
                                            embeds=at(t, t + 1))
            else:
                lg, cache = tt.model_decode(params, cfg, at(t, t + 1)[..., 0],
                                            cache)
            err = max(err, (lg.float() - full[:, t].float()).abs().max()
                      .item())
    return err


KV_CONTROLS = {"length_short": dict(shift=1),
               "zeroed_last": dict(zero_last=True)}


def decode_gate(torch, tt, params, cfg, seq, full, what, *, kind="tokens",
                rel=None, controls=KV_CONTROLS):
    """The decode gate on ``seq``: its error against the full forward
    within GATE_ULPS bf16 ulps of max|logit| (or ``rel``·max|logit|), and
    each control (``decode_errors`` keywords by name; by default the
    cache's length one short and the last written cache position zeroed)
    missing it.  Returns the record."""
    top = full.float().abs().max().item()
    limit = rel * top if rel else GATE_ULPS * bf16_ulp(top)
    err = decode_errors(torch, tt, params, cfg, seq, full, kind=kind)
    rec = dict(gate_limit=limit, gate_err=err, gate_err_in_limits=err / limit,
               max_abs_logit=top, decode_positions=seq.shape[-1 if kind ==
                                                            "codebooks" else 1]
               - GATE_PREFILL)
    for name, kw in controls.items():
        rec[f"control_{name}_in_limits"] = decode_errors(
            torch, tt, params, cfg, seq, full, kind=kind, **kw) / limit
    if not err <= limit:
        fail(f"{what}: decode differs from the full forward by {err} > "
             f"{limit}")
    for name in controls:
        if not rec[f"control_{name}_in_limits"] > 1.0:
            fail(f"{what}: the decode gate passes its control_{name} ({rec})")
    return rec


def decode_bound(torch, rt, params, cfg, batch, max_len, *, cache=None,
                 routed_elems=None):
    """Bytes a decode step must move (each input read once, each output
    written once): every layer's weights, the final norm and the untied
    head, the batch's embedding rows, the cache (``cache``'s tensors, or
    GQA's K and V at ``max_len``), the logits; and its bf16 operations (2
    per weight and token; with ``routed_elems``, the layers' expert-bank
    elements a token's routed experts hold, the banks count only those)."""
    leaves = rt.core.utils.tree_leaves(params["layers"])
    esz = params["embed"]["head"]["w"].element_size()
    layer_bytes = sum(x.numel() * x.element_size() for x in leaves)
    layer_elems = sum(x.numel() for x in leaves)
    head = params["embed"]["head"]["w"].numel()
    if cache is None:
        kv = (2 * cfg.n_layers * batch * max_len * cfg.kv_heads
              * cfg.head_dim * esz)
    else:
        kv = sum(t.numel() * t.element_size() for k, t in cache.items()
                 if k != "length")
    logits = batch * cfg.vocab * max(cfg.n_codebooks, 1)
    nbytes = (layer_bytes + kv + (head + cfg.d_model + batch * cfg.d_model
                                  + logits) * esz)
    if routed_elems is not None:
        banks = sum(params["layers"]["moe"][k].numel()
                    for k in ("gate", "up", "down"))
        layer_elems = layer_elems - banks + routed_elems
    flops = 2.0 * (layer_elems + head) * batch
    ms, by = bound(flops, nbytes, "bfloat16")
    return dict(bytes=nbytes, weight_bytes=layer_bytes + head * esz,
                flops=flops, bound_ms=ms, bound_by=by)


def serving_generation(torch, rt, kernels, card, dev):
    """Phase 12a: Qwen3-14B at full width and all 40 layers, bf16: the
    launcher's batch generation, timed prefill and decode steps, and the
    decode gate against the full forward with its two controls.  Generation
    is plain PyTorch (the reference's is plain jnp): fails if any kernel
    launched in this phase."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tt
    from repro_torch.serving import greedy_generate

    cfg = rt.get_config("qwen3-14b")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch_serve.main(["--arch", "qwen3-14b", "--device", dev.type])
    launcher_s = time.perf_counter() - t0
    if tuple(out.shape) != (GEN_BATCH, GEN_NEW) or \
            not bool(((out >= 0) & (out < cfg.vocab)).all()):
        fail(f"serving: the launcher generated {tuple(out.shape)} tokens "
             f"out of range")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = rt.model_init(cfg, 0, device=dev)
    prompts = rt.core.rng.randint(rt.core.rng.prng_key(1),
                                  (GEN_BATCH, GEN_PROMPT), 0, cfg.vocab,
                                  device=dev).to(torch.int32)
    greedy_generate(params, cfg, prompts, 2)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = greedy_generate(params, cfg, prompts, GEN_NEW).cpu()
    gen_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not torch.equal(gen, out):
        fail("serving: greedy_generate disagrees with the launcher's run "
             "of the same seed")
    # prefill and the decode steps, each timed on its own
    max_len = GEN_PROMPT + GEN_NEW
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tt.model_prefill(params, cfg, {"tokens": prompts},
                                         max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks = logits[:, -1].argmax(-1)
        t0 = time.perf_counter()
        for _ in range(GEN_NEW - 1):
            logits, cache = tt.model_decode(params, cfg, toks, cache)
            toks = logits.argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (GEN_NEW - 1)
        last = dict(cache, length=cache["length"] - 1)

        def steps():                 # the last position, decoded again
            for _ in range(PROFILE_DECODE_STEPS):
                tt.model_decode(params, cfg, toks, last)

        prof = device_profile(torch, steps, PROFILE_DECODE_STEPS)
    del logits, cache, last
    bnd = decode_bound(torch, rt, params, cfg, GEN_BATCH, max_len)
    # the gate: teacher-forced decode against the full forward
    seq = prompts
    with torch.no_grad():
        full = tt.model_forward(params, cfg, {"tokens": seq})
    gate = decode_gate(torch, tt, params, cfg, seq, full, "serving")
    rec = dict(
        layers=cfg.n_layers, batch=GEN_BATCH, prompt=GEN_PROMPT,
        new_tokens=GEN_NEW, launcher_s=launcher_s, generate_s=gen_s,
        tok_per_s=GEN_BATCH * GEN_NEW / gen_s, prefill_ms=prefill_ms,
        decode_ms_per_step=decode_ms, decode_profile=prof,
        peak_mem_gb=peak_gb, decode_bound=bnd,
        decode_bound_share=bnd["bound_ms"] / decode_ms, **gate,
        sample=gen[0, :16].tolist(), launches=kernels.launch_counts(),
        card=card)
    print(json.dumps({"serving_generation": rec}), flush=True)
    if any(rec["launches"].values()):
        fail(f"serving: generation launched kernels {rec['launches']}")
    del params, full
    torch.cuda.empty_cache()
    return rec


def serving_online(torch, rt, kernels, card, dev):
    """Phase 12b: the online service over Qwen3-14B at SERVE_LAYERS
    layers with the fused central trimmer: the trimmer's first steps
    C̃-gated against the plain route, counted trim steps (29 tensor-core
    pair launches and one window update a step; predict launches none),
    then a background-thread run."""
    from repro_torch.launch.serve import corpus_tokens
    from repro_torch.serving import ServiceConfig, TrimConfig

    cfg = rt.get_config("qwen3-14b").replace(n_layers=SERVE_LAYERS)
    params = rt.model_init(cfg, 0, device=dev)

    def predict_fn(p, batch):
        return rt.model_forward(p, cfg, {"tokens": batch["tokens"]})[:, -1]

    def loss_fn(p, batch):
        return rt.model_loss(p, cfg, batch)

    dcfg = rt.DriverConfig(mode="central", fused=True, dtheta=1e-2,
                           eta=1e-2)
    trim = TrimConfig(dcfg, loss_fn,
                      probe_fn=rt.make_transformer_probe_fn(cfg))
    svc_cfg = ServiceConfig(slots=SERVE_SLOTS, batch_window_s=0.002,
                            replay_capacity=1024, trim_batch=SERVE_SLOTS,
                            min_fill=2 * SERVE_SLOTS, publish_every=10)
    corpus = corpus_tokens(0, 8, GEN_PROMPT + 1, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def feed(svc, rounds=1):
        futs = [svc.submit({"tokens": corpus[j % 8, :GEN_PROMPT]},
                           feedback={"labels": corpus[j % 8, 1:]})
                for j in range(8 * rounds)]
        return [f.result(timeout=120) for f in futs]

    svc = rt.serve(svc_cfg, predict_fn, params, trim=trim, start=False)
    svc.start(background_trim=False)
    try:
        kernels.reset_launch_counts()
        feed(svc)
        served = kernels.launch_counts()
        if any(served.values()):
            fail(f"serving: predict launched kernels {served}")
        # the trimmer's own steps against the plain route, same state
        ref = rt.driver("discrete", dcfg.replace(kernel_impl="ref"),
                        loss_fn, probe_fn=rt.make_transformer_probe_fn(cfg),
                        device=dev)
        other = rt.driver("discrete", dcfg.replace(seed=1), loss_fn,
                          probe_fn=rt.make_transformer_probe_fn(cfg),
                          device=dev)
        cts, plain, others, costs = [], [], [], []
        for _ in range(SERVE_CT_STEPS):
            tr = svc.trimmer
            b = svc.replay.sample(svc_cfg.trim_batch, tr.global_step,
                                  seed=svc_cfg.seed)
            b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            plain.append(ref.step(tr.params, tr.state, b)[2]["c_tilde"]
                         .item())
            others.append(other.step(tr.params, tr.state, b)[2]["c_tilde"]
                          .item())
            svc.trim(1)
            st = tr.stats()
            cts.append(st["aux_c_tilde"])
            costs.append(st["aux_cost"])
        n = SERVE_CT_GATED
        gate = ct_gate_record(cts[:n], plain[:n], others[:n], costs[:n],
                              "serving trimmer")
        controls_each_step(gate, plain, others, costs, n, "serving trimmer")
        tols = [LM_CT_REL * abs(c) for c in costs]
        gate.update(
            c_tilde_gated_steps=n,
            c_tilde_ungated=dict(
                c_tilde=cts[n:], plain=plain[n:], other_seed=others[n:],
                costs=costs[n:], err_in_tols=[
                    abs(v - p) / t for v, p, t in
                    zip(cts[n:], plain[n:], tols[n:])]))
        del ref, other, b
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if svc.trim(SERVE_MAIN_STEPS) != SERVE_MAIN_STEPS:
            fail("serving: the trimmer skipped steps")
        torch.cuda.synchronize()
        trim_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        expected = lm_expected(SERVE_LAYERS, "central", SERVE_MAIN_STEPS)
        if counts != expected:
            fail(f"serving: trim launches {counts} != expected {expected}")
        by_route = check_routes(kernels, counts, "tc", "serving trimmer")
        sync_stats = svc.stats()
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    # the threads: dispatcher and trainer on one card
    with rt.serve(svc_cfg, predict_fn, params, trim=trim) as bg:
        t0 = time.perf_counter()
        rounds = 0
        while time.perf_counter() - t0 < SERVE_BACKGROUND_S:
            feed(bg)
            rounds += 1
        bg.fence()
        wall = time.perf_counter() - t0
        stats = bg.stats()
    if stats["trim_global_step"] < 1 or stats["served"] != 8 * rounds:
        fail(f"serving: background run served {stats['served']} of "
             f"{8 * rounds}, trimmed {stats['trim_global_step']} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = dict(
        layers=SERVE_LAYERS, slots=SERVE_SLOTS, **gate,
        trim_steps_per_s_sync=SERVE_MAIN_STEPS / trim_s,
        launches=counts, launches_by_kernel=by_route,
        last_cost_sync=sync_stats.get("trim_aux_cost"),
        background_s=wall, served=stats["served"],
        publishes=stats["version"], trim_steps=stats["trim_global_step"],
        trim_steps_per_s=stats["trim_global_step"] / wall,
        requests_per_s=stats["served"] / wall,
        latency_p50_ms=stats["latency_p50_ms"],
        latency_p99_ms=stats["latency_p99_ms"], peak_mem_gb=peak_gb,
        card=card)
    print(json.dumps({"serving_online": rec}), flush=True)
    del params
    torch.cuda.empty_cache()
    return rec, counts


def serving_mlp(torch, card, dev):
    """Phase 12c: the online-serving bench's MLP service on the card: the
    torn-swap hammer and serve → trim → checkpoint → restore → trim."""
    import tempfile

    from repro_torch.benchmarks import online_serving as bench

    t0 = time.perf_counter()
    torn = bench.torn_swap_hammer(HAMMER_REQUESTS, dev)
    hammer_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        exact = bench.resume_bitexact(0, tmp, dev)
    rec = dict(torn_swaps=torn, hammer_requests=HAMMER_REQUESTS,
               hammer_s=hammer_s, resume_bitexact=exact, card=card)
    print(json.dumps({"serving_mlp": rec}), flush=True)
    if torn:
        fail(f"serving: {torn} torn swaps under the publish hammer")
    if exact != 1.0:
        fail("serving: serve→trim→resume is not bitwise the uninterrupted "
             "run")
    return rec


# -- phase 13: the attention families -----------------------------------------

FAM_BATCH, FAM_SEQ = 8, 64     # launch/train.py's batch
FAM_CT_STEPS = 2               # steps C̃-gated against the plain route
# of them, the steps at which both controls must miss: the first, where the
# cost is at its start.  The gate resolves C̃ to 2⁻¹¹ of the cost (~6e-3),
# and a later step's C̃ (or another seed's) can land within that of 0 (or
# of the plain C̃) by chance: at the second step on an H100, mistral-nemo's
# C̃ read 0.76 of the limit from 0 and qwen2-vl's other seed 0.21 from the
# plain C̃.  Later steps' control readings are printed.
FAM_CONTROL_STEPS = 1
FAM_MAIN_STEPS = 2             # counted steps, kernel route only
TRIO = ("mistral-nemo-12b", "granite-34b", "qwen2-72b")
TRIO_LAYERS = 1
MOE_LAYERS = 2                 # llama4-scout: the depth 80 GB leaves room for
MOE_GATE_STEPS = 3             # B3 against its plain version, bitwise
MOE_MAIN_STEPS = 2
MOE_PEAK_GB = 80.0
MLA_LAYERS = 1                 # deepseek-v3: one layer is 23 GB of weights
MLA_DECODE_STEPS = 16          # timed decode steps (bf16)
# the MoE decode gates run in f32 with the capacity raised so that nothing
# can drop: in bf16 the decode and the full forward round the attention
# output apart by an ulp, which moves router logits by ~1e-3 and flips
# near-tied routings (a different expert, a different logit); in f32 the
# two forms differ by the order of f32 sums only (K ≤ 16,384 products:
# ~√K·2⁻²⁴ ≈ 8e-6 of a value at worst), so 2⁻¹⁶ of max|logit| holds them,
# and one bf16 rounding on the path (2⁻⁹) would miss it
MOE_DECODE_REL = 2.0 ** -16
MOE_DECODE_CF = {"llama4-scout-17b-a16e": 16.0,    # C = 512 = the group
                 "deepseek-v3-671b": 32.0}        # C = 128 = the group


def family_sampler(torch, rt, cfg, dev, seed=0):
    """Batches of FAM_BATCH × FAM_SEQ for ``cfg``: VLM patch embeddings
    (normal, in the model's dtype) with M-RoPE positions [B, S, 3] (each
    in [0, S)) from a seed, and the LM stream's labels (text follows the
    Zipf-Markov law; uniform labels would leave C̃ within a few gate
    tolerances of 0, where a control can pass by chance); codebook tokens
    [B, nq, S] with labels [B, S, nq] as ``launch/train.py`` draws them;
    tokens otherwise."""
    from repro_torch.launch.train import codebook_sampler

    if cfg.family == "vlm":
        text = rt.lm_sampler(FAM_BATCH, FAM_SEQ, cfg.vocab, seed=seed,
                             device=dev)

        def sample(i):
            g = torch.Generator(device=dev).manual_seed(seed * 100003 + i)
            emb = torch.randn((FAM_BATCH, FAM_SEQ, cfg.d_model),
                              generator=g, device=dev).to(cfg.torch_dtype)
            pos = torch.randint(0, FAM_SEQ, (FAM_BATCH, FAM_SEQ, 3),
                                generator=g, device=dev, dtype=torch.int32)
            return {"embeds": emb, "positions": pos,
                    "labels": text(i)["labels"]}
        return sample
    nq = max(cfg.n_codebooks, 1)
    sample = rt.lm_sampler(FAM_BATCH * nq, FAM_SEQ, cfg.vocab, seed=seed,
                           device=dev)
    return codebook_sampler(sample, nq) if cfg.n_codebooks else sample


def window_launches(params):
    """Window-update launches one update of ``params`` makes: one for each
    run of up to 64 ndim ≥ 2 leaves of a dtype."""
    from repro_torch.core.utils import tree_leaves
    from repro_torch.kernels import mgd_update

    by_dtype = {}
    for leaf in tree_leaves(params):
        if leaf.dim() >= 2:
            by_dtype[leaf.dtype] = by_dtype.get(leaf.dtype, 0) + 1
    return sum(-(-n // mgd_update.MAX_LEAVES) for n in by_dtype.values())


def counted_steps(torch, rt, kernels, drv, params, state, sample, steps,
                  expected, route, what, start=0, recorder=None):
    """``steps`` kernel-route steps with the launch counters zeroed before
    them; fails unless they equal ``expected``.  Returns (params, state,
    record)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_s, costs = [], []
    for n in range(start, start + steps):
        t0 = time.perf_counter()
        params, state, aux = drv.step(params, state, sample(n))
        costs.append(aux["cost"].item())
        step_s.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    if counts != expected:
        fail(f"{what}: launches {counts} != expected {expected}")
    by_route = check_routes(kernels, counts, route, what) if route else \
        kernels.route_launch_counts()
    if not all(math.isfinite(c) for c in costs):
        fail(f"{what}: a cost went non-finite")
    return params, state, dict(s_per_step=step_s, costs=costs,
                               launches=counts, launches_by_kernel=by_route)


def fused_family(torch, rt, kernels, card, dev, arch, n_layers=None,
                 decode_kind=None):
    """13a, 13b, 13e: ``arch`` at full width (``n_layers`` layers, all when
    None), bf16, fused central: the C̃ gate near the start, then counted
    steps (7 tensor-core pair launches a layer and the head's, one window
    update); with ``decode_kind`` the decode gate on a batch's inputs."""
    from repro_torch.models import transformer as tt

    cfg = rt.get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    what = f"{arch} ({cfg.n_layers} layers)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p0 = rt.model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in rt.core.utils.tree_leaves(p0))
    params_gb = torch.cuda.memory_allocated() / 1e9
    sample = family_sampler(torch, rt, cfg, dev)
    params, state, drv, gate = c_tilde_gate(
        torch, rt, cfg, dev, sample, p0, dict(mode="central"),
        steps=FAM_CT_STEPS, what=what)
    controls_each_step(gate, gate["c_tilde_first_plain"],
                       gate["c_tilde_first_other_seed"], gate["first_costs"],
                       FAM_CONTROL_STEPS, what)
    del p0
    expected = lm_expected(cfg.n_layers, "central", FAM_MAIN_STEPS)
    expected["mgd_update_window"] *= window_launches(params)
    params, state, main = counted_steps(
        torch, rt, kernels, drv, params, state, sample, FAM_MAIN_STEPS,
        expected, "tc", what, start=FAM_CT_STEPS)
    rec = dict(arch=arch, layers=cfg.n_layers, params=n_params,
               params_gb=params_gb, init_s=init_s, **gate, **main,
               pair_launches_per_step=7 * cfg.n_layers + 1)
    del params, state, drv
    torch.cuda.empty_cache()
    if decode_kind:
        params = rt.model_init(cfg, 0, device=dev)
        b = sample(0)
        seq = {"embeds": b.get("embeds"), "codebooks": b.get("tokens"),
               "tokens": b.get("tokens")}[decode_kind]
        key = "embeds" if decode_kind == "embeds" else "tokens"
        with torch.no_grad():
            full = tt.model_forward(params, cfg, {key: seq})
        rec["decode_gate"] = decode_gate(torch, tt, params, cfg, seq, full,
                                         f"{what} decode", kind=decode_kind)
        del params, full
    rec.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=card)
    print(json.dumps({"family": rec}), flush=True)
    torch.cuda.empty_cache()
    return rec


def tree_equal(torch, a, b):
    from repro_torch.core.utils import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def window_gate_step(torch, kernels, drvs, params, state, batch, windows,
                     what, watch=contextlib.nullcontext):
    """One kernel-route step of a materializing probe (drivers ``drvs`` =
    kernel route, plain route, kernel route with another seed), probed
    from the same params, state and batch by all three: fails unless the
    window-update kernel's params and C̃ equal the plain route's bitwise,
    another seed's update differs, and the step launched ``windows``
    window updates and no perturbed matmul.  ``watch()`` is a context
    manager around the kernel step alone.  Returns (params, state,
    record, what ``watch`` yielded)."""
    drv, ref, other = drvs
    p_plain, _, aux_plain = ref.step(params, state, batch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with watch() as seen:
        p_k, s_k, aux = drv.step(params, state, batch)
        ct = aux["c_tilde"].item()
    step_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    same = tree_equal(torch, p_k, p_plain)
    ct_plain = aux_plain["c_tilde"].item()
    del p_plain
    p_o, _, aux_o = other.step(params, state, batch)
    differs = not tree_equal(torch, p_o, p_k)
    ct_other = aux_o["c_tilde"].item()
    del p_o
    rec = dict(c_tilde=ct, c_tilde_plain=ct_plain, c_tilde_other_seed=ct_other,
               cost=aux["cost"].item(), params_bitwise_plain=same,
               control_other_seed_differs=differs, s_per_step=step_s,
               launches=counts)
    if ct != ct_plain or not same:
        fail(f"{what}: the window-update kernel's params or C̃ differ from "
             f"the plain route's ({rec})")
    if not differs:
        fail(f"{what}: another seed's update equals this one's")
    if counts["perturbed_matmul"] or counts["perturbed_matmul_pair"] or \
            counts["mgd_update_window"] != windows:
        fail(f"{what} launched {counts}, expected no perturbed matmul and "
             f"{windows} window updates")
    return p_k, s_k, rec, seen


def theta_tree_time(torch, rt, pert, params, step):
    """Seconds of one sign's θ + θ̃ over ``params`` (the materializing
    probe's hash passes) and its bytes bound (each element read once and
    written once)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = pert.perturbed_tree(params, step=step, seed=0, dtheta=1e-2)
    torch.cuda.synchronize()
    theta_s = time.perf_counter() - t0
    tree_bytes = 2 * sum(x.numel() * x.element_size()
                         for x in rt.core.utils.tree_leaves(tree))
    return theta_s, bound(0.0, tree_bytes)[0]


def moe_decode_gate(torch, rt, tt, cfg, dev, seed, what):
    """The decode gate of an MoE model in f32 at the capacity factor at
    which nothing drops (MOE_DECODE_CF): prefill, teacher-forced decode
    against the full forward within MOE_DECODE_REL of max|logit|, and both
    controls missing it."""
    cfg32 = cfg.replace(dtype="float32",
                        moe_capacity_factor=MOE_DECODE_CF[cfg.name])
    params = rt.model_init(cfg32, seed, device=dev)
    toks = family_sampler(torch, rt, cfg32, dev, seed=seed)(0)["tokens"]
    with torch.no_grad():
        full = tt.model_forward(params, cfg32, {"tokens": toks})
    rec = decode_gate(torch, tt, params, cfg32, toks, full, what,
                      rel=MOE_DECODE_REL)
    rec.update(dtype="float32",
               capacity_factor=cfg32.moe_capacity_factor)
    del params, full
    torch.cuda.empty_cache()
    return rec


def moe_family(torch, rt, kernels, card, dev):
    """13c: llama4-scout at full width, MOE_LAYERS layers, bf16, fused
    central: materialized probes (no perturbed-matmul launch) and the
    window-update kernel over every matrix leaf, the rank-4 expert banks
    included; the first MOE_GATE_STEPS steps against the plain update from
    the same state, bitwise, with another seed's update as the control,
    the drop share of every step; then the f32 decode gate."""
    from repro_torch.core import perturbations as pert
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tt

    cfg = rt.get_config("llama4-scout-17b-a16e").replace(
        n_layers=MOE_LAYERS)
    what = f"llama4-scout ({cfg.n_layers} layers)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rt.model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in rt.core.utils.tree_leaves(params))
    bank_elems = params["layers"]["moe"]["gate"].numel()
    params_gb = torch.cuda.memory_allocated() / 1e9
    sample = family_sampler(torch, rt, cfg, dev)
    drvs = (lm_driver(rt, cfg, dev, mode="central"),
            lm_driver(rt, cfg, dev, "ref", mode="central"),
            lm_driver(rt, cfg, dev, seed=1, mode="central"))
    drv = drvs[0]
    state = drv.init(params)
    gate_steps = []
    windows = window_launches(params)
    for n in range(MOE_GATE_STEPS):
        params, state, rec, rec_drops = window_gate_step(
            torch, kernels, drvs, params, state, sample(n), windows,
            f"{what}: step {n}", watch=tmoe.DropRecorder)
        routed, dropped = rec_drops.totals()
        rec["drop_share"] = dropped / routed
        gate_steps.append(rec)
    expected = dict(perturbed_matmul=0, perturbed_matmul_pair=0,
                    mgd_update_window=windows * MOE_MAIN_STEPS, mgd_update=0)
    with tmoe.DropRecorder() as rec_drops:
        params, state, main = counted_steps(
            torch, rt, kernels, drv, params, state, sample, MOE_MAIN_STEPS,
            expected, None, what, start=MOE_GATE_STEPS)
    routed, dropped = rec_drops.totals()
    peak_train_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_train_gb >= MOE_PEAK_GB:
        fail(f"{what}: peak {peak_train_gb:.2f} GB")
    # where a step's time goes: the device's share, and one sign's
    # perturbed tree (θ + θ̃ formed in the hash's eager int64 ops) alone
    n = MOE_GATE_STEPS + MOE_MAIN_STEPS
    prof = device_profile(torch, lambda: drv.step(params, state, sample(n)),
                          1)
    theta_s, theta_bound_ms = theta_tree_time(torch, rt, pert, params, n)
    del params, state, drv, drvs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dgate = moe_decode_gate(torch, rt, tt, cfg, dev, 0, f"{what} decode")
    rec = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
               params_gb=params_gb, bank_elems=bank_elems, init_s=init_s,
               gate_steps=gate_steps, **main,
               drop_share_main=dropped / routed, window_launches_per_step=
               windows, step_profile=prof, perturbed_tree_s=theta_s,
               perturbed_tree_bound_ms=theta_bound_ms,
               peak_mem_gb=peak_train_gb, decode_gate=dgate,
               decode_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=card)
    print(json.dumps({"moe": rec}), flush=True)
    return rec


def mla_family(torch, rt, kernels, card, dev):
    """13d: deepseek-v3 at full width, MLA_LAYERS layer, bf16, serving
    only (an MGD step's params, perturbed copy and update output would be
    3 × 26.7 GB): the forward of a batch with its drop share, prefill and
    timed absorbed-form decode steps beside their bytes bound, an
    ungated bf16 reading of decode against the forward; then the f32
    decode gate.  Launches no kernel."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tt

    cfg = rt.get_config("deepseek-v3-671b").replace(n_layers=MLA_LAYERS)
    what = f"deepseek-v3 ({cfg.n_layers} layer)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    params = rt.model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in rt.core.utils.tree_leaves(params))
    params_gb = torch.cuda.memory_allocated() / 1e9
    toks = family_sampler(torch, rt, cfg, dev)(0)["tokens"]
    with torch.no_grad():
        with tmoe.DropRecorder() as rec_drops:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = tt.model_forward(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            forward_ms = (time.perf_counter() - t0) * 1e3
        routed, dropped = rec_drops.totals()
        if not bool(torch.isfinite(full).all()):
            fail(f"{what}: non-finite logits")
        max_len = GATE_PREFILL + MLA_DECODE_STEPS + 1
        logits, cache = tt.model_prefill(
            params, cfg, {"tokens": toks[:, :GATE_PREFILL]}, max_len)
        nxt = logits[:, -1].argmax(-1)
        tt.model_decode(params, cfg, nxt, cache)           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MLA_DECODE_STEPS):
            lg, cache = tt.model_decode(params, cfg, nxt, cache)
            nxt = lg.argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / MLA_DECODE_STEPS
        last = dict(cache, length=cache["length"] - 1)
        prof = device_profile(
            torch, lambda: tt.model_decode(params, cfg, nxt, last), 1)
        routed_elems = (3 * cfg.d_model * cfg.d_ff * cfg.n_experts_active
                        * cfg.n_layers)
        bnd = decode_bound(torch, rt, params, cfg, FAM_BATCH, max_len,
                           cache=cache, routed_elems=routed_elems)
        del cache, last, logits
        # bf16: decode against the forward at cf 1.25, read and not gated
        bf16_err = decode_errors(torch, tt, params, cfg, toks, full)
    top = full.float().abs().max().item()
    del params, full
    counts = kernels.launch_counts()
    if any(counts.values()):
        fail(f"{what}: serving launched kernels {counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dgate = moe_decode_gate(torch, rt, tt, cfg, dev, 0, f"{what} decode")
    rec = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
               params_gb=params_gb, init_s=init_s, forward_ms=forward_ms,
               drop_share=dropped / routed, decode_ms_per_step=decode_ms,
               decode_profile=prof, decode_bound=bnd,
               decode_bound_share=bnd["bound_ms"] / decode_ms,
               bf16_decode_err_in_8_ulps=bf16_err / (GATE_ULPS
                                                     * bf16_ulp(top)),
               peak_mem_gb=peak_gb, decode_gate=dgate,
               decode_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts, card=card)
    print(json.dumps({"mla": rec}), flush=True)
    torch.cuda.empty_cache()
    return rec


def family_summary(out):
    """Phase 13's gates and speeds, one entry a sub-phase and model."""
    def fused(rec):
        return dict(
            arch=rec["arch"], layers=rec["layers"],
            s_per_step=rec["s_per_step"], peak_mem_gb=rec["peak_mem_gb"],
            launches=rec["launches"],
            c_tilde_err_in_tols=rec["c_tilde_err_in_tols"],
            controls_in_tols=(rec["control_zero_err_in_tols_per_step"],
                              rec["control_other_seed_err_in_tols_per_step"]
                              ),
            decode=({k: rec["decode_gate"][k] for k in (
                "gate_err_in_limits", "control_length_short_in_limits",
                "control_zeroed_last_in_limits")}
                if "decode_gate" in rec else None))

    moe, mla = out["13c"], out["13d"]
    decode_keys = ("gate_err_in_limits", "control_length_short_in_limits",
                   "control_zeroed_last_in_limits", "gate_limit")
    return {
        "13a": fused(out["13a"]), "13b": fused(out["13b"]),
        "13c": dict(layers=moe["layers"], s_per_step=moe["s_per_step"],
                    perturbed_tree_s=moe["perturbed_tree_s"],
                    device_busy_share=moe["step_profile"][
                        "device_busy_share"],
                    peak_mem_gb=moe["peak_mem_gb"],
                    window_bitwise_plain=[g["params_bitwise_plain"]
                                          for g in moe["gate_steps"]],
                    drop_share=[g["drop_share"] for g in moe["gate_steps"]]
                    + [moe["drop_share_main"]], launches=moe["launches"],
                    decode={k: moe["decode_gate"][k] for k in decode_keys}),
        "13d": dict(layers=mla["layers"], forward_ms=mla["forward_ms"],
                    drop_share=mla["drop_share"],
                    decode_ms_per_step=mla["decode_ms_per_step"],
                    decode_bound_ms=mla["decode_bound"]["bound_ms"],
                    peak_mem_gb=mla["peak_mem_gb"],
                    decode={k: mla["decode_gate"][k] for k in decode_keys}),
        "13e": [fused(r) for r in out["13e"]],
        "seconds": out["seconds"]}


def attention_families(torch, rt, kernels, card, dev):
    """Phase 13: 13a qwen2-vl-2b and 13b musicgen-medium at full width and
    depth, 13c llama4-scout (MoE), 13d deepseek-v3 (MLA + MoE), 13e the
    dense trio at one layer each.  Returns (records, launch totals)."""
    out, secs = {}, {}
    totals = {name: 0 for name in SOURCES}
    t0 = time.perf_counter()
    out["13a"] = fused_family(torch, rt, kernels, card, dev, "qwen2-vl-2b",
                              decode_kind="embeds")
    secs["13a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["13b"] = fused_family(torch, rt, kernels, card, dev,
                              "musicgen-medium", decode_kind="codebooks")
    secs["13b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["13c"] = moe_family(torch, rt, kernels, card, dev)
    secs["13c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["13d"] = mla_family(torch, rt, kernels, card, dev)
    secs["13d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["13e"] = [fused_family(torch, rt, kernels, card, dev, arch,
                               n_layers=TRIO_LAYERS) for arch in TRIO]
    secs["13e"] = time.perf_counter() - t0
    for rec in (out["13a"], out["13b"], out["13c"], *out["13e"]):
        for k, v in rec["launches"].items():
            totals[k] += v
    out["seconds"] = secs
    return out, totals


# -- phase 14: the recurrent families ------------------------------------------

REC_ARCHS = ("rwkv6-7b", "zamba2-7b")
REC_GATE_STEPS = 3             # B3 against its plain version, bitwise
REC_MAIN_STEPS = 2             # counted steps, through make_epoch
REC_PEAK_GB = 80.0
# 14a: card against CPU in f32 (smoke configs).  Both sum each f32 product
# in their own order (cuBLAS, the CPU's GEMM; the chunked recurrence's
# einsums), ~2⁻²⁴·√K of a value apart a layer; 2⁻¹⁶ of max|logit| (and of
# each step's cost for C̃; their sum for params, since η/Δθ = 1 moves a
# parameter by C̃ a step) leaves them ~30× room, and TF32's 2⁻¹¹ misses it
REC_CPU_STEPS = 2
REC_CPU_REL = 2.0 ** -16
REC_RECURRENCE_ATOL = 2e-3     # chunked against the step recurrence (twin)
# 14d: the f32 decode gate, as the MoE gates of phase 13 (the two forms
# differ by the order of f32 sums, and the chunked recurrence's)
REC_DECODE_REL = 2.0 ** -16
# RWKV-6 at this init amplifies rounding with depth: moving every input
# embedding by one f32 ulp moves its logits by 0.4 of that limit at 2
# layers and 50× it at 32 (d 256, this PR's CPU measurement), so no two
# f32 computations of the 32-layer model can agree within it.  Its gate
# runs at full width and this depth; the full depth's decode error and
# one-ulp reading are printed beside it.  zamba2 (0.4× at 81 layers) is
# gated at full depth.
REC_GATE_LAYERS = {"rwkv6-7b": 1}


@contextlib.contextmanager
def tf32_allowed(torch):
    """TF32 on for cuBLAS matmuls and cuDNN (a control), off after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def recurrent_card_vs_cpu(torch, rt, dev):
    """14a: each recurrent smoke config (f32) on the card against the CPU
    from the same params and batches (launch/train.py's 8 × 64, the LM
    stream): forward logits, then REC_CPU_STEPS fused central steps (C̃,
    params), as fractions of their limits; the same on the card with TF32
    allowed must miss.  Then the chunked recurrences on the card against
    their own step recurrences."""
    from repro_torch.core.utils import tree_leaves, tree_map
    from repro_torch.models import transformer as tt

    cpu_dev = torch.device("cpu")
    out = {}
    for arch in REC_ARCHS:
        cfg = rt.get_smoke_config(arch)
        p0 = rt.model_init(cfg, 0, device=cpu_dev)
        sample = rt.lm_sampler(FAM_BATCH, FAM_SEQ, cfg.vocab, seed=0,
                               device=cpu_dev)
        batches = [sample(i) for i in range(REC_CPU_STEPS)]

        def run(where):
            params = tree_map(lambda t: t.to(where), p0)
            with torch.no_grad():
                logits = tt.model_forward(params, cfg, {
                    "tokens": batches[0]["tokens"].to(where)}).cpu()
            drv = lm_driver(rt, cfg, where, mode="central")
            state = drv.init(params)
            cts, costs = [], []
            for b in batches:
                params, state, aux = drv.step(
                    params, state, tree_map(lambda t: t.to(where), b))
                cts.append(aux["c_tilde"].item())
                costs.append(aux["cost"].item())
            return logits, cts, costs, [t.cpu() for t in tree_leaves(params)]

        logits, cts, costs, leaves = run(cpu_dev)
        ct_limits = [REC_CPU_REL * abs(c) for c in costs]

        def in_limits(card):
            return dict(
                logits=(card[0] - logits).abs().max().item()
                / (REC_CPU_REL * logits.abs().max().item()),
                c_tilde=max(abs(a - b) / lim
                            for a, b, lim in zip(card[1], cts, ct_limits)),
                params=max((a - b).abs().max().item()
                           for a, b in zip(card[3], leaves))
                / sum(ct_limits))

        rec = dict(c_tilde_cpu=cts, costs_cpu=costs,
                   gaps_in_limits=in_limits(run(dev)))
        with tf32_allowed(torch):
            rec["tf32_control_in_limits"] = in_limits(run(dev))
        out[arch] = rec
        if not all(v <= 1.0 for v in rec["gaps_in_limits"].values()):
            fail(f"{arch} (smoke, f32): card against CPU beyond the limits "
                 f"({rec})")
        if not max(rec["tf32_control_in_limits"].values()) > 1.0:
            fail(f"{arch} (smoke, f32): the card-vs-CPU gate passes its TF32 "
                 f"control ({rec})")
    out["recurrence"] = chunked_vs_recurrence(torch, dev)
    print(json.dumps({"recurrent_card_vs_cpu": out}), flush=True)
    return out


def chunked_vs_recurrence(torch, dev):
    """The card's chunked recurrences against their own single-token steps
    over 64 tokens, within REC_RECURRENCE_ATOL (the twin of the
    reference's tests: its shapes and chunks, then rwkv6's and zamba2's
    head widths at their chunks, batch 8)."""
    from repro_torch.models import linear_attention as la

    g = torch.Generator(device=dev).manual_seed(0)
    cases = [("vector", 2, 2, 8, 12, c) for c in (8, 16, 64)] + \
        [("scalar", 2, 2, 8, 12, c) for c in (8, 32)] + \
        [("vector", FAM_BATCH, 64, 64, 64, 32),
         ("scalar", FAM_BATCH, 112, 64, 64, 64)]
    out = []
    for kind, b, h, dk, dv, chunk in cases:
        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev)

        q, k, v = rand(b, FAM_SEQ, h, dk), rand(b, FAM_SEQ, h, dk), \
            rand(b, FAM_SEQ, h, dv)
        st = torch.zeros((b, h, dk, dv), device=dev)
        ys = []
        if kind == "vector":
            lw, u = -torch.exp(rand(b, FAM_SEQ, h, dk)), rand(h, dk)
            y, s_fin = la.chunked_vector_decay(q, k, v, lw, u, chunk=chunk)
            for t in range(FAM_SEQ):
                yt, st = la.step_vector_decay(q[:, t], k[:, t], v[:, t],
                                              lw[:, t], u, st)
                ys.append(yt)
        else:
            lw = -torch.exp(rand(b, FAM_SEQ, h)) * 0.5
            y, s_fin = la.chunked_scalar_decay(q, k, v, lw, chunk=chunk)
            for t in range(FAM_SEQ):
                yt, st = la.step_scalar_decay(q[:, t], k[:, t], v[:, t],
                                              lw[:, t], st)
                ys.append(yt)
        err = max((y - torch.stack(ys, 1)).abs().max().item(),
                  (s_fin - st).abs().max().item())
        out.append(dict(kind=kind, shape=[b, FAM_SEQ, h, dk, dv], chunk=chunk,
                        max_abs_err=err))
        if not err <= REC_RECURRENCE_ATOL:
            fail(f"chunked {kind} decay at {out[-1]} leaves its step "
                 f"recurrence by more than {REC_RECURRENCE_ATOL}")
    return out


def recurrent_training(torch, rt, kernels, card, dev, arch):
    """14b, 14c: ``arch`` at full width and depth, bf16, fused central
    through ``driver`` and ``make_epoch``: the probes materialize θ ± θ̃
    (no perturbed-matmul launch) and B3 updates every ndim ≥ 2 leaf, one
    launch a dtype (bf16 and f32).  REC_GATE_STEPS steps bitwise the plain
    update (another seed's differs), REC_MAIN_STEPS counted steps, peak
    memory, the device's busy share of one step, one sign's θ ± θ̃ against
    its bytes bound."""
    from repro_torch.core import perturbations as pert

    cfg = rt.get_config(arch)
    what = f"{arch} ({cfg.n_layers} layers)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rt.model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in rt.core.utils.tree_leaves(params))
    params_gb = torch.cuda.memory_allocated() / 1e9
    sample = family_sampler(torch, rt, cfg, dev)
    drvs = (lm_driver(rt, cfg, dev, mode="central"),
            lm_driver(rt, cfg, dev, "ref", mode="central"),
            lm_driver(rt, cfg, dev, seed=1, mode="central"))
    drv = drvs[0]
    state = drv.init(params)
    windows = window_launches(params)
    gate_steps = []
    for n in range(REC_GATE_STEPS):
        params, state, rec, _ = window_gate_step(
            torch, kernels, drvs, params, state, sample(n), windows,
            f"{what}: step {n}")
        gate_steps.append(rec)
    # the counted main path: make_epoch's steps, counters zeroed before
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    params, state, aux = rt.make_epoch(drv, REC_MAIN_STEPS, sample)(params,
                                                                    state)
    costs = aux["cost"].tolist()
    epoch_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = dict(perturbed_matmul=0, perturbed_matmul_pair=0,
                    mgd_update_window=windows * REC_MAIN_STEPS, mgd_update=0)
    if counts != expected:
        fail(f"{what}: launches {counts} != expected {expected}")
    if not all(math.isfinite(c) for c in costs):
        fail(f"{what}: a cost went non-finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= REC_PEAK_GB:
        fail(f"{what}: peak {peak_gb:.2f} GB")
    n = REC_GATE_STEPS + REC_MAIN_STEPS
    prof = device_profile(torch, lambda: drv.step(params, state, sample(n)),
                          1)
    theta_s, theta_bound_ms = theta_tree_time(torch, rt, pert, params, n)
    del params, state, drv, drvs
    torch.cuda.empty_cache()
    rec = dict(arch=arch, layers=cfg.n_layers, params=n_params,
               params_gb=params_gb, init_s=init_s, gate_steps=gate_steps,
               s_per_step=epoch_s / REC_MAIN_STEPS, costs=costs,
               launches=counts, window_launches_per_step=windows,
               step_profile=prof, perturbed_tree_s=theta_s,
               perturbed_tree_bound_ms=theta_bound_ms, peak_mem_gb=peak_gb,
               card=card)
    print(json.dumps({"recurrent_training": rec}), flush=True)
    return rec


def recurrent_decode_bound(rt, params, cfg, batch, cache):
    """Bytes a recurrent decode step must move (each input read once, each
    output written once): the stacked layers' weights, the hybrid's shared
    block (once, though 27 calls read it), the final norm and the head,
    the batch's embedding rows, the recurrent state read and written, the
    hybrid's K/V caches read, the logits; and its bf16 operations (2 per
    weight a call and token)."""
    from repro_torch.core.utils import tree_leaves
    from repro_torch.models import transformer as tt

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def numel(tree):
        return sum(t.numel() for t in tree_leaves(tree))

    esz = params["embed"]["head"]["w"].element_size()
    shared = params.get("shared_attn")
    weights = (nbytes(params["layers"]) + nbytes(shared)
               + nbytes(params["embed"]["head"])
               + nbytes(params["embed"]["ln_f"]))
    state = nbytes(cache["state"])
    kv = nbytes([cache[k] for k in ("k", "v") if k in cache])
    total = weights + 2 * state + kv + batch * (cfg.d_model + cfg.vocab) * esz
    calls = tt._hybrid_plan(cfg)[1] if shared is not None else 0
    flops = 2.0 * batch * (numel(params["layers"]) + calls * numel(shared)
                           + numel(params["embed"]["head"]))
    ms, by = bound(flops, total, "bfloat16")
    return dict(bytes=total, weight_bytes=weights, state_bytes=state,
                kv_bytes=kv, flops=flops, bound_ms=ms, bound_by=by)


def recurrent_controls(cfg):
    """The decode gate's controls of a recurrent model: rwkv6 the last
    layer's wkv state and its att_x token shift zeroed after prefill;
    zamba2 the last Mamba layer's conv tail zeroed after prefill, and the
    shared block's K/V at the last position zeroed before each step."""
    def zero(key):
        return dict(after_prefill=lambda c: c["state"][key][-1].zero_())

    if cfg.family == "ssm":
        return {"wkv_zeroed": zero("wkv"), "att_x_zeroed": zero("att_x")}
    return {"conv_tail_zeroed": zero("conv"),
            "zeroed_last": dict(zero_last=True)}


def one_ulp_gap(torch, tt, params, cfg, seq, full):
    """How far the full forward's logits move when every input embedding
    moves up by one ulp: the model's own amplification of rounding."""
    emb = params["embed"]["tok"]["table"][seq.long()]
    with torch.no_grad():
        moved = tt.model_forward(params, cfg, {"embeds": torch.nextafter(
            emb, torch.full_like(emb, math.inf))})
    return (moved.float() - full.float()).abs().max().item()


def recurrent_serving(torch, rt, kernels, card, dev, arch):
    """14d: ``arch`` at full depth, bf16: ``launch/serve.py``'s defaults
    (batch 4, prompt 32, 32 new tokens), prefill and decode steps timed
    alone beside the decode's bytes bound, tok/s and peak memory, a bf16
    reading of teacher-forced decode against the full forward (printed);
    then, the bf16 tree freed, the f32 decode gate (REC_DECODE_REL of
    max|logit|) with its two controls, at REC_GATE_LAYERS' depth where
    that names one (the full depth's decode error and one-ulp reading in
    f32 printed beside it).  Launches no kernel."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tt
    from repro_torch.serving import greedy_generate

    cfg = rt.get_config(arch)
    what = f"{arch} serving ({cfg.n_layers} layers)"
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch_serve.main(["--arch", arch, "--device", dev.type])
    launcher_s = time.perf_counter() - t0
    if tuple(out.shape) != (GEN_BATCH, GEN_NEW) or \
            not bool(((out >= 0) & (out < cfg.vocab)).all()):
        fail(f"{what}: the launcher generated {tuple(out.shape)} tokens out "
             f"of range")
    torch.cuda.empty_cache()
    params = rt.model_init(cfg, 0, device=dev)
    prompts = rt.core.rng.randint(rt.core.rng.prng_key(1),
                                  (GEN_BATCH, GEN_PROMPT), 0, cfg.vocab,
                                  device=dev).to(torch.int32)
    greedy_generate(params, cfg, prompts, 2)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = greedy_generate(params, cfg, prompts, GEN_NEW).cpu()
    gen_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not torch.equal(gen, out):
        fail(f"{what}: greedy_generate disagrees with the launcher's run of "
             f"the same seed")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tt.model_prefill(params, cfg, {"tokens": prompts},
                                         GEN_PROMPT + GEN_NEW)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks = logits[:, -1].argmax(-1)
        t0 = time.perf_counter()
        for _ in range(GEN_NEW - 1):
            logits, cache = tt.model_decode(params, cfg, toks, cache)
            toks = logits.argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (GEN_NEW - 1)

        def steps():                 # more steps from the same cache
            for _ in range(PROFILE_DECODE_STEPS):
                tt.model_decode(params, cfg, toks,
                                dict(cache, length=cache["length"] - 1))

        prof = device_profile(torch, steps, PROFILE_DECODE_STEPS)
        bnd = recurrent_decode_bound(rt, params, cfg, GEN_BATCH, cache)
        del logits, cache
        # bf16: teacher-forced decode against the forward, read, not gated
        seq = family_sampler(torch, rt, cfg, dev)(0)["tokens"]
        full = tt.model_forward(params, cfg, {"tokens": seq})
        bf16_err = decode_errors(torch, tt, params, cfg, seq, full)
        bf16_top = full.float().abs().max().item()
    del params, full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg32 = cfg.replace(dtype="float32")
    params = rt.model_init(cfg32, 0, device=dev)
    with torch.no_grad():
        full = tt.model_forward(params, cfg32, {"tokens": seq})
    limit = REC_DECODE_REL * full.abs().max().item()
    f32_full_depth = dict(
        layers=cfg.n_layers,
        decode_err_in_limits=decode_errors(torch, tt, params, cfg32, seq,
                                           full) / limit,
        one_ulp_input_in_limits=one_ulp_gap(torch, tt, params, cfg32, seq,
                                            full) / limit)
    if arch in REC_GATE_LAYERS:
        del params, full
        torch.cuda.empty_cache()
        cfg32 = cfg32.replace(n_layers=REC_GATE_LAYERS[arch])
        params = rt.model_init(cfg32, 0, device=dev)
        with torch.no_grad():
            full = tt.model_forward(params, cfg32, {"tokens": seq})
    gate = decode_gate(torch, tt, params, cfg32, seq, full,
                       f"{what} (f32, {cfg32.n_layers} layers)",
                       rel=REC_DECODE_REL, controls=recurrent_controls(cfg))
    gate.update(layers=cfg32.n_layers, one_ulp_input_in_limits=one_ulp_gap(
        torch, tt, params, cfg32, seq, full) / gate["gate_limit"])
    del params, full
    torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    if any(counts.values()):
        fail(f"{what}: serving launched kernels {counts}")
    rec = dict(arch=arch, layers=cfg.n_layers, batch=GEN_BATCH,
               prompt=GEN_PROMPT, new_tokens=GEN_NEW, launcher_s=launcher_s,
               generate_s=gen_s, tok_per_s=GEN_BATCH * GEN_NEW / gen_s,
               prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
               decode_profile=prof, decode_bound=bnd,
               decode_bound_share=bnd["bound_ms"] / decode_ms,
               peak_mem_gb=peak_gb,
               bf16_decode_err_in_f32_limits=bf16_err / (REC_DECODE_REL
                                                         * bf16_top),
               bf16_decode_err_in_8_ulps=bf16_err / (GATE_ULPS
                                                     * bf16_ulp(bf16_top)),
               decode_gate=gate, f32_full_depth=f32_full_depth,
               gate_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               sample=gen[0, :16].tolist(), launches=counts, card=card)
    print(json.dumps({"recurrent_serving": rec}), flush=True)
    return rec


def recurrent_summary(out):
    """Phase 14's gates and speeds, one entry a sub-phase and model."""
    def train(rec):
        return dict(layers=rec["layers"], s_per_step=rec["s_per_step"],
                    perturbed_tree_s=rec["perturbed_tree_s"],
                    perturbed_tree_bound_ms=rec["perturbed_tree_bound_ms"],
                    device_busy_share=rec["step_profile"][
                        "device_busy_share"],
                    peak_mem_gb=rec["peak_mem_gb"], launches=rec["launches"],
                    window_bitwise_plain=[g["params_bitwise_plain"]
                                          for g in rec["gate_steps"]])

    def serve(rec):
        gate = rec["decode_gate"]
        return dict(arch=rec["arch"], tok_per_s=rec["tok_per_s"],
                    prefill_ms=rec["prefill_ms"],
                    decode_ms_per_step=rec["decode_ms_per_step"],
                    decode_bound_ms=rec["decode_bound"]["bound_ms"],
                    peak_mem_gb=rec["peak_mem_gb"],
                    bf16_decode_err_in_f32_limits=rec[
                        "bf16_decode_err_in_f32_limits"],
                    decode={k: v for k, v in gate.items()
                            if k.endswith("_in_limits") or k == "layers"},
                    f32_full_depth=rec["f32_full_depth"])

    return {"14a": {k: v if k == "recurrence" else
                    dict(gaps=v["gaps_in_limits"],
                         tf32=v["tf32_control_in_limits"])
                    for k, v in out["14a"].items()},
            "14b": train(out["14b"]), "14c": train(out["14c"]),
            "14d": [serve(r) for r in out["14d"]], "seconds": out["seconds"]}


def recurrent_families(torch, rt, kernels, card, dev):
    """Phase 14: 14a card against CPU (smoke, f32) with its TF32 control
    and the chunked recurrences against their steps; 14b rwkv6-7b and 14c
    zamba2-7b trained at full width and depth; 14d both served.  Returns
    (records, launch totals of the counted steps)."""
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["14a"] = recurrent_card_vs_cpu(torch, rt, dev)
    secs["14a"] = time.perf_counter() - t0
    for sub, arch in zip(("14b", "14c"), REC_ARCHS):
        t0 = time.perf_counter()
        out[sub] = recurrent_training(torch, rt, kernels, card, dev, arch)
        secs[sub] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["14d"] = [recurrent_serving(torch, rt, kernels, card, dev, arch)
                  for arch in REC_ARCHS]
    secs["14d"] = time.perf_counter() - t0
    out["seconds"] = secs
    totals = {name: out["14b"]["launches"][name]
              + out["14c"]["launches"][name] for name in SOURCES}
    return out, totals


# -- phase 15: the bench twins ------------------------------------------------

BENCH_CT_STEPS = CT_CHECK_STEPS     # fused C̃ against the plain route, atol
# the rows that are arithmetic and their check_regression bands (a copy of
# the gate's TOLERANCES entries), held against artifacts/bench/<bench>.json
BENCH_PURE_ROWS = {
    "table3_hardware": (("*_seconds", 0.01),),
    "fused_probe": (("*_wread_ratio", 0.001),),
    "farm_scaling": (("projected_*", 0.01),),
    "scaling_laws": (("params_*", 0.001), ("projected_probe_budget_*", 0.01),
                     ("projected_step_s_*", 0.01)),
}


def pure_row_gate(bench, rows):
    """Every arithmetic row of ``bench`` within its band around the
    committed baseline's value; returns how many were held."""
    import fnmatch
    base_path = ROOT / "artifacts" / "bench" / f"{bench}.json"
    base = {r["name"]: float(r["value"])
            for r in json.loads(base_path.read_text())["rows"]}
    held = 0
    for r in rows:
        for pattern, rel in BENCH_PURE_ROWS[bench]:
            if fnmatch.fnmatch(r["name"], pattern):
                want = base[r["name"]]
                if not abs(float(r["value"]) - want) <= rel * abs(want):
                    fail(f"{bench}: {r['name']} = {r['value']} outside "
                         f"{rel} of the committed {want}")
                held += 1
                break
    if not held:
        fail(f"{bench}: no arithmetic row to hold against its baseline")
    return held


def fused_probe_expected(model, mode, steps, n_layers):
    if model == "transformer":
        return lm_expected(n_layers, mode, steps)
    per_step = 2                                   # two dense layers
    return dict(perturbed_matmul=per_step * steps if mode == "forward" else 0,
                perturbed_matmul_pair=(per_step * steps if mode == "central"
                                       else 0),
                mgd_update_window=steps, mgd_update=0)


def fused_probe_gates(torch, rt, fp, runs, dev):
    """15a's gates.  Each fused run made exactly the launches its path
    implies, all on the SIMT kernel (f32); the materializing runs launched
    nothing; each fused run passes ``fused_probe_ct``."""
    steps = fp.CHUNK + fp.STEPS
    n_layers = rt.get_smoke_config("qwen3-14b").n_layers
    out = {}
    for (model, mode, fused), rec in runs.items():
        name = f"{model}_{mode}_{'fused' if fused else 'materialized'}"
        want = (fused_probe_expected(model, mode, steps, n_layers) if fused
                else dict.fromkeys(SOURCES, 0))
        if rec["launches"] != want:
            fail(f"fused_probe {name}: launches {rec['launches']} != "
                 f"expected {want}")
        entry = dict(steps_per_s=rec["steps_per_s"], launches=rec["launches"])
        if fused:
            entry.update(fused_probe_ct(torch, rt, fp, model, mode, rec,
                                        dev, name))
        out[name] = entry
    return out


# the leaf of each fused_probe model whose every element the trajectory
# witness moves up by one ulp (C3's control moves one element of the
# reference's wq; in central mode θ ± θ̃ can round one element's ulp away)
BENCH_ULP_LEAF = {"mlp": lambda p: p[0]["w"],
                  "transformer": lambda p: p["layers"]["attn"]["wq"]["w"]}
# a fused run's whole-run C̃ gap may reach this many times its witness
# (the factor C6's test allows the port against the reference)
BENCH_TRAJ_FACTOR = 4.0


def fused_probe_ct(torch, rt, fp, model, mode, rec, dev, name):
    """The fused run ``rec``'s first BENCH_CT_STEPS steps, run again, each
    from the kernel route's params and state.  Every step: the kernel's
    C̃ equals the twin's run bitwise and lies within CT_ATOL of the plain
    route's from the same state, which both controls (C̃ = 0, another
    seed's signs) miss; and B3's updated params equal, bitwise on every
    leaf, the plain update of the same params, seeds and C̃, which
    another seed's plain update misses.  Then the trajectory: the twin's
    C̃ against the plain route's run from the same init (on the card),
    held to CT_ATOL for the MLP.  The witness is how far the plain route
    moves from its own run over the same steps when one leaf moves up by
    one ulp, or when it runs on the CPU; where the witness exceeds
    CT_ATOL (the transformer at η/Δθ = 10), the gap is held to
    BENCH_TRAJ_FACTOR times the witness, else to CT_ATOL."""
    from repro_torch.core import mgd
    from repro_torch.core.utils import tree_map
    params, batch, loss, probe_fn = fp.SETUPS[model](dev)

    def config(impl, seed=0):
        return rt.DriverConfig(mode=mode, dtheta=1e-3, eta=1e-2, seed=seed,
                               fused=True, kernel_impl=impl)

    def make(impl, seed=0, device=dev):
        return rt.driver("discrete", config(impl, seed), loss,
                         probe_fn=probe_fn, device=device)

    kern, plain, other = make(None), make("ref"), make(None, 1)
    ref_cfg = dataclasses.replace(kern.config, kernel_impl="ref")
    other_cfg = dataclasses.replace(ref_cfg, seed=1)
    p, s = params, kern.init(params)
    cts, plain_cts, other_cts = [], [], []
    for _ in range(BENCH_CT_STEPS):
        plain_cts.append(plain.step(p, s, batch)[2]["c_tilde"])
        other_cts.append(other.step(p, s, batch)[2]["c_tilde"])
        n = s.step
        p_k, s, aux = kern.step(p, s, batch)
        cts.append(aux["c_tilde"])
        if not tree_equal(torch, p_k, mgd.fused_update_tau1(
                ref_cfg, p, n, aux["c_tilde"])):
            fail(f"fused_probe {name} step {n}: the window-update kernel's "
                 "params differ from the plain update of the same params, "
                 "seeds and C̃")
        if tree_equal(torch, p_k, mgd.fused_update_tau1(
                other_cfg, p, n, aux["c_tilde"])):
            fail(f"fused_probe {name} step {n}: another seed's plain update "
                 "equals the kernel's")
        p = p_k
    cts, plain_cts, other_cts = (torch.stack(v) for v in
                                 (cts, plain_cts, other_cts))
    if not torch.equal(cts, rec["c_tilde"][:BENCH_CT_STEPS]):
        fail(f"fused_probe {name}: the rerun's C̃ differ from the twin's "
             "run on the same route")
    err = (cts - plain_cts).abs().max().item()
    controls = dict(zero=plain_cts.abs().max().item(),
                    other_seed=(other_cts - plain_cts).abs().max().item())
    if not err <= CT_ATOL:
        fail(f"fused_probe {name}: C̃ from the same state differ from the "
             f"plain route by {err} > {CT_ATOL}")
    for control, miss in controls.items():
        if not miss > CT_ATOL:
            fail(f"fused_probe {name}: the C̃ gate passes its {control} "
                 f"control ({miss} <= {CT_ATOL})")

    def plain_run(p0, b, device=dev):
        drv = make("ref", device=device)
        return rt.make_epoch(drv, BENCH_CT_STEPS, lambda i: b)(
            p0, drv.init(p0))[2]["c_tilde"].to(dev)

    def on_cpu(tree):
        return tree_map(lambda x: x.cpu(), tree)

    base = plain_run(params, batch)
    moved = tree_map(lambda x: x.clone(), params)
    leaf = BENCH_ULP_LEAF[model](moved)
    leaf.copy_(torch.nextafter(leaf, torch.full_like(leaf, math.inf)))
    ulp_gap = (plain_run(moved, batch) - base).abs().max().item()
    cpu_gap = (plain_run(on_cpu(params), on_cpu(batch), torch.device("cpu"))
               - base).abs().max().item()
    witness = max(ulp_gap, cpu_gap)
    traj = (rec["c_tilde"][:BENCH_CT_STEPS] - base).abs().max().item()
    limit = (CT_ATOL if model == "mlp" or witness <= CT_ATOL
             else BENCH_TRAJ_FACTOR * witness)
    if not traj <= limit:
        fail(f"fused_probe {name}: first {BENCH_CT_STEPS} C̃ differ from "
             f"the plain route's run by {traj} > {limit} (witness: one "
             f"ulp {ulp_gap}, the CPU {cpu_gap})")
    return dict(c_tilde_max_abs_err_vs_plain_same_state=err,
                controls_max_abs_err=controls,
                b3_bitwise_plain_steps=BENCH_CT_STEPS,
                c_tilde_max_abs_err_vs_plain_run=traj,
                witness_one_ulp=ulp_gap, witness_plain_cpu=cpu_gap,
                trajectory_limit=limit)


TWIN_ROUNDS = 8             # phase 15's cut calls: variance rounds
TWIN_STEPS = 100            # convergence / accuracy steps
TWIN_THROUGHPUT_KS = (1, 4)  # the farm's throughput sweep


def bench_twins(torch, rt, kernels, card, dev, out_dir):
    """Phase 15: the four bench twins on the card: ``fused_probe`` whole,
    ``table3_hardware``, and cut calls of ``farm_scaling``'s and
    ``scaling_laws``' own row functions (TWIN_ROUNDS rounds, TWIN_STEPS
    steps, the throughput sweep at TWIN_THROUGHPUT_KS; their smoke
    budgets are 24-30 rounds and 300 steps), each driven with the launch
    counters zeroed before it and read after.  Fatal: a twin raises; the
    bitmatch row is not 1.0; an arithmetic row leaves its band around the
    committed baseline; a fused_probe launch count, C̃ or B3 gate misses.
    Each twin's seconds are its own run's, before its gates.  The
    statistical, accuracy and timing rows are printed, not gated here.
    Returns (records, launch totals)."""
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import farm_scaling as fs
    from repro_torch.benchmarks import fused_probe as fp
    from repro_torch.benchmarks import scaling_laws as sl
    from repro_torch.benchmarks import table3_hardware as t3

    out, totals = {}, dict.fromkeys(SOURCES, 0)

    def drive(bench, fn, checks=None, seed=None, smoke=False, record=True):
        """Times ``fn() -> rows`` alone (its seconds are the twin's), then
        runs ``checks(rows, launch counts) -> extra record``; writes the
        rows as a bench record where ``record`` (a twin run at a budget
        of its own)."""
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rows = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()        # the main path's, alone
        for k, v in counts.items():
            totals[k] += v
        extra = checks(rows, counts) if checks else {}
        held = pure_row_gate(bench, rows)
        for r in rows:
            print(json.dumps({"bench_row": bench, "name": r["name"],
                              "value": r["value"]}), flush=True)
        if out_dir is not None and record:
            common.write_record(str(out_dir), bench, rows, seconds, seed,
                                "cuda", smoke)
        out[bench] = dict(seconds=seconds, launches=counts,
                          arithmetic_rows_held=held, card=card,
                          rows={r["name"]: r["value"] for r in rows}, **extra)
        print(json.dumps({"phase15": bench, "seconds": seconds,
                          "launches": counts}), flush=True)

    runs = {}

    def fused_probe():
        found, _ = fp.measure(dev)
        runs.update(found)
        return fp.rows_of(found, dev)

    def fused_probe_checks(rows, counts):
        for name in kernels.MATMUL_WRAPPERS + ("mgd_update_window",):
            if not counts[name]:
                fail(f"phase 15: fused_probe launched no {name}")
        by_route = check_routes(kernels, counts, "simt",
                                "phase 15 fused_probe")
        return dict(runs=fused_probe_gates(torch, rt, fp, runs, dev),
                    launches_by_kernel=by_route)

    def bitmatch(rows, counts):
        bit = next(r["value"] for r in rows
                   if r["name"] == "mesh_farm_bitmatch_f32")
        if bit != 1.0:
            fail(f"scaling_laws: mesh_farm_bitmatch_f32 = {bit}, not 1.0")
        return {}

    drive("fused_probe", fused_probe, fused_probe_checks)
    drive("table3_hardware", lambda: t3.run(device=dev))
    def farm_cut():
        ks = fs.SMOKE_KS
        return (fs._variance_rows(ks, TWIN_ROUNDS, 0, dev)
                + fs._convergence_rows(ks, TWIN_STEPS, 0, 1, dev)
                + fs._latency_rows(ks)
                + fs._throughput_rows(TWIN_THROUGHPUT_KS, True, dev))

    def scaling_cut():
        rows = sl._variance_rows(TWIN_ROUNDS, 0, dev)
        n_rows, var_by_n = sl._variance_vs_n_rows(TWIN_ROUNDS, 0, dev)
        return (rows + n_rows + sl._accuracy_rows(TWIN_STEPS, 0, dev)
                + sl._bitmatch_rows(dev) + sl._projection_rows(var_by_n))

    drive("farm_scaling", farm_cut, seed=0, record=False)
    drive("scaling_laws", scaling_cut, bitmatch, seed=0, record=False)
    return out, totals


# -- phase 16: the paper's figure benches -------------------------------------

# 16a's plant kinds: hardware_plants' XOR devices, by row name
PLANT_KINDS = ("ideal", "sigma_c_1e-3", "sigma_theta_0.1", "sigma_a_0.15",
               "dac8", "dac8_tauw4", "adc8_round", "adc8_stoch")
FIG_GATE_STEPS = 200        # card steps, each repeated on the CPU
FIG_RATE_STEPS = 50         # steps timed a kind and device
FIG_STEPS = 100             # 16b's XOR budgets: max_steps, iters
FIG_CHUNK = 50
FIG_NIST_STEPS = 100        # _nist_accuracy's steps and chunk
FIG_WRITES = 25             # _bound_ratio's writes (τ_θ = 8: 200 steps)
FIG_ANGLE_ITERS = 1000      # fig5's checkpoints 100 and 1000
# 16a's update gate, card vs CPU from the same state: a C̃ gap moves each
# param by η/Δθ = 100 times it (θ ← θ − η·C̃·s/Δθ), plus the f32 rounding
# of |θ| ≲ 8; where the writes land on a DAC grid, bitwise
FIG_UPDATE_GAIN = 1.0 / 1e-2
FIG_PARAM_ATOL = 1e-6
WITNESS_BUMP = 1.0 + 2.0 ** -20     # layer 0's W, the witness's init


def to_device(torch, tree, dev):
    """``tree`` (params, a batch, an ``MGDState``) with its tensors on
    ``dev``; host ints stay as they are."""
    from repro_torch.core.utils import tree_map
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                    else x, tree)


def timed_steps(torch, rt, drv, dev, steps):
    """Steps/s of ``steps`` steps of ``drv`` on XOR (batch 1) from the
    port's seed-0 init, through ``make_epoch``."""
    from repro_torch.benchmarks.common import sync
    from repro_torch.data import tasks
    from repro_torch.data.pipeline import dataset_sampler
    x, y = tasks.xor_dataset(device=dev)
    p = rt.mlp_init(0, (2, 2, 1), device=dev)
    run = rt.make_epoch(drv, steps, dataset_sampler(x, y, 1))
    state = drv.init(p)
    sync(dev)
    t0 = time.perf_counter()
    p, state, aux = run(p, state)
    sync(dev)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(aux["cost"]).all()):
        fail(f"phase 16: a cost went non-finite on {dev}")
    return steps / dt


def plant_kind_gate(torch, rt, hp, kind, dev):
    """16a for one plant kind: FIG_GATE_STEPS steps of the XOR row's driver
    (Δθ = 1e-2, η = 1, batch 1, seed 0) on the card, each repeated on the
    CPU from the card's params, state and batch; C̃ within CT_ATOL at every
    step, and the update (the DAC's quantize and clip, τ_w's slow write,
    σ_θ's write noise) within FIG_UPDATE_GAIN × that step's C̃ gap +
    FIG_PARAM_ATOL, bitwise on a DAC.  Then the steps/s of each device's
    driver alone."""
    from repro_torch.core.utils import tree_leaves
    from repro_torch.data import tasks
    from repro_torch.data.pipeline import dataset_sampler
    cpu = torch.device("cpu")
    drvs = []
    for where in (dev, cpu):
        plant, mode = hp.xor_plant(kind, 0, where)
        drvs.append(rt.driver("discrete", rt.DriverConfig(
            dtheta=1e-2, eta=1.0, mode=mode), None, plant=plant,
            device=where))
    drv, ref = drvs
    on_grid = getattr(plant, "bits", None) is not None
    x, y = tasks.xor_dataset(device=dev)
    sample = dataset_sampler(x, y, 1)
    p = rt.mlp_init(0, (2, 2, 1), device=dev)
    s = drv.init(p)
    ct_gap = p_gap = 0.0
    differ = 0
    for step in range(FIG_GATE_STEPS):
        b = sample(s.step)
        p_ref, _, a_ref = ref.step(*(to_device(torch, t, cpu)
                                     for t in (p, s, b)))
        p, s, aux = drv.step(p, s, b)
        ct = abs(aux["c_tilde"].item() - a_ref["c_tilde"].item())
        gap = max((a.cpu() - r).abs().max().item()
                  for a, r in zip(tree_leaves(p), tree_leaves(p_ref)))
        limit = 0.0 if on_grid else FIG_UPDATE_GAIN * ct + FIG_PARAM_ATOL
        if not gap <= limit:
            fail(f"phase 16 {kind}: the update at step {step} on the card "
                 f"against the CPU's from the same state differs by {gap} > "
                 f"{limit} (C̃ gap {ct})")
        differ += int(ct > 0 or gap > 0)
        ct_gap, p_gap = max(ct_gap, ct), max(p_gap, gap)
        if not bool(torch.isfinite(aux["cost"])):
            fail(f"phase 16 {kind}: a cost went non-finite")
    if not ct_gap <= CT_ATOL:
        fail(f"phase 16 {kind}: C̃ on the card against the CPU from the "
             f"same state differ by {ct_gap} > {CT_ATOL}")
    return dict(steps=FIG_GATE_STEPS, c_tilde_max_gap=ct_gap,
                c_tilde_limit=CT_ATOL, param_max_gap=p_gap,
                param_limit="bitwise" if on_grid else
                f"{FIG_UPDATE_GAIN:g} x C̃ gap + {FIG_PARAM_ATOL:g}",
                steps_differing=differ,
                card_steps_per_s=timed_steps(torch, rt, drv, dev,
                                             FIG_RATE_STEPS),
                cpu_steps_per_s=timed_steps(torch, rt, ref, cpu,
                                            FIG_RATE_STEPS))


def fig_draw_checks(torch, rt, hp, dev):
    """The devices' draws on the card bitwise the CPU's: σ_C readout noise,
    σ_θ writes (which must move the params), the stochastic ADC's codes and
    the σ_a defects."""
    from repro_torch.core.utils import tree_leaves
    from repro_torch.hardware import mlp_device_fns
    cpu = torch.device("cpu")

    def pair(kind):
        return (hp.xor_plant(kind, 0, dev)[0],
                hp.xor_plant(kind, 0, cpu)[0])

    checked = dict.fromkeys(("sigma_c", "sigma_theta", "adc_stochastic",
                             "sigma_a"), 0)
    pc, ph = pair("sigma_c_1e-3")
    zc, zh = torch.zeros((), device=dev), torch.zeros(())
    for step in range(4):
        for tag in range(2):
            if not torch.equal(pc._noisy(zc, step, tag).cpu(),
                               ph._noisy(zh, step, tag)):
                fail(f"phase 16: σ_C readout at ({step}, {tag}) differs "
                     "between the card and the CPU")
            checked["sigma_c"] += 1
    pc, ph = pair("sigma_theta_0.1")
    p = rt.mlp_init(0, (2, 2, 1), device=dev)
    for step in (0, 1, 7):
        wc = tree_leaves(pc.write_params(p, step=step))
        wh = tree_leaves(ph.write_params(to_device(torch, p, cpu),
                                         step=step))
        if not all(torch.equal(a.cpu(), b) for a, b in zip(wc, wh)):
            fail(f"phase 16: σ_θ write at step {step} differs between the "
                 "card and the CPU")
        if all(torch.equal(a, b) for a, b in zip(wc, tree_leaves(p))):
            fail(f"phase 16: the σ_θ write at step {step} moved nothing")
        checked["sigma_theta"] += 1
    pc, ph = pair("adc8_stoch")
    for step in range(8):
        for tag in range(2):
            cost = 0.1234 + 0.01 * step
            a = pc._adc(torch.tensor(cost, device=dev), step, tag).cpu()
            if not torch.equal(a, ph._adc(torch.tensor(cost), step, tag)):
                fail(f"phase 16: the stochastic ADC's code at ({step}, "
                     f"{tag}) differs between the card and the CPU")
            checked["adc_stochastic"] += 1
    dc = mlp_device_fns((2, 2, 1), sigma_a=0.15, device_seed=0,
                        device=dev)[2]
    dh = mlp_device_fns((2, 2, 1), sigma_a=0.15, device_seed=0,
                        device=cpu)[2]
    for a, b in zip(tree_leaves(dc), tree_leaves(dh)):
        if not torch.equal(a.cpu(), b):
            fail("phase 16: the σ_a defects differ between the card and "
                 "the CPU")
        checked["sigma_a"] += 1
    return checked


@contextlib.contextmanager
def bumped_init(mods):
    """Every ``mlp_init`` of ``mods`` returns layer 0's W × WITNESS_BUMP:
    the witness's init."""
    from repro_torch.models.simple import mlp_init

    def bumped(seed, sizes, *, device=None):
        p = mlp_init(seed, sizes, device=device)
        p[0]["w"] = p[0]["w"] * WITNESS_BUMP
        return p

    saved = [(m, m.mlp_init) for m in mods]
    for m, _ in saved:
        m.mlp_init = bumped
    try:
        yield
    finally:
        for m, f in saved:
            m.mlp_init = f


def fig_calls(rt):
    """16b's cut calls of the twins' own per-run functions: name → (the
    modules whose ``mlp_init`` the call reads, fn(dev) → value, steps)."""
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import fig4_equivalence as f4
    from repro_torch.benchmarks import fig5_angle as f5
    from repro_torch.benchmarks import fig7_perturbations as f7
    from repro_torch.benchmarks import hardware_plants as hp
    from repro_torch.core import MGDConfig
    from repro_torch.data import tasks
    from repro_torch.data.pipeline import dataset_sampler

    def xor_device(kind):
        def call(dev):
            plant, mode = hp.xor_plant(kind, 0, dev)
            return common.time_to_solve_xor(
                rt.DriverConfig(dtheta=1e-2, eta=1.0, mode=mode), 0,
                max_steps=FIG_STEPS, chunk=FIG_CHUNK, plant=plant,
                device=dev)
        return (common,), call, FIG_STEPS

    def xor_cfg(cfg, plant_fn=None):
        def call(dev):
            return common.time_to_solve_xor(
                cfg, 0, max_steps=FIG_STEPS, chunk=FIG_CHUNK,
                plant=plant_fn(dev) if plant_fn else None, device=dev)
        return (common,), call, FIG_STEPS

    def nist(dev):
        plant, defects = hp._nist_plant(hp.NIST_DEVICES[1][1], {}, 0, dev)
        return hp._nist_accuracy(plant, defects, 0, steps=FIG_NIST_STEPS,
                                 chunk=FIG_NIST_STEPS, device=dev)

    def angles(dev):
        x, y = tasks.parity_dataset(2, device=dev)
        got = f5._angles((2, 2, 1), {"x": x, "y": y}, seeds=1,
                         iters=FIG_ANGLE_ITERS, device=dev)
        return [got[t] for t in sorted(got)]

    def fig10(dev):
        plant = rt.hardware.noisy_mlp_plant((2, 2, 1), sigma_a=0.25,
                                            device_seed=0, device=dev)
        x, y = tasks.xor_dataset(device=dev)
        _, steps, ok = common.train_until(
            None, common.mlp_init(0, (2, 2, 1), device=dev),
            MGDConfig(dtheta=1e-2, eta=1.0, seed=0),
            dataset_sampler(x, y, 1), max_steps=FIG_STEPS,
            threshold_fn=lambda p: float(plant.loss_fn(
                p, {"x": x, "y": y})) < 0.05,
            chunk=FIG_CHUNK, plant=plant, device=dev)
        return steps if ok else None

    def sigma_theta_plant(dev):
        return rt.hardware.noisy_mlp_plant((2, 2, 1), sigma_theta=0.1,
                                           dtheta=1e-2, device_seed=0,
                                           device=dev)

    calls = {f"hardware_plants_xor_{k}": xor_device(k)
             for k in ("ideal", "sigma_a_0.15", "dac8_tauw4", "adc8_stoch")}
    calls.update({
        "hardware_plants_nist7x7_noisy": ((hp,), nist, FIG_NIST_STEPS),
        "hardware_plants_bound_wtau4_tautheta8": (
            (hp,), lambda dev: hp._bound_ratio(4.0, 8, 0, writes=FIG_WRITES,
                                               device=dev), 8 * FIG_WRITES),
        "fig4_mgd_tau_100": ((f4,), lambda dev: f4._mgd_curve(
            100, 0, iters=FIG_STEPS, chunk=FIG_CHUNK, device=dev),
            FIG_STEPS),
        "fig4_backprop": ((f4,), lambda dev: f4._backprop_final(0, device=dev),
                          4000),
        "fig5_parity2_angles": ((f5,), angles, FIG_ANGLE_ITERS),
        "fig6_batch4_tau16": xor_cfg(MGDConfig(dtheta=1e-2, eta=0.5,
                                               tau_theta=16, tau_x=4)),
        "fig7_walsh": xor_cfg(f7.config("walsh")),
        "fig7_sinusoidal": xor_cfg(f7.config("sinusoidal")),
        "fig9_tau100_sigma_theta_0.1": xor_cfg(
            MGDConfig(dtheta=1e-2, eta=1.0 / 100, tau_theta=100),
            sigma_theta_plant),
        "fig10_sigma_a_0.25": ((common,), fig10, FIG_STEPS),
    })
    return calls


def fig_twin_calls(torch, rt, dev):
    """16b: each call on the card, then on the CPU; where the two differ,
    the witness: the CPU call again from layer 0's W × (1 + 2⁻²⁰)."""
    from repro_torch.benchmarks.common import sync
    cpu = torch.device("cpu")
    out = {}
    for name, (mods, call, steps) in fig_calls(rt).items():
        rec = dict(steps=steps)
        for where, key in ((dev, "card"), (cpu, "cpu")):
            sync(where)
            t0 = time.perf_counter()
            rec[key] = call(where)
            sync(where)
            rec[f"{key}_s"] = time.perf_counter() - t0
        if rec["card"] != rec["cpu"]:
            with bumped_init(mods):
                rec["witness_cpu"] = call(cpu)
        out[name] = rec
        print(json.dumps({"phase16_call": name, **rec}), flush=True)
    return out


FIG_TWINS = ("hardware_plants", "fig4_equivalence", "fig5_angle",
             "fig6_tau_theta", "fig7_perturbations", "fig8_noise")

# the 16b calls whose steps/s stand for a kind of step in the whole budgets
FIG_RATE_CALLS = {"nist": "hardware_plants_nist7x7_noisy",
                  "bound_ratio": "hardware_plants_bound_wtau4_tautheta8",
                  "fig4_tau100": "fig4_mgd_tau_100",
                  "backprop": "fig4_backprop",
                  "angle": "fig5_parity2_angles",
                  "fig9_tau100": "fig9_tau100_sigma_theta_0.1"}


def rate_kind(plant, cfg):
    """The 16a plant kind whose steps/s a training run on ``plant`` under
    ``cfg`` goes at (fig9's τ_θ = 100 through σ_θ: its 16b call's)."""
    if plant is None:
        return "ideal"
    meta = plant.meta
    if meta.adc_bits:
        return ("adc8_stoch" if plant.adc_mode == "stochastic"
                else "adc8_round")
    if meta.weight_bits:
        return "dac8_tauw4" if plant.write_tau else "dac8"
    if meta.write_noise:
        return ("fig9_tau100" if (cfg.tau_theta or 1) > 1
                else "sigma_theta_0.1")
    if meta.cost_noise:
        return "sigma_c_1e-3"
    return "sigma_a_0.15" if meta.sigma_a else "ideal"


def dry_run(name):
    """The runs twin ``name``'s own ``run()`` makes at its whole budget,
    without training: ``train_until`` (the twin's and ``common``'s, which
    ``time_to_solve_xor`` calls) and the per-run functions that train on
    their own replaced by recorders that report a run which did not solve.
    Returns (rows, runs): each run dict(fn, steps, chunk, kind), in call
    order."""
    import importlib
    import inspect
    import types
    from repro_torch.benchmarks import common
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    runs = []

    def train_until(loss_fn, params, cfg, sample_fn, *, max_steps,
                    threshold_fn, chunk=2000, plant=None, **kw):
        runs.append(dict(fn="train_until", steps=max_steps, chunk=chunk,
                         kind=rate_kind(plant, cfg)))
        return params, max_steps, False

    def recorder(fn, steps_of, result):
        sig = inspect.signature(fn)

        def record(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            steps, kind = steps_of(args.arguments)
            runs.append(dict(fn=fn.__name__, steps=steps, chunk=None,
                             kind=kind))
            return result(args.arguments)
        return record

    patches = [(common, "train_until", train_until)]
    if hasattr(mod, "train_until"):
        patches.append((mod, "train_until", train_until))
    for attr, steps_of, result in (
            ("_nist_accuracy", lambda a: (a["steps"], "nist"),
             lambda a: 0.0),
            ("_bound_ratio", lambda a: (a["writes"] * a["tau_theta"],
                                        "bound_ratio"), lambda a: 0.0),
            ("_mgd_curve", lambda a: (a["iters"], "ideal" if a["tau"] == 1
                                      else "fig4_tau100"), lambda a: 0.0),
            ("train_backprop", lambda a: (a["num_steps"], "backprop"),
             lambda a: types.SimpleNamespace(params=a["params"])),
            ("_angles", lambda a: (a["seeds"] * a["iters"], "angle"),
             lambda a: {t: 0.0 for t in mod.CHECKPOINTS})):
        if hasattr(mod, attr):
            patches.append((mod, attr, recorder(getattr(mod, attr),
                                                steps_of, result)))
    saved = [(m, attr, getattr(m, attr)) for m, attr, _ in patches]
    try:
        for m, attr, f in patches:
            setattr(m, attr, f)
        rows = mod.run(device="cpu")
    finally:
        for m, attr, f in saved:
            setattr(m, attr, f)
    return rows, runs


def whole_budget_steps():
    """Each twin's whole budget in steps of each rate kind, from a dry run
    of its own ``run()``.  Where a committed baseline exists
    (``hardware_plants``, ``fig8_noise``), each outcome row's runs (its
    seeds' ``train_until`` calls, in call order) are the baseline's: a "k/N
    solved" row's k runs at its median, a converged fraction's solved runs
    at their first check (the chunk: the baseline keeps no steps), the rest
    at the budget; elsewhere, and for a row the baseline lacks, a run that
    can stop early counts its budget (``upper_bound``)."""
    import importlib
    out = {}
    for name in FIG_TWINS:
        rows, runs = dry_run(name)
        n_seeds = importlib.import_module(
            f"repro_torch.benchmarks.{name}").N_SEEDS
        path = ROOT / "artifacts" / "bench" / f"{name}.json"
        base = ({r["name"]: r for r in json.loads(path.read_text())["rows"]}
                if path.exists() else None)
        steps = [r["steps"] for r in runs]
        upper = base is None and any(r["fn"] == "train_until" for r in runs)
        if base is not None:
            queue = [i for i, r in enumerate(runs) if r["fn"] == "train_until"]
            for row in rows:
                # the runs an outcome row reads: N of "k/N solved", N_SEEDS
                # of a converged fraction
                n = (int(row["detail"].split("/")[1].split()[0])
                     if "solved" in row["detail"] else
                     n_seeds if row["name"].endswith("_converged") else 0)
                mine, queue = queue[:n], queue[n:]
                b = base.get(row["name"])
                upper |= bool(n) and b is None
                if b is None or not n:
                    continue
                if "solved" in b["detail"]:
                    k, at = int(b["detail"].split("/")[0]), b["value"]
                else:
                    k, at = round(b["value"] * n), None
                for i in mine[:k]:
                    steps[i] = at if at is not None else runs[i]["chunk"]
            if queue:
                raise RuntimeError(f"{name}: {len(queue)} runs matched no "
                                   "outcome row of the dry run")
        kinds = {}
        for r, n in zip(runs, steps):
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + n
        out[name] = dict(kinds, upper_bound=upper)
    return out


def whole_budget_seconds(steps, rates):
    """Projected seconds of each twin's whole budget at ``rates`` (steps/s
    by kind: the plant kinds', and those of 16b's calls in
    FIG_RATE_CALLS)."""
    return {bench: dict(seconds=sum(n / rates[k] for k, n in kinds.items()
                                    if k != "upper_bound"),
                        upper_bound=kinds["upper_bound"])
            for bench, kinds in steps.items()}


def paper_figures(torch, rt, kernels, card, dev):
    """Phase 16: the paper's figure benches (``hardware_plants``,
    ``fig4_equivalence`` … ``fig8_noise``) on the card, with the launch
    counters zeroed before and read after.  16a: each of hardware_plants'
    XOR plant kinds, the card's C̃ against the CPU's from the same state at
    every step, the devices' draws bitwise, steps/s on both.  16b: cut
    calls of the twins' own functions on the card and the CPU, printed
    side by side (with a witness where they differ).  16c: the
    ``*_projected_s`` rows equal the committed baseline's exactly.  Fatal:
    a kernel launched, a C̃ gap, a draw or a projection that differs, a
    twin that raises.  Returns the record."""
    from repro_torch.benchmarks import hardware_plants as hp
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plants = {kind: plant_kind_gate(torch, rt, hp, kind, dev)
              for kind in PLANT_KINDS}
    for kind, rec in plants.items():
        print(json.dumps({"phase16_plant": kind, **rec}), flush=True)
    draws = fig_draw_checks(torch, rt, hp, dev)
    t_a = time.perf_counter()
    calls = fig_twin_calls(torch, rt, dev)
    t_b = time.perf_counter()
    base = {r["name"]: r["value"] for r in json.loads(
        (ROOT / "artifacts" / "bench" / "hardware_plants.json").read_text()
        )["rows"]}
    projections = {r["name"]: r["value"] for r in hp.projection_rows()}
    for name, value in projections.items():
        if value != base[name]:
            fail(f"phase 16: {name} = {value!r}, the committed baseline "
                 f"{base[name]!r}")
    counts = kernels.launch_counts()
    if any(counts.values()):
        fail(f"phase 16: the figure benches launched kernels: {counts}")
    rates = {k: v["card_steps_per_s"] for k, v in plants.items()}
    cpu_rates = {k: v["cpu_steps_per_s"] for k, v in plants.items()}
    for kind, call in FIG_RATE_CALLS.items():
        rec = calls[call]
        rates[kind] = rec["steps"] / rec["card_s"]
        cpu_rates[kind] = rec["steps"] / rec["cpu_s"]
    steps = whole_budget_steps()
    out = dict(plants=plants, draws=draws, calls=calls,
               projections=projections, launches=counts,
               card_steps_per_s=rates, cpu_steps_per_s=cpu_rates,
               whole_budget_steps=steps,
               whole_budget_seconds_card=whole_budget_seconds(steps, rates),
               whole_budget_seconds_cpu=whole_budget_seconds(steps,
                                                              cpu_rates),
               seconds={"16a": t_a - t0, "16b": t_b - t_a,
                        "16c": time.perf_counter() - t_b}, card=card)
    print(json.dumps({"phase16_rates": dict(card=rates, cpu=cpu_rates)}),
          flush=True)
    print(json.dumps({"phase16_whole_budget": dict(
        steps=steps, card_s=out["whole_budget_seconds_card"],
        cpu_s=out["whole_budget_seconds_cpu"])}), flush=True)
    return out


def kernel_device_us(profiles):
    """Device µs per launch of each kernel on the main path (profiler)."""
    found = {}
    for prof in profiles.values():
        for name, us in prof["kernel_us_per_launch"].items():
            found.setdefault(name, us)
    return found


# -- phase 17: distribution ----------------------------------------------------

DRY_ARCH, DRY_SHAPE = "qwen3-14b", "train_4k"
DRY_DEVICE = "cuda"         # the fake tensors' device
# 17a's flops gate: the counted flops are model_flops' matmul terms
# exactly (every weight's 2·M·N·K, the head included, the embedding a
# gather) plus the causal attention, which the port's masked attention
# computes at 36 of 64 (q, kv) block pairs at S = 4096 where the formula
# takes S²/2: +12.5 % of the attention term, ~0.7 % of the step.  The CPU
# run of the same cell (full depth) gave a ratio of 1.00704.
DRY_RATIO = (1.0, 1.02)
DIST_LAYERS = LM_LAYERS     # 17b's model: phase 5's 4 layers
DIST_STEPS = 3              # unfused central and forward, each
DIST_PP_MLP_STEPS = 8
DIST_PP_LM_STEPS = 3
QUANT_SHAPE = (5120, 17408)
PHASE17_TIMEOUT_S = 600
# 17c: each kernel on the blocks a (2, 2) mesh would give a leaf: the
# LM's gate/up leaf in bf16 (the tensor-core route) and a SIMT f32 one
BLOCK_CASES = [((LM_TOKENS, 5120, 17408), "bfloat16"),
               ((256, 1024, 768), "float32")]
BLOCK_WINDOW = 4            # J of the update kernels' blocks
SHARDED_FUSED_STEPS = 3     # 17c.2: fused central and forward, each
# 17c.3: the families on the one-rank mesh, at full width and at most
# phases 13-14's depth (zamba2: one group, 2 Mamba-2 blocks + the shared
# block); their MGD step is the unfused one, but DeepSeek-V3's: its three
# trees (params, θ̃, θ ± θ̃) are 78 GB at one layer (phase 13d), so it
# takes the fused step, which probes by materializing one θ ± θ̃ at a
# time and updates through the window update on its shards
FAMILY_MESH = {"llama4-scout-17b-a16e": 1, "deepseek-v3-671b": 1,
               "rwkv6-7b": 2, "zamba2-7b": 3}
FAMILY_MESH_FUSED = ("deepseek-v3-671b",)


def dryrun_cell(torch):
    """Phase 17a (its own process): Qwen3-14B train_4k on the (16, 16)
    fake mesh, fake CUDA tensors, nothing allocated."""
    from repro_torch.distributed.world import close_world, fake_world
    from repro_torch.launch import dryrun, roofline, specs
    from repro_torch.configs import get_config
    fake_world(256)
    t0 = time.perf_counter()
    try:
        rec = dryrun.run_cell(DRY_ARCH, DRY_SHAPE, multi_pod=False,
                              out_dir=None, device_type=DRY_DEVICE,
                              verbose=False)
    finally:
        close_world()
    cfg = get_config(DRY_ARCH)
    n_params = dryrun.count_params(specs.abstract_params(cfg))
    if rec["params"] != n_params:
        fail(f"phase 17a: params {rec['params']} != abstract_params' "
             f"{n_params}")
    ratio = rec["counted_flops"] / rec["model_flops"]
    if not DRY_RATIO[0] <= ratio <= DRY_RATIO[1]:
        fail(f"phase 17a: counted/model flops {ratio} outside {DRY_RATIO}")
    if not rec["collective_bytes_per_device"] > 0:
        fail("phase 17a: no collective bytes")
    m = rec["memory"]
    terms = roofline.roofline_terms(rec)
    return dict(
        arch=DRY_ARCH, shape=DRY_SHAPE, mesh=rec["mesh"],
        layers=cfg.n_layers,
        params=rec["params"], counted_flops=rec["counted_flops"],
        model_flops=rec["model_flops"], counted_over_model=ratio,
        collective_mib_per_device={k: v / 2**20 for k, v in
                                   rec["collective_by_type"].items()},
        collective_mib_total=rec["collective_bytes_per_device"] / 2**20,
        n_collectives=rec["n_collectives"],
        args_gib=m["argument_bytes"] / 2**30,
        temp_gib=m["temp_bytes"] / 2**30,
        roofline={k: terms[k] for k in ("compute", "memory", "collective",
                                        "dominant", "step_time_bound")},
        run_s=rec["seconds"]["run"], seconds=time.perf_counter() - t0)


def _same_tree(torch, a, b):
    from repro_torch.core.utils import tree_leaves
    from repro_torch.distributed.sharding import full
    return all(torch.equal(full(x), y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def one_rank_mesh(torch, rt, kernels, card, dev, backend="nccl",
                  ready=None):
    """Phase 17b (its own process): a one-rank world on ``dev``, a (1, 1)
    ("data", "model") DeviceMesh and a (1,) ("pod",) one.  ``ready()``,
    called once the world and the meshes stand, returns when the phase
    may start."""
    import tempfile
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.world import close_world, init_world
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.training import checkpoint as ckpt
    import concurrent.futures
    from repro_torch.core import rng
    out, totals = {}, dict.fromkeys(SOURCES, 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p17_")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        init_world(backend, 0, 1, os.path.join(tmp, "store"))
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        pmesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("pod",))
        if ready is not None:
            ready()
        # 17b.4's CPU half (~20 s of threefry on the host) runs in a
        # thread beside 17b.1-3: its tensor ops release the GIL
        gen = torch.Generator().manual_seed(5)
        g = torch.randn(QUANT_SHAPE, generator=gen)
        r = torch.randn(QUANT_SHAPE, generator=gen) * 1e-3
        key = rng.fold_in(rng.prng_key(17), 3)
        t_quant = time.perf_counter()
        cpu_quant = pool.submit(comp.quantize_int8, g, r, key)
        # 17b.1: the unfused step on DTensor params, bitwise
        t0 = time.perf_counter()
        cfg = rt.get_config("qwen3-14b").replace(n_layers=DIST_LAYERS)
        p0 = rt.model_init(cfg, 0, device=dev)
        batch = rt.lm_sampler(8, 64, cfg.vocab, seed=0, device=dev)(0)
        runs, sharded_final = {}, None
        kernels.reset_launch_counts()
        for mode in ("central", "forward"):
            mcfg = rt.MGDConfig(dtheta=1e-2, eta=1e-2, mode=mode)
            step = rt.build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b),
                                     mcfg)
            p, s = p0, rt.mgd_init(p0, mcfg)
            cts = []
            for _ in range(DIST_STEPS):
                p, s, m = step(p, s, batch)
                cts.append(m["c_tilde"])
            with shd.use_mesh(mesh):
                q = shd.device_put(p0, specs.param_shardings(cfg, mesh))
                sb = shard_batch(batch, mesh)
                qs = rt.mgd_init(q, mcfg)
                torch.cuda.synchronize() if dev.type == "cuda" else None
                t1 = time.perf_counter()
                gct = []
                for _ in range(DIST_STEPS):
                    q, qs, m = step(q, qs, sb)
                    gct.append(m["c_tilde"])
                torch.cuda.synchronize() if dev.type == "cuda" else None
                dt = time.perf_counter() - t1
            same_ct = all(torch.equal(shd.full(a), b)
                          for a, b in zip(gct, cts))
            same_p = _same_tree(torch, q, p)
            if not (same_ct and same_p):
                fail(f"phase 17b {mode}: the one-rank mesh's step is not "
                     f"bitwise the unsharded step (C̃ {same_ct}, params "
                     f"{same_p})")
            runs[mode] = dict(steps=DIST_STEPS, bitwise=True,
                              s_per_step_mesh=dt / DIST_STEPS,
                              c_tilde=[float(c) for c in cts],
                              dtensor_leaves=sum(
                                  shd.is_dtensor(x) for x in
                                  rt.core.utils.tree_leaves(q)))
            sharded_final, plain_final = q, p
            del p, s, q, qs
        if any(kernels.launch_counts().values()):
            fail(f"phase 17b.1: the unfused step launched "
                 f"{kernels.launch_counts()}")
        out["17b1"] = dict(runs=runs, layers=DIST_LAYERS,
                           seconds=time.perf_counter() - t0)
        print(json.dumps({"phase17b1": out["17b1"]}), flush=True)
        # 17b.3: a checkpoint saved from the mesh, restored with no mesh
        # (the stacked attention: 1.1 GB of the 5.7)
        t0 = time.perf_counter()
        saved = sharded_final["layers"]["attn"]
        ckpt.save(os.path.join(tmp, "ckpt"), 7, saved)
        back, _, step_no = ckpt.restore(os.path.join(tmp, "ckpt"),
                                        p0["layers"]["attn"])
        if step_no != 7 or not _same_tree(torch, saved, back) \
                or not _same_tree(torch, back,
                                  plain_final["layers"]["attn"]):
            fail("phase 17b.3: the checkpoint restored with no mesh is not "
                 "bitwise the mesh's params")
        out["17b3"] = dict(bitwise=True, seconds=time.perf_counter() - t0)
        del sharded_final, plain_final, back
        # 17b.2: probe pods as ranks, fused, against LocalMesh(pod=1)
        t0 = time.perf_counter()
        mlp_loss = (lambda p, b: rt.mse(rt.mlp_apply(p, b["x"]), b["y"]))
        from repro_torch.data import pipeline, tasks
        mlp = dict(
            loss=mlp_loss, probe=rt.make_mlp_probe_fn(),
            cfg=rt.DriverConfig(dtheta=1e-2, eta=0.1, seed=1, fused=True,
                                mode="central"),
            p0=rt.mlp_init(2, MLP_SIZES, device=dev),
            sample=pipeline.generator_sampler(tasks.nist7x7_batch, 4,
                                              seed=7, device=dev),
            steps=DIST_PP_MLP_STEPS, pairs=2)
        lm = dict(
            loss=lambda p, b: rt.model_loss(p, cfg, b),
            probe=rt.make_transformer_probe_fn(cfg),
            cfg=rt.DriverConfig(dtheta=1e-2, eta=1e-2, seed=0, fused=True,
                                mode="central"),
            p0=p0, sample=rt.lm_sampler(8, 64, cfg.vocab, seed=0,
                                        device=dev),
            steps=DIST_PP_LM_STEPS, pairs=LM_PER_LAYER * DIST_LAYERS + 1)
        pods = {}
        for name, case in (("mlp", mlp), ("lm", lm)):
            def run(m):
                drv = rt.driver("probe_parallel", case["cfg"], case["loss"],
                                probe_fn=case["probe"], mesh=m, device=dev)
                p, s = case["p0"], drv.init(case["p0"])
                cts, ps = [], []
                for i in range(case["steps"]):
                    p, s, aux = drv.step(p, s, case["sample"](i))
                    cts.append(aux["c_tilde"])
                    ps.append(p)
                return cts, ps
            kernels.reset_launch_counts()
            with WindowRecorder(ops) as rec:
                got = run(pmesh)
                torch.cuda.synchronize() if dev.type == "cuda" else None
            counts = kernels.launch_counts()   # the ranks' run alone
            want = local = None
            want = pp_expected(case["steps"], case["pairs"], pods=1)
            local = run(rt.LocalMesh(pod=1))
            same = all(torch.equal(a, b) for a, b in zip(got[0], local[0])) \
                and all(_same_tree(torch, a, b)
                        for a, b in zip(got[1], local[1]))
            if not same:
                fail(f"phase 17b.2 {name}: pods as ranks are not bitwise "
                     f"LocalMesh(pod=1)")
            if dev.type == "cuda" and counts != want:
                fail(f"phase 17b.2 {name}: launches {counts} != {want}")
            if rec.calls and any(c[1] != 1 for c in rec.calls):
                fail(f"phase 17b.2 {name}: window updates {rec.calls}, "
                     f"expected J = 1")
            for k, v in counts.items():
                totals[k] += v
            pods[name] = dict(steps=case["steps"], bitwise=True,
                              launches=counts, window_calls=rec.calls[:1])
            del got, local
        out["17b2"] = dict(pods, seconds=time.perf_counter() - t0)
        print(json.dumps({"phase17b2": out["17b2"]}), flush=True)
        # 17c: the kernels' n_cols on blocks of a leaf, the fused step on
        # DTensor params, the other families on the mesh
        t_c = time.perf_counter()
        blocks = kernel_blocks(torch, ops, rt.core.perturbations, dev)
        t1 = time.perf_counter()
        print(f"phase 17c.1 done in {t1 - t_c:.1f} s", flush=True)
        fused, fused_counts = sharded_fused(torch, rt, kernels, dev, mesh,
                                            cfg, p0, batch)
        print(json.dumps({"phase17c2": fused}), flush=True)
        for k, v in fused_counts.items():
            totals[k] += v
        del p0, lm, mlp
        t2 = time.perf_counter()
        fams = families_on_mesh(torch, rt, dev, mesh)
        out["17c"] = dict(blocks=blocks, fused=fused, families=fams,
                          seconds={"17c1": t1 - t_c, "17c2": t2 - t1,
                                   "17c3": time.perf_counter() - t2,
                                   "17c": time.perf_counter() - t_c})
        print(json.dumps({"phase17c": out["17c"]}), flush=True)
        print("phase 17c: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in out["17c"]["seconds"].items()),
            flush=True)
        # 17d: the four-card run's pieces on one card
        t_d = time.perf_counter()
        out["17d"], slice_counts = sharded_slice(torch, rt, kernels, dev,
                                                 mesh)
        for k, v in slice_counts.items():
            totals[k] += v
        out["17d"]["seconds"] = time.perf_counter() - t_d
        print(json.dumps({"phase17d": out["17d"]}), flush=True)
        print(f"phase 17d: {out['17d']['seconds']:.1f} s", flush=True)
        # 17b.4: int8 compression, card against CPU
        t0 = time.perf_counter()
        on_card = comp.quantize_int8(g.to(dev), r.to(dev), key)
        on_cpu = cpu_quant.result()
        t_cpu = time.perf_counter() - t_quant
        if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
            fail("phase 17b.4: quantize_int8 on the card differs from the "
                 "CPU")
        out["17b4"] = dict(shape=list(QUANT_SHAPE), bitwise=True,
                           scale=float(on_cpu[1]),
                           seconds=time.perf_counter() - t0,
                           cpu_thread_s=t_cpu)
    finally:
        pool.shutdown(wait=True)
        close_world()
        shutil.rmtree(tmp, ignore_errors=True)
    out["card"] = card
    return out, totals


def kernel_blocks(torch, ops, pert, dev):
    """Phase 17c.1: each kernel on the four blocks of a leaf a (2, 2)
    mesh gives (K and N halved), the block's offset folded into its seed
    and the leaf's N as ``n_cols``: B1/B2 on the column blocks (x whole)
    bitwise the same columns of the whole leaf's launch, the row blocks'
    products (x's matching columns) summing to the whole within 1e-4,
    B3/B4 on each block bitwise the whole update's block, and each block
    launch against its plain version with the same ``n_cols``."""
    gen = torch.Generator(device=dev).manual_seed(17)
    f32 = torch.float32
    recs = {name: [] for name in SOURCES}
    for (m, k, n), dname in BLOCK_CASES:
        dt = getattr(torch, dname)
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        xm = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.1).to(dt)
        lseed = pert.leaf_seed(3, 1, 4)
        kw = dict(dtheta=1e-2, out_dtype=f32)
        whole = ops.perturbed_matmul(x, w, lseed, sign=-1.0, **kw)
        whole_p = ops.perturbed_matmul_pair(x, xm, w, lseed, **kw)
        hk, hn = k // 2, n // 2
        col_eq, sum_err, plain_err, plain_err_p = True, 0.0, 0.0, 0.0
        for c in range(2):
            cs = slice(c * hn, (c + 1) * hn)
            seed = pert.shifted_leaf_seed(lseed, c * hn)
            wc = w[:, cs].contiguous()
            y = ops.perturbed_matmul(x, wc, seed, sign=-1.0, n_cols=n, **kw)
            yp, ym = ops.perturbed_matmul_pair(x, xm, wc, seed, n_cols=n,
                                               **kw)
            col_eq &= bool(torch.equal(y, whole[:, cs])
                           and torch.equal(yp, whole_p[0][:, cs])
                           and torch.equal(ym, whole_p[1][:, cs]))
            parts, parts_p = [], []
            for r in range(2):
                rs = slice(r * hk, (r + 1) * hk)
                seed = pert.shifted_leaf_seed(lseed, r * hk * n + c * hn)
                xb, xmb = x[:, rs].contiguous(), xm[:, rs].contiguous()
                wb = w[rs, cs].contiguous()
                y = ops.perturbed_matmul(xb, wb, seed, sign=-1.0, n_cols=n,
                                         **kw)
                yp, ym = ops.perturbed_matmul_pair(xb, xmb, wb, seed,
                                                   n_cols=n, **kw)
                ref = ops.perturbed_matmul(xb, wb, seed, sign=-1.0, n_cols=n,
                                           impl="ref", **kw)
                rp, rm = ops.perturbed_matmul_pair(xb, xmb, wb, seed,
                                                   n_cols=n, impl="ref", **kw)
                plain_err = max(plain_err, rel_err(y, ref))
                plain_err_p = max(plain_err_p, rel_err(yp, rp),
                                  rel_err(ym, rm))
                parts.append(y)
                parts_p.append((yp, ym))
            sum_err = max(sum_err, rel_err(parts[0] + parts[1], whole[:, cs]),
                          rel_err(parts_p[0][0] + parts_p[1][0],
                                  whole_p[0][:, cs]),
                          rel_err(parts_p[0][1] + parts_p[1][1],
                                  whole_p[1][:, cs]))
        torch.cuda.synchronize() if dev.type == "cuda" else None
        shape = [m, k, n]
        if not col_eq:
            fail(f"phase 17c.1 {shape} {dname}: a column block's product is "
                 f"not bitwise the whole leaf's columns")
        for what, e in (("row blocks' sum", sum_err), ("plain", plain_err),
                        ("plain (pair)", plain_err_p)):
            if not e <= TOL["float32"]:
                fail(f"phase 17c.1 {shape} {dname}: {what} rel err {e} > "
                     f"{TOL['float32']}")
        for name, pe in (("perturbed_matmul", plain_err),
                         ("perturbed_matmul_pair", plain_err_p)):
            recs[name].append(dict(
                shape=shape, dtype=dname, blocks="2x2", n_cols=n,
                column_blocks_bitwise=True, row_blocks_sum_rel_err=sum_err,
                plain_rel_err=pe, tol=TOL["float32"]))
        del whole, whole_p, x, xm
        seeds = [pert.leaf_seed(3, t, 4) for t in range(BLOCK_WINDOW)]
        coefs = torch.randn((BLOCK_WINDOW,), generator=gen, device=dev)
        upd = {"mgd_update_window": lambda w_, s_, **kw_: ops.mgd_update_window(
                   w_, s_, coefs, alpha=-0.5, dtheta=1e-2, **kw_),
               "mgd_update": lambda w_, s_, **kw_: ops.mgd_update(
                   w_, s_, coefs, eta=1e-2, dtheta=1e-2, **kw_)}
        for name, fn in upd.items():
            whole = fn(w, seeds)
            same = plain_same = True
            for r in range(2):
                for c in range(2):
                    rs = slice(r * hk, (r + 1) * hk)
                    cs = slice(c * hn, (c + 1) * hn)
                    bs = [pert.shifted_leaf_seed(sd, r * hk * n + c * hn)
                          for sd in seeds]
                    wb = w[rs, cs].contiguous()
                    got = fn(wb, bs, n_cols=n)
                    same &= bool(torch.equal(got, whole[rs, cs]))
                    plain_same &= bool(torch.equal(
                        got, fn(wb, bs, n_cols=n, impl="ref")))
            if not (same and plain_same):
                fail(f"phase 17c.1 {name} {[k, n]} {dname}: blocks bitwise "
                     f"the whole {same}, their plain versions {plain_same}")
            recs[name].append(dict(shape=[k, n], dtype=dname, blocks="2x2",
                                   n_cols=n, window=BLOCK_WINDOW,
                                   whole_block_bitwise=True,
                                   plain_bitwise=True))
            del whole
        del w
    return recs


def sharded_fused(torch, rt, kernels, dev, mesh, cfg, p0, batch):
    """Phase 17c.2: the fused central and forward steps of ``cfg`` on
    DTensor params on the one-rank ``mesh``, B1/B2/B3 on the local shards
    (offset 0, ``n_cols`` = N): bitwise the unsharded fused steps from the
    same state, with the same launch counts."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    runs, totals = {}, dict.fromkeys(SOURCES, 0)
    for mode in ("central", "forward"):
        mcfg = rt.MGDConfig(dtheta=1e-2, eta=1e-2, mode=mode, fused=True)
        step = rt.build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mcfg,
                                 probe_fn=rt.make_transformer_probe_fn(cfg))

        def run(p, b):
            s, cts = rt.mgd_init(p, mcfg), []
            kernels.reset_launch_counts()
            for _ in range(SHARDED_FUSED_STEPS):
                p, s, m = step(p, s, b)
                cts.append(shd.full(m["c_tilde"]))
            torch.cuda.synchronize() if dev.type == "cuda" else None
            return p, cts, kernels.launch_counts()

        p, cts, want = run(p0, batch)
        with shd.use_mesh(mesh):
            q = shd.device_put(p0, specs.param_shardings(cfg, mesh))
            t1 = time.perf_counter()
            q, gct, got = run(q, shard_batch(batch, mesh))
            dt = time.perf_counter() - t1
        same = all(torch.equal(a, b) for a, b in zip(gct, cts)) \
            and _same_tree(torch, q, p)
        if not same:
            fail(f"phase 17c.2 {mode}: the fused step on DTensor params is "
                 f"not bitwise the unsharded fused step")
        if got != want or (dev.type == "cuda" and not all(
                got[k] for k in ("perturbed_matmul_pair"
                                 if mode == "central" else "perturbed_matmul",
                                 "mgd_update_window"))):
            fail(f"phase 17c.2 {mode}: launches {got} on the mesh, {want} "
                 f"without it")
        for k, v in got.items():
            totals[k] += v
        runs[mode] = dict(steps=SHARDED_FUSED_STEPS, bitwise=True,
                          launches=got, s_per_step_mesh=dt
                          / SHARDED_FUSED_STEPS,
                          c_tilde=[float(c) for c in cts])
        del p, q
    return runs, totals


def families_on_mesh(torch, rt, dev, mesh):
    """Phase 17c.3: MoE, MLA and the recurrent families at full width on
    the one-rank mesh: forward, prefill and one decode token bitwise the
    unsharded model's, then one MGD step on the mesh, C̃ and params
    bitwise the unsharded step's (run first, its results kept on the
    host); peak memory."""
    from repro_torch.core.utils import tree_leaves
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    out = {}
    for arch, n_layers in FAMILY_MESH.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats() if dev.type == "cuda" else None
        cfg = rt.get_config(arch).replace(n_layers=n_layers)
        params = rt.model_init(cfg, 0, device=dev)
        batch = rt.lm_sampler(8, 64, cfg.vocab, seed=0, device=dev)(0)
        toks = {"tokens": batch["tokens"]}
        s = toks["tokens"].shape[-1]
        want = [rt.model_forward(params, cfg, batch)]
        wl, wc = rt.model_prefill(params, cfg, toks, s + 1)
        want += [wl, rt.model_decode(params, cfg, toks["tokens"][:, -1],
                                     wc)[0]]
        del wl, wc
        fused = arch in FAMILY_MESH_FUSED
        mcfg = rt.MGDConfig(dtheta=1e-2, eta=1e-2, mode="central",
                            fused=fused)
        step = rt.build_mgd_step(
            lambda p, b: rt.model_loss(p, cfg, b), mcfg,
            probe_fn=rt.make_transformer_probe_fn(cfg) if fused else None)
        p, _, m = step(params, rt.mgd_init(params, mcfg), batch)
        want_ct = m["c_tilde"].cpu()
        want_p = [x.cpu() for x in tree_leaves(p)]
        del p, m
        with shd.use_mesh(mesh):
            placed = shd.device_put(params, specs.param_shardings(cfg, mesh))
            del params
            sb = shard_batch(batch, mesh)
            got = [rt.model_forward(placed, cfg, sb)]
            gl, gc = rt.model_prefill(placed, cfg,
                                      {"tokens": sb["tokens"]}, s + 1)
            got += [gl, rt.model_decode(placed, cfg, toks["tokens"][:, -1],
                                        gc)[0]]
            del gl, gc
        same = [bool(torch.equal(shd.full(g), w_)) for g, w_ in zip(got, want)]
        del got, want
        if not all(same):
            fail(f"phase 17c.3 {arch}: forward, prefill, decode bitwise "
                 f"{same} on the one-rank mesh")
        t1 = time.perf_counter()
        with shd.use_mesh(mesh):
            q, _, m = step(placed, rt.mgd_init(placed, mcfg), sb)
            ct = shd.full(m["c_tilde"])
        torch.cuda.synchronize() if dev.type == "cuda" else None
        step_s = time.perf_counter() - t1
        if not bool(torch.isfinite(ct)):
            fail(f"phase 17c.3 {arch}: the MGD step on the mesh gave C̃ {ct}")
        del placed
        step_bitwise = bool(torch.equal(ct.cpu(), want_ct)) and all(
            torch.equal(shd.full(x).cpu(), y)
            for x, y in zip(tree_leaves(q), want_p))
        del q, want_p
        if not step_bitwise:
            fail(f"phase 17c.3 {arch}: the MGD step on the mesh is not "
                 f"bitwise the unsharded step")
        peak = torch.cuda.max_memory_allocated() / 1e9 \
            if dev.type == "cuda" else None
        out[arch] = dict(layers=n_layers, forward_prefill_decode_bitwise=True,
                         mgd_step="fused" if fused else "unfused",
                         c_tilde=float(ct), step_s=step_s,
                         step_bitwise=step_bitwise, peak_mem_gb=peak,
                         seconds=time.perf_counter() - t0)
        print(json.dumps({"phase17c3": {arch: out[arch]}}), flush=True)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return out


SLICE_INITS = (("qwen2-72b", 2, None), ("llama4-scout-17b-a16e", 1,
                                         "moe_ep"))
SLICE_WITNESS = ("qwen2-72b", 2)
SLICE_PEAK_LAYERS = (1, 2, 3)   # llama4-scout's one-card peaks


def sharded_slice(torch, rt, kernels, dev, mesh):
    """Phase 17d: the sharded init bitwise ``device_put`` of the whole
    init; the one-card witness (``tests/torch_witness.py``) bitwise the
    whole-model fused steps, whose launches it returns; llama4-scout's
    one-card peaks and the deepest depth one card holds."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_witness as tw
    from repro_torch.core import perturbations as pert
    from repro_torch.core.utils import tree_leaves, tree_map
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import default_mgd_config
    cuda = dev.type == "cuda"
    out, totals = {}, dict.fromkeys(SOURCES, 0)
    # 17d.1
    for arch, n_layers, rules in SLICE_INITS:
        cfg = rt.get_config(arch).replace(n_layers=n_layers)
        with shd.use_mesh(mesh, shd.RULE_SETS[rules] if rules else None):
            sh = specs.param_shardings(cfg, mesh)
            got = rt.model_init(cfg, 0, device=dev, shardings=sh)
            want = shd.device_put(rt.model_init(cfg, 0, device=dev), sh)
        same = all(tuple(a.placements) == tuple(b.placements)
                   and torch.equal(a.to_local(), b.to_local())
                   for a, b in zip(tree_leaves(got), tree_leaves(want)))
        del got, want
        if not same:
            fail(f"phase 17d.1 {arch}: the sharded init is not bitwise "
                 f"device_put of the whole init")
        out[f"init/{arch}"] = dict(layers=n_layers, rules=rules or "default",
                                   bitwise=True)
    # 17d.2
    arch, n_layers = SLICE_WITNESS
    cfg = rt.get_config(arch).replace(n_layers=n_layers)
    params = rt.model_init(cfg, 0, device=dev)
    batch = rt.lm_sampler(8, 64, cfg.vocab, seed=0, device=dev)(0)
    if not torch.equal(tw.stream_cost(cfg, 0, batch, device=dev),
                       rt.model_loss(params, cfg, batch)):
        fail("phase 17d.2: the witness's cost at θ₀ is not the model's")
    steps = {}
    for mode, signs in (("central", (1.0, -1.0)), ("forward", (1.0,))):
        mc = dataclasses.replace(default_mgd_config(mode), fused=True)
        step = rt.build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mc,
                                 probe_fn=rt.make_transformer_probe_fn(cfg))
        kernels.reset_launch_counts()
        new, _, m = step(params, rt.mgd_init(params, mc), batch)
        torch.cuda.synchronize() if cuda else None
        counts = kernels.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        probe = pert.Probe(0, mc.seed, pert.ProbeCtx(
            signs=signs, dtheta=mc.dtheta, tau_p=mc.tau_p))
        costs = tw.stream_probe(cfg, 0, batch, probe, device=dev)
        ct = (0.5 * (costs[0] - costs[1]) if mode == "central" else
              costs[0] - tw.stream_cost(cfg, 0, batch, device=dev))
        same = bool(torch.equal(ct, m["c_tilde"]))
        for part in ["embed"] + list(range(n_layers)):
            want = (new["embed"] if part == "embed" else
                    tree_map(lambda a: a[part], new["layers"]))
            got = tw.redraw(cfg, 0, part, device=dev,
                            updates=[(mc, 0, m["c_tilde"])])
            same = same and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(want)))
            del got, want             # want is a view into new's bank
        kernels.reset_launch_counts()     # the witness's own launches
        if not same:
            fail(f"phase 17d.2 {mode}: the witness is not bitwise the "
                 f"whole-model fused step")
        if cuda and not all(counts[k] for k in (
                "perturbed_matmul_pair" if mode == "central"
                else "perturbed_matmul", "mgd_update_window")):
            fail(f"phase 17d.2 {mode}: launches {counts}")
        steps[mode] = dict(bitwise=True, launches=counts,
                           c_tilde=float(m["c_tilde"]),
                           cost=float(m["cost"]))
        del new
    out["witness"] = dict(arch=arch, layers=n_layers, steps=steps)
    del params
    # 17d.3: peaks above what the process already holds (17b-c's leftovers
    # when it runs after them), so they read as a fresh process's
    peaks = {}
    cfg = rt.get_config("llama4-scout-17b-a16e")
    mc = dataclasses.replace(default_mgd_config("central"), fused=True)
    torch.cuda.empty_cache() if cuda else None
    base = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    for n_layers in SLICE_PEAK_LAYERS:
        c = cfg.replace(n_layers=n_layers)
        torch.cuda.empty_cache() if cuda else None
        p = rt.model_init(c, 0, device=dev)
        b = rt.lm_sampler(8, 64, c.vocab, seed=0, device=dev)(0)
        step = rt.build_mgd_step(lambda q, bb: rt.model_loss(q, c, bb), mc,
                                 probe_fn=rt.make_transformer_probe_fn(c))
        torch.cuda.reset_peak_memory_stats() if cuda else None
        p, _, m = step(p, rt.mgd_init(p, mc), b)
        torch.cuda.synchronize() if cuda else None
        peaks[n_layers] = torch.cuda.max_memory_allocated() / 1e9 - base \
            if cuda else 0.0
        if not bool(torch.isfinite(m["c_tilde"])):
            fail(f"phase 17d.3: llama4-scout at {n_layers} layers gave C̃ "
                 f"{m['c_tilde']}")
        del p, m
    torch.cuda.empty_cache() if cuda else None
    lo, hi = SLICE_PEAK_LAYERS[0], SLICE_PEAK_LAYERS[-1]
    slope = (peaks[hi] - peaks[lo]) / (hi - lo)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9 \
        if cuda else 0.0
    one_card = (int((total - (peaks[lo] - lo * slope)) // slope)
                if slope > 0 else None)
    out["llama4_peaks"] = dict(peak_gb=peaks, held_before_gb=base,
                               slope_gb_per_layer=slope, card_gb=total,
                               one_card_layers=one_card)
    return out, totals


_CHILDREN = []


def _stop_children():
    """Kills the phase-17 processes still running when this one exits
    (a failed phase must not leave them on the card)."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_phase17(which):
    """A phase-17 subprocess (this script with ``--phase17 a|b``), its
    output and errors into temp files."""
    import tempfile
    log, err = tempfile.TemporaryFile(mode="w+"), \
        tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--phase17", which], stdin=subprocess.PIPE, stdout=log,
        stderr=err, text=True)
    if not _CHILDREN:
        import atexit
        atexit.register(_stop_children)
    _CHILDREN.append(proc)
    return proc, (log, err), time.perf_counter()


def go_phase17(started):
    """Lets a started 17b begin (it waits on a line of its input); the
    phase's seconds count from here."""
    proc, files, _ = started
    proc.stdin.write("go\n")
    proc.stdin.flush()
    return proc, files, time.perf_counter()


def finish_phase17(which, proc, files, t_start):
    """Waits for a phase-17 subprocess; fails unless it exited 0.  Returns
    its record (its last output line) and its seconds."""
    try:
        proc.wait(timeout=PHASE17_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"phase 17{which}: no exit within {PHASE17_TIMEOUT_S} s")
    seconds = time.perf_counter() - t_start
    log, err = files
    log.seek(0)
    err.seek(0)
    lines, errors = log.read().splitlines(), err.read()
    log.close()
    err.close()
    # the last line is the record; a failed process's is a report too
    for line in lines[:-1] if proc.returncode == 0 else lines:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        print(errors[-4000:], file=sys.stderr, flush=True)
        fail(f"phase 17{which}: its process exited {proc.returncode}")
    return json.loads(lines[-1]), seconds


def phase17_main(which):
    """The body of ``--phase17 a|b``: prints the record as its last line."""
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if which == "a":
        print(json.dumps(dryrun_cell(torch)), flush=True)
        return 0
    import repro_torch as rt
    from repro_torch import kernels
    from repro_torch.kernels import _build
    _build.build_all()          # the parent's build: loads, no nvcc run
    # started before phase 16, it sets up and waits for the parent's "go"
    def ready():
        if sys.stdin.readline() != "go\n":     # the parent is gone
            fail("phase 17b: no go from phase 17")

    out, totals = one_rank_mesh(torch, rt, kernels, card_line(),
                                torch.device("cuda"), ready=ready)
    print(json.dumps(dict(out, launches=totals)), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS,
                    help="MLP training steps per run (multiple of 4, >= 32)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write every record to this JSON file")
    ap.add_argument("--phase17", choices=("a", "b"), default=None,
                    help=argparse.SUPPRESS)   # phase 17's subprocesses
    args = ap.parse_args(argv)
    if args.phase17:
        return phase17_main(args.phase17)
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

    # -- phase 12: serving -------------------------------------------------
    t0 = time.perf_counter()
    serving = {"generation": serving_generation(torch, rt, kernels, card,
                                                dev)}
    t_a = time.perf_counter()
    serving["online"], serving_counts = serving_online(torch, rt, kernels,
                                                       card, dev)
    t_b = time.perf_counter()
    serving["mlp"] = serving_mlp(torch, card, dev)
    serving["seconds"] = {"12a": t_a - t0, "12b": t_b - t_a,
                          "12c": time.perf_counter() - t_b}
    print(f"phase 12: 12a {serving['seconds']['12a']:.1f} s, 12b "
          f"{serving['seconds']['12b']:.1f} s, 12c "
          f"{serving['seconds']['12c']:.1f} s", flush=True)
    done(12, t0)

    # -- phase 13: the attention families at full width -------------------
    # 17a (the dry run: fake tensors, no card) runs beside phases 13-14,
    # one process on the host's CPU while they keep the card busy
    p17a = start_phase17("a")
    t0 = time.perf_counter()
    families, family_counts = attention_families(torch, rt, kernels, card,
                                                 dev)
    print("phase 13: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in families["seconds"].items()),
        flush=True)
    print(json.dumps({"phase13_summary": family_summary(families)}),
          flush=True)
    done(13, t0)

    # -- phase 14: the recurrent families at full width and depth -----------
    t0 = time.perf_counter()
    recurrent, recurrent_counts = recurrent_families(torch, rt, kernels,
                                                     card, dev)
    print("phase 14: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in recurrent["seconds"].items()),
        flush=True)
    print(json.dumps({"phase14_summary": recurrent_summary(recurrent)}),
          flush=True)
    done(14, t0)

    # -- phase 15: the bench twins ------------------------------------------
    t0 = time.perf_counter()
    twins, twin_counts = bench_twins(
        torch, rt, kernels, card, dev,
        args.out.with_suffix(".bench") if args.out else None)
    print("phase 15: " + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in twins.items()), flush=True)
    done(15, t0)

    # -- phase 16: the paper's figure benches -------------------------------
    # 17b's process starts here and sets up (imports, the kernels' load,
    # its world) while phase 16 runs; it waits for the "go" of phase 17
    p17b = start_phase17("b")
    t0 = time.perf_counter()
    figures = paper_figures(torch, rt, kernels, card, dev)
    print("phase 16: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in figures["seconds"].items()), flush=True)
    done(16, t0)

    # -- phase 17: distribution on torch.distributed -----------------------
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.empty_cache()    # 17c.3's DeepSeek-V3 layer needs ~55 GB
    p17b = go_phase17(p17b)
    dist = {}
    dist["17b"], dist["17b_seconds"] = finish_phase17("b", *p17b)
    dist["17a"], dist["17a_seconds"] = finish_phase17("a", *p17a)
    dist_counts = dist["17b"].pop("launches")
    dist["17a"]["card"] = card
    print(json.dumps({"phase17a": dist["17a"]}), flush=True)
    print(json.dumps({"phase17b": dist["17b"]}), flush=True)
    print(f"phase 17: 17a {dist['17a_seconds']:.1f} s (from phase 13's "
          f"start), 17b {dist['17b_seconds']:.1f} s", flush=True)
    done(17, t0)
    dist["seconds"] = phase_s[17]

    for counts in (lm_totals, deep_counts, imperfect_counts, paper_counts,
                   pp_mlp_counts, pp_lm_counts, serving_counts,
                   family_counts, recurrent_counts, twin_counts,
                   figures["launches"], dist_counts):
        for k, v in counts.items():
            totals[k] += v
    main_shape = {"perturbed_matmul": (list(LM_MAIN), "bfloat16", None),
                  "perturbed_matmul_pair": (list(LM_MAIN), "bfloat16", None),
                  "mgd_update_window": (list(LM_MAIN[1:]), "bfloat16", 1),
                  "mgd_update": ([5120, 17408], "bfloat16", 4)}
    by_kernel = {name: {"tc": 0, "simt": 0}
                 for name in kernels.MATMUL_WRAPPERS}
    for rec in [*results.values(), *lm_results.values(), deep, imperfect,
                pp["transformer"], serving["online"], families["13a"],
                families["13b"], *families["13e"], twins["fused_probe"]]:
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
        # 17c.1: the kernel on the blocks of a leaf, n_cols = the leaf's N
        entry["n_cols_blocks"] = dist["17b"]["17c"]["blocks"][name]
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
            paper_cnns=cnns, probe_parallel=pp, serving=serving,
            attention_families=families, recurrent_families=recurrent,
            bench_twins=twins, paper_figures=figures, distribution=dist,
            phase_s=phase_s,
            ptxas=ptxas_summary(reports)), indent=1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
