"""Fused probe execution on the port: steps/s and modeled weight traffic,
materialized against fused, on the MLP and transformer configs.

    python -m repro_torch.benchmarks.fused_probe [--out DIR] [--device cpu]

The twin of the reference's ``benchmarks/fused_probe.py``: the same 12
rows in the same order, models, batches (drawn with ``core.rng``, the
reference's threefry), step counts (``STEPS`` timed after one warm-up
chunk of ``CHUNK``) and driver configs, through ``repro_torch.driver``
and ``make_epoch``.  Weights come from the port's own ``mlp_init`` /
``model_init`` of the reference's seeds.

The claim is a memory-roofline one: a materializing probe reads W to
build θ ± θ̃ and reads θ ± θ̃ in the matmul (2× inference's W bytes a
sign, 4× a central pair); the fused kernels regenerate the signs beside
the multiply, one read of W a probe (forward, B1) or a pair (central,
B2).  The ``*_wread_ratio`` rows are that bytes model.  The steps/s rows
time the whole step on the device the twin runs on: on the CUDA card the
fused route launches B1/B2 (the SIMT kernel, f32) and B3 every step; on
the CPU it is their plain versions.  Each steps/s row's ``detail`` names
the device and the route.

Writes ``DIR/fused_probe.json`` and prints the rows as CSV.  Gate it,
unedited, with ``python -m benchmarks.check_regression --fresh DIR
--baseline artifacts/bench``.
"""
from __future__ import annotations

import time

import torch

from repro_torch import kernels
from repro_torch.api import DriverConfig, driver, make_epoch
from repro_torch.core import mse, rng
from repro_torch.core.utils import tree_leaves, tree_size
from repro_torch.device import resolve_device
from repro_torch.models.simple import make_mlp_probe_fn, mlp_apply, mlp_init

from .common import bench_cli, card_line, sync

STEPS = 60          # measured steps per path (after one warm-up chunk)
CHUNK = 20
MLP_SIZES = (64, 64, 10)
MODELS = ("mlp", "transformer")
MODES = ("forward", "central")


def _weight_bytes(params):
    """(matmul-weight bytes, other bytes): ndim ≥ 2 leaves ride the
    kernels."""
    wb = ob = 0
    for leaf in tree_leaves(params):
        n = leaf.numel() * leaf.element_size()
        if leaf.dim() >= 2:
            wb += n
        else:
            ob += n
    return wb, ob


def _modeled_reads(mode: str, fused: bool) -> float:
    """Weight reads per probe step, in units of one inference pass:
    materialized 2× a sign; fused 1× a sign, 1× a central pair."""
    if fused and mode == "central":
        return 1.0                     # pair kernel: one pass over W
    return (1.0 if fused else 2.0) * (2 if mode == "central" else 1)


def _timed_run(run, params, state, dev):
    """One warm-up chunk, then ``STEPS`` timed.  Returns (params, steps/s,
    every step's C̃)."""
    params, state, aux = run(params, state)
    cts = [aux["c_tilde"]]
    sync(dev)
    t0 = time.perf_counter()
    done = 0
    while done < STEPS:
        params, state, aux = run(params, state)
        cts.append(aux["c_tilde"])
        done += CHUNK
    sync(dev)
    return params, done / (time.perf_counter() - t0), torch.cat(cts)


def mlp_setup(dev):
    """(params, batch, loss, probe_fn) of the reference's MLP run."""
    key = rng.prng_key(0)
    params = mlp_init(0, MLP_SIZES, device=dev)
    x = rng.normal(rng.fold_in(key, 1), (32, MLP_SIZES[0]), device=dev)
    labels = rng.randint(rng.fold_in(key, 2), (32,), 0, MLP_SIZES[-1],
                         device=dev)
    y = torch.nn.functional.one_hot(labels.long(),
                                    MLP_SIZES[-1]).to(torch.float32)

    def loss(p, b):
        return mse(mlp_apply(p, b["x"]), b["y"])

    return params, {"x": x, "y": y}, loss, make_mlp_probe_fn()


def transformer_setup(dev):
    """(params, batch, loss, probe_fn) of the reference's run: the
    qwen3-14b smoke config in f32, tokens [2, 16] from key 1."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (make_transformer_probe_fn, model_init,
                                    model_loss)

    cfg = get_smoke_config("qwen3-14b").replace(dtype="float32")
    params = model_init(cfg, 0, device=dev)
    toks = rng.randint(rng.prng_key(1), (2, 16), 0, cfg.vocab, device=dev)

    def loss(p, b):
        return model_loss(p, cfg, b)

    return (params, {"tokens": toks, "labels": toks}, loss,
            make_transformer_probe_fn(cfg))


SETUPS = {"mlp": mlp_setup, "transformer": transformer_setup}


def bench_one(model: str, mode: str, fused: bool, dev):
    """One (model, mode, fused) run: warm-up chunk + ``STEPS`` timed.
    Returns a record with the initial and final params, steps/s, every
    step's C̃ and the kernel launches the run made."""
    params, batch, loss, probe_fn = SETUPS[model](dev)
    cfg = DriverConfig(mode=mode, dtheta=1e-3, eta=1e-2, fused=fused)
    mgd = driver("discrete", cfg, loss, probe_fn=probe_fn if fused else None,
                 device=dev)
    run = make_epoch(mgd, CHUNK, lambda i: batch)
    before = kernels.launch_counts()
    end, sps, cts = _timed_run(run, params, mgd.init(params), dev)
    after = kernels.launch_counts()
    return dict(params0=params, params=end, steps_per_s=sps, c_tilde=cts,
                launches={k: after[k] - before[k] for k in after})


def _route(rec, where: str) -> str:
    launched = {k: v for k, v in rec["launches"].items() if v}
    if not launched:
        return f"plain PyTorch on {where}"
    return (f"CUDA kernels on {where}, launches "
            + "; ".join(f"{k} {v}" for k, v in launched.items()))


def measure(device=None):
    """Every (model, mode, fused) run's record, keyed so."""
    dev = resolve_device(device)
    return {(model, mode, fused): bench_one(model, mode, fused, dev)
            for model in MODELS for mode in MODES
            for fused in (False, True)}, dev


def rows_of(runs, dev):
    where = card_line() if dev.type == "cuda" else "cpu"
    rows = []
    for model in MODELS:
        for mode in MODES:
            wb, _ = _weight_bytes(runs[model, mode, True]["params0"])
            n = tree_size(runs[model, mode, True]["params0"])
            for fused in (False, True):
                rec = runs[model, mode, fused]
                reads = _modeled_reads(mode, fused)
                rows.append({
                    "bench": "fused_probe",
                    "name": f"{model}_{mode}_"
                            f"{'fused' if fused else 'materialized'}",
                    "value": round(rec["steps_per_s"], 3),
                    "detail": (f"steps/s ({_route(rec, where)}); modeled "
                               f"W-reads/probe-step {reads:.0f}x inference "
                               f"({reads * wb / 1e6:.2f} MB of "
                               f"{wb / 1e6:.2f} MB weights; {n} params)"),
                })
            rows.append({
                "bench": "fused_probe",
                "name": f"{model}_{mode}_wread_ratio",
                "value": _modeled_reads(mode, False) / _modeled_reads(
                    mode, True),
                "detail": "materialized/fused modeled W-read ratio "
                          "(central pair target: 4x -> 1x)",
            })
    return rows


def run(device=None):
    """The reference's 12 rows (it has no smoke budget or seed)."""
    return rows_of(*measure(device))


def main(argv=None) -> int:
    return bench_cli("fused_probe", run, argv, doc=__doc__,
                     smoke_help="accepted for the runner's sake; the "
                                "bench has one budget")


if __name__ == "__main__":
    raise SystemExit(main())
