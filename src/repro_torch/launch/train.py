"""Training entry point: ``python -m repro_torch.launch.train --arch
qwen3-14b --smoke --steps 200 [--device cpu]``.

The twin of the reference's ``launch/train.py``, flag for flag, plus
``--device`` (the CUDA card unless ``--device cpu``): trains any ported
architecture (``repro_torch.configs.PORTED``) with MGD (or the backprop
baseline) on the synthetic LM stream (``lm_sampler``).  ``--smoke``
selects the reduced config.  An audio model with codebooks (musicgen)
reads ``n_codebooks`` streams of that sampler as its tokens [B, nq, S]
and labels [B, S, nq]; the reference's launcher passes such a model
[B, S] tokens, which it cannot embed.  Checkpoints are atomic and
resumable (``--ckpt-dir``); a killed run restarted with the same flags
reproduces the exact trajectory.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import MGDConfig
from repro_torch.core.utils import tree_leaves
from repro_torch.data.pipeline import lm_sampler
from repro_torch.device import resolve_device
from repro_torch.models import model_init, model_loss
from repro_torch.training.train_loop import (TrainLoopConfig, train_backprop,
                                             train_mgd)


def codebook_sampler(sample_fn, n_codebooks: int):
    """Batches of ``n_codebooks`` rows of ``sample_fn``'s [B·nq, S] stream
    as codebook tokens [B, nq, S] and labels [B, S, nq]."""

    def sample(i):
        batch = sample_fn(i)
        bq, s = batch["tokens"].shape
        shape = (bq // n_codebooks, n_codebooks, s)
        return {"tokens": batch["tokens"].reshape(shape),
                "labels": batch["labels"].reshape(shape).transpose(1, 2)}

    return sample


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--algo", default="mgd", choices=["mgd", "backprop"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--dtheta", type=float, default=1e-2)
    ap.add_argument("--tau-theta", type=int, default=1)
    ap.add_argument("--tau-x", type=int, default=1)
    ap.add_argument("--mode", default="central",
                    choices=["forward", "central"])
    ap.add_argument("--probes", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = model_init(cfg, args.seed, device=dev)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name} ({'smoke' if args.smoke else 'full'}): "
          f"{n/1e6:.2f}M params, algo={args.algo}, {dev}")

    sample_fn = lm_sampler(args.batch * max(cfg.n_codebooks, 1), args.seq,
                           cfg.vocab, seed=args.seed, device=dev)
    if cfg.n_codebooks:
        sample_fn = codebook_sampler(sample_fn, cfg.n_codebooks)

    def loss_fn(p, b):
        return model_loss(p, cfg, b)

    if args.algo == "mgd":
        eta = args.eta if args.eta is not None else 1e-2
        mgd_cfg = MGDConfig(
            ptype="rademacher", dtheta=args.dtheta, eta=eta,
            tau_theta=args.tau_theta, tau_x=args.tau_x, mode=args.mode,
            probes=args.probes, seed=args.seed)
        res = train_mgd(loss_fn, params, mgd_cfg, sample_fn, args.steps,
                        loop=TrainLoopConfig(
                            chunk=args.chunk, checkpoint_dir=args.ckpt_dir,
                            checkpoint_every=args.ckpt_every), device=dev)
    else:
        eta = args.eta if args.eta is not None else 0.3
        res = train_backprop(loss_fn, params, sample_fn, args.steps,
                             eta=eta, chunk=args.chunk)
    first = res.history[0][1]["cost"]
    last = res.history[-1][1]["cost"]
    print(f"[train] done: cost {first:.4f} → {last:.4f} "
          f"over {res.steps_done} steps")
    return res


if __name__ == "__main__":
    main()
