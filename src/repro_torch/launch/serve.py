"""Serving entry point: ``python -m repro_torch.launch.serve --arch
qwen3-14b --smoke --batch 4 --max-new 32 [--device cpu]``.

The twin of the reference's ``launch/serve.py``, flag for flag, plus
``--device`` (the CUDA card unless ``--device cpu``).  Two modes:

* **Batch generation** (default) — prefill a batch of synthetic prompts
  (the reference's: ``randint(PRNGKey(seed + 1), (batch, prompt_len), 0,
  vocab)``) and decode from the KV cache (``serving.greedy_generate``).
* **Online serving** (``--online-trim``) — stand up a
  ``repro_torch.serve`` service over the model's next-token head: live
  requests are batched into fixed slots, labeled feedback flows into the
  replay buffer, and a background MGD trimmer re-trims the weights
  through a (optionally drifting) plant, publishing fenced
  snapshot-consistent parameter swaps while traffic keeps flowing:

      python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
          --online-trim --device cpu
      python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
          --online-trim --drift 0.002 --requests 128

Any ported architecture but the stub-frontend ones (vlm, audio), which
the reference's launcher refuses too: they take embeddings, not a token
prompt.  The recurrent families (rwkv6-7b, zamba2-7b) decode from their
recurrent state (and zamba2's shared-block K/V cache).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import rng
from repro_torch.device import resolve_device
from repro_torch.models import model_forward, model_init, model_loss
from repro_torch.serving import greedy_generate


def corpus_tokens(seed: int, rows: int, width: int, vocab: int):
    """The reference's synthetic corpus, ``randint(PRNGKey(seed + 1),
    (rows, width), 0, vocab)``, as host int32 rows: the next token is
    fixed by the window, so re-trim can drive the served cost down."""
    return rng.randint(rng.prng_key(seed + 1), (rows, width), 0, vocab,
                       device="cpu").numpy().astype(np.int32)


def _serve_online(args, cfg, params, dev):
    from repro_torch.api import DriverConfig
    from repro_torch.hardware import DriftingPlant, IdealPlant
    from repro_torch.serving import ServiceConfig, TrimConfig
    from repro_torch.serving import serve as make_service

    S = args.prompt_len

    def predict_fn(p, batch):
        # next-token logits for a fixed-length window — the decode slot
        return model_forward(p, cfg, {"tokens": batch["tokens"]})[:, -1, :]

    def loss_fn(p, batch):
        return model_loss(p, cfg, batch)

    plant = IdealPlant(loss_fn)
    if args.drift > 0:
        plant = DriftingPlant(plant, mode="walk", drift_rate=args.drift,
                              seed=args.seed + 41)

    trim = TrimConfig(
        DriverConfig(dtheta=args.dtheta, eta=args.eta, probes=args.probes,
                     mode="central", seed=args.seed),
        loss_fn, plant=plant)
    svc_cfg = ServiceConfig(slots=args.batch, batch_window_s=0.002,
                            replay_capacity=1024, trim_batch=args.batch,
                            min_fill=2 * args.batch,
                            publish_every=10, seed=args.seed)
    corpus = corpus_tokens(args.seed, 8, S + 1, cfg.vocab)

    def corpus_cost(p):
        with torch.no_grad():
            return float(np.mean([
                float(loss_fn(p, {
                    "tokens": torch.as_tensor(corpus[j:j + 1, :S],
                                              device=dev),
                    "labels": torch.as_tensor(corpus[j:j + 1, 1:],
                                              device=dev)}))
                for j in range(len(corpus))]))

    # context entry starts the dispatcher AND the background trainer
    # thread — traffic and MGD re-trim genuinely overlap here
    with make_service(svc_cfg, predict_fn, params, trim=trim,
                      start=False) as svc:
        c0 = corpus_cost(svc.snapshot().params)
        t0 = time.time()
        rounds = max(args.requests // args.batch, 1)
        for r in range(rounds):
            futs = []
            for i in range(args.batch):
                j = (r * args.batch + i) % len(corpus)
                futs.append(svc.submit(
                    {"tokens": corpus[j, :S]},
                    feedback={"labels": corpus[j, 1:]}))
            for f in futs:
                f.result(timeout=60)
        deadline = time.time() + 120
        while (svc.stats()["trim_global_step"] < args.trim_steps
               and time.time() < deadline):
            time.sleep(0.02)
        svc.fence()
        svc.publish()
        stats = svc.stats()
        c1 = corpus_cost(svc.snapshot().params)
        dt = time.time() - t0
        print(f"[serve] {cfg.name}: online mode — {stats['served']} "
              f"requests, {stats['trim_global_step']} trim steps, "
              f"{stats['version']} param swaps in {dt:.1f}s ({dev})")
        print(f"[serve]   latency p50={stats['latency_p50_ms']:.2f}ms "
              f"p99={stats['latency_p99_ms']:.2f}ms  "
              f"qps={stats['served'] / dt:.1f}")
        print(f"[serve]   served cost {c0:.4f} -> {c1:.4f} "
              f"({'improved' if c1 < c0 else 'no improvement'}"
              f"{', drifting plant' if args.drift > 0 else ''})")
    return stats, c0, c1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--online-trim", action="store_true",
                    help="serve through OnlineService with background "
                         "MGD re-trim from request feedback")
    ap.add_argument("--requests", type=int, default=64,
                    help="[online] total requests to serve")
    ap.add_argument("--trim-steps", type=int, default=200,
                    help="[online] total MGD trim steps")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="[online] per-step drift walk std on the plant")
    ap.add_argument("--eta", type=float, default=2e-3)
    ap.add_argument("--dtheta", type=float, default=1e-3)
    ap.add_argument("--probes", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(f"{args.arch}: stub-frontend arch — serve via "
                         "examples/serve_lm.py with embeddings")
    params = model_init(cfg, args.seed, device=dev)

    if args.online_trim:
        return _serve_online(args, cfg, params, dev)

    prompts = rng.randint(rng.prng_key(args.seed + 1),
                          (args.batch, args.prompt_len), 0, cfg.vocab,
                          device=dev).to(torch.int32)
    t0 = time.time()
    out = greedy_generate(params, cfg, prompts, args.max_new,
                          temperature=args.temperature,
                          seed=args.seed).cpu()
    dt = time.time() - t0
    print(f"[serve] {cfg.name}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s, {dev})")
    print("[serve] sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
