"""Online LM serving example: live requests through ``repro_torch.serve``'s
fixed-slot dispatcher, with optional background MGD re-trim from request
feedback.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--trim] \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch rwkv6-7b --trim [--device cpu]

Each "request" is a fixed-length token window; the client pads ragged
prompts into the window, the service batches concurrent requests into
slots and answers with next-token logits from one snapshot-consistent
parameter version per batch.  With ``--trim``, labeled feedback flows
into the replay buffer and a background MGD trimmer improves the served
weights while traffic keeps flowing — no backprop, scalar cost only.
Works with any non-stub architecture at smoke scale, the recurrent ones
(rwkv6-7b, zamba2-7b) included.
"""
import argparse
import time

import numpy as np

from repro_torch.api import DriverConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import rng
from repro_torch.models import model_forward, model_init, model_loss
from repro_torch.serving import ServiceConfig, TrimConfig, serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--window", type=int, default=16,
                    help="fixed decode-slot window (tokens)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--trim", action="store_true",
                    help="background MGD re-trim from request feedback")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    params = model_init(cfg, args.seed, device=args.device)
    S = args.window

    def predict_fn(p, batch):
        return model_forward(p, cfg, {"tokens": batch["tokens"]})[:, -1, :]

    trim = None
    if args.trim:
        trim = TrimConfig(
            DriverConfig(dtheta=1e-3, eta=2e-3, probes=4, mode="central",
                         seed=args.seed),
            lambda p, b: model_loss(p, cfg, b))

    svc_cfg = ServiceConfig(slots=4, batch_window_s=0.002, min_fill=8,
                            trim_batch=4, publish_every=10, seed=args.seed)

    # ragged client prompts (the reference's draws), padded caller-side
    # into the fixed window
    key = rng.prng_key(args.seed + 1)
    lengths = np.random.default_rng(args.seed + 2).integers(
        5, S + 1, args.requests)
    prompts = [rng.randint(rng.fold_in(key, i), (int(n),), 0, cfg.vocab,
                           device="cpu").numpy().astype(np.int32)
               for i, n in enumerate(lengths)]

    with serve(svc_cfg, predict_fn, params, trim=trim, start=False) as svc:
        t0 = time.time()
        futs = []
        for p in prompts:
            window = np.zeros(S, p.dtype)
            window[-len(p):] = p[-S:]           # left-pad into the slot
            feedback = {"labels": np.roll(window, -1)} if args.trim else None
            futs.append(svc.submit({"tokens": window}, feedback=feedback))
        results = [f.result(timeout=120) for f in futs]
        if args.trim:                           # let the trainer catch up
            deadline = time.time() + 60
            while (svc.stats()["trim_global_step"] < 16
                   and time.time() < deadline):
                time.sleep(0.02)
        svc.fence()
        stats = svc.stats()
        dt = time.time() - t0

    print(f"[serve] {cfg.name}: {len(results)} requests in {dt:.2f}s "
          f"({len(results) / dt:.1f} req/s), "
          f"p50={stats['latency_p50_ms']:.2f}ms "
          f"p99={stats['latency_p99_ms']:.2f}ms, "
          f"param version {stats['version']}"
          + (f", {stats['trim_global_step']} trim steps" if args.trim else ""))
    for i in range(min(3, len(results))):
        r = results[i]
        top = np.argsort(np.asarray(r.output))[-3:][::-1]
        print(f"  req{i} ({len(prompts[i])} prompt toks, v{r.version}) "
              f"top-3 next tokens -> {top.tolist()}")
    return stats


if __name__ == "__main__":
    main()
