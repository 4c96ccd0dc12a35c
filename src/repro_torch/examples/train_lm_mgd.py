"""End-to-end driver: train a transformer LM with MGD for a few hundred
steps, with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_mgd   # ~6M params
    PYTHONPATH=src python -m repro_torch.examples.train_lm_mgd --scale 100m

The model is a qwen3-family decoder (RMSNorm/GQA/SwiGLU/RoPE); data is
the synthetic Zipf-Markov stream; the optimizer is central-difference MGD
with probe averaging.  Kill it halfway and re-run: it resumes from the
checkpoint onto the same trajectory.  Runs on the card unless
``--device cpu``.
"""
import argparse
import os
import tempfile

from repro_torch.api import DriverConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.utils import tree_leaves
from repro_torch.data.pipeline import lm_sampler
from repro_torch.models import model_init, model_loss
from repro_torch.training.train_loop import TrainLoopConfig, train_mgd

SCALES = {
    # d_model, layers, heads, kv, d_head, d_ff  (≈ params with vocab 4096)
    "6m": (256, 4, 4, 2, 64, 1024),
    "25m": (512, 6, 8, 4, 64, 2048),
    "100m": (768, 12, 12, 4, 64, 3072),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="6m", choices=sorted(SCALES))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--probes", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "mgd_lm_ckpt"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    d, L, h, kv, dh, ff = SCALES[args.scale]
    cfg = get_smoke_config("qwen3-14b").replace(
        d_model=d, n_layers=L, n_heads=h, n_kv_heads=kv, d_head=dh,
        d_ff=ff, vocab=4096, attn_q_block=128, attn_kv_block=128)
    params = model_init(cfg, 0, device=args.device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"[lm] {args.scale} model: {n/1e6:.1f}M params, "
          f"{args.probes}-probe central MGD")

    mgd_cfg = DriverConfig(mode="central", dtheta=1e-3, eta=2e-3,
                           probes=args.probes, seed=0)
    sample_fn = lm_sampler(args.batch, args.seq, cfg.vocab, seed=1,
                           device=args.device)
    res = train_mgd(lambda p, b: model_loss(p, cfg, b), params, mgd_cfg,
                    sample_fn, args.steps,
                    loop=TrainLoopConfig(chunk=25,
                                         checkpoint_dir=args.ckpt_dir,
                                         checkpoint_every=100),
                    device=args.device)
    first, last = res.history[0][1]["cost"], res.history[-1][1]["cost"]
    print(f"[lm] cost {first:.4f} → {last:.4f} over {res.steps_done} steps"
          f" (checkpoints in {args.ckpt_dir})")
    return res


if __name__ == "__main__":
    main()
