"""A one-card witness of an MGD step on a model too big for one card.

The witness never holds the whole model.  It redraws each part of it
with ``models.transformer.init_part`` (what ``model_init`` draws, one part
at a time: the embedding and head, or stacked layer l), uses the part and
drops it:

* ``redraw`` gives a part of the model at θ₀, or after given fused
  updates: each leaf takes the window-update kernel (B3) on its block,
  with the block's first index in the stacked leaf folded into the seed;
  the small leaves take the sign-last form.  So the witness follows a
  run step by step from its C̃s, still a part at a time;
* ``stream_cost`` is ``model_loss``;
* ``stream_probe`` is ``model_probe_costs``.  On the fused path it runs
  block by block through the perturbed-matmul kernels, with ``layer=l`` so
  the signs' seed shifts as for the stacked bank (``layers.pdense``).  For
  the families that materialize θ ± θ̃ (MoE), each part's θ ± θ̃ is formed
  at the part's offset in its stacked leaf.

Each runs with no mesh active, on ``device`` alone, whatever mesh the
caller has open.  On one device each is bitwise the whole-model route
(``tests/test_torch_stream.py``, ``chip_smoke.py`` phase 17d).  The
sharded steps on four cards are held against them
(``tests/torch_dist_worker.py cards_full``).  The families are the
attention ones that take tokens and have an untied head (dense GQA and
MoE).
"""
import torch

from repro_torch.core import perturbations as pert
from repro_torch.core.probe_parallel import pod_seed
from repro_torch.core.utils import (f32, leaf_id_tree, tree_flatten,
                                    tree_map, tree_unflatten)
from repro_torch.distributed.sharding import use_mesh
from repro_torch.kernels import ops as kops
from repro_torch.launch.specs import abstract_params
from repro_torch.models import layers
from repro_torch.models import transformer as tt


def _one_card(fn):
    """``fn`` run with no mesh active (a caller's mesh would place the
    model's activations)."""
    def run(*args, **kwargs):
        with use_mesh(None):
            return fn(*args, **kwargs)
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


def _check(cfg):
    if cfg.family not in ("dense", "moe") or cfg.use_mla \
            or cfg.tie_embeddings or cfg.n_codebooks:
        raise ValueError(f"{cfg.name}: the witness takes dense GQA and MoE "
                         f"decoders with tokens and an untied head")


def leaf_ids(cfg):
    """The leaf ids of ``model_init(cfg, ...)``'s whole tree."""
    return leaf_id_tree(abstract_params(cfg))


def _forward_cost(cfg, emb, layer_of, batch):
    """``model_loss`` of the embedding part ``emb`` and the layers
    ``layer_of(l)``, each asked for once, in order."""
    x = tt._embed_tokens(emb, cfg, batch)
    b, s, _ = x.shape
    positions = tt._positions(cfg, batch, s, b, x.device)
    for layer in range(cfg.n_layers):
        x, _ = tt.block_apply(layer_of(layer), x, positions, cfg)
    x = layers.rmsnorm(emb["ln_f"], x, cfg.norm_eps)
    return tt._loss_from_logits(tt._logits(emb, cfg, x), batch["labels"])


@_one_card
def redraw(cfg, seed, part, *, device, updates=()):
    """Part ``part`` ("embed" or a layer index) of ``model_init(cfg,
    seed)`` on ``device``, after the fused updates ``updates``: (mcfg, n,
    C̃) of each step in order, each ``mgd.fused_update_tau1(mcfg, params,
    n, C̃)``'s part.  Each leaf takes B3 on its block of its stacked leaf
    (``mcfg.kernel_impl`` picks the kernel or its plain version), the
    embedding's 1-D leaves the sign-last form."""
    _check(cfg)
    tree = tt.init_part(cfg, seed, part, device=device)
    if not updates:
        return tree
    leaves, treedef = tree_flatten(tree)
    lids = tree_flatten(leaf_ids(cfg)["embed" if part == "embed"
                                      else "layers"])[0]
    for mcfg, n, c_tilde in updates:
        leaves = [_update_leaf(leaf, lid, part, mcfg, n, c_tilde)
                  for leaf, lid in zip(leaves, lids)]
    return tree_unflatten(treedef, leaves)


def _update_leaf(leaf, lid, part, mcfg, n, c_tilde):
    s = c_tilde * f32(1.0 / (mcfg.dtheta * mcfg.dtheta))
    lseed = pert.leaf_seed(pod_seed(mcfg.seed, 0), n // mcfg.tau_p, lid)
    if part == "embed" and leaf.dim() < 2:
        t = f32(-mcfg.eta) * (f32(mcfg.dtheta) * s)
        signs = pert.leaf_theta(leaf, lseed, 1.0, torch.float32)
        return (leaf.float() + signs * t).to(leaf.dtype)
    if part != "embed":
        lseed = pert.shifted_leaf_seed(lseed, part * leaf.numel())
    block = leaf if leaf.dim() >= 2 else leaf.reshape(1, -1)
    new = kops.mgd_update_window_group(
        [block], kops.seeds_tensor([[lseed]], block.device), s.reshape(1),
        alpha=-mcfg.eta, dtheta=mcfg.dtheta, impl=mcfg.kernel_impl)[0]
    return new.reshape(leaf.shape)


@_one_card
def stream_cost(cfg, seed, batch, *, device, updates=()):
    """``model_loss`` of ``model_init(cfg, seed)`` after ``updates`` (see
    ``redraw``) on ``batch``, the model redrawn a part at a time."""
    emb = redraw(cfg, seed, "embed", device=device, updates=updates)
    return _forward_cost(cfg, emb, lambda l: redraw(
        cfg, seed, l, device=device, updates=updates), batch)


def _perturbed_part(part, ids, probe, sign, layer=None):
    """θ ± θ̃ of a part, as ``perturbations.perturbed_tree`` forms it for
    the whole tree: stacked layer ``layer``'s leaves start ``layer``·numel
    into their stacked leaves; passes of at most ``THETA_CHUNK``
    elements."""
    def one(leaf, lid):
        start = 0 if layer is None else layer * leaf.numel()
        flat = leaf.reshape(-1)
        out = torch.empty_like(flat)
        for s in range(0, flat.numel(), pert.THETA_CHUNK):
            e = min(flat.numel(), s + pert.THETA_CHUNK)
            theta = pert.theta_range(probe.lseed(lid), start + s, start + e,
                                     probe.ctx.dtheta, leaf.dtype,
                                     leaf.device)
            out[s:e] = pert.apply_signed(flat[s:e], theta, sign)
        return out.reshape(leaf.shape)

    return tree_map(one, part, ids)


@_one_card
def stream_probe(cfg, seed, batch, probe, *, device, updates=()):
    """``model_probe_costs`` of ``model_init(cfg, seed)`` after
    ``updates`` (see ``redraw``): [n_signs] costs, the model redrawn a
    part at a time."""
    ids = leaf_ids(cfg)

    def part(p):
        return redraw(cfg, seed, p, device=device, updates=updates)

    emb = part("embed")
    if tt.supports_fused_probe(cfg):
        xs = layers.pembed(emb["tok"], batch["tokens"], ids["embed"]["tok"],
                           probe)
        b, s, _ = xs[0].shape
        positions = tt._positions(cfg, batch, s, b, xs[0].device)
        for layer in range(cfg.n_layers):
            xs = tt._pblock_apply(part(layer), xs, positions, cfg,
                                  ids["layers"], probe, layer)
        xs = layers.prmsnorm(emb["ln_f"], xs, ids["embed"]["ln_f"], probe,
                             eps=cfg.norm_eps)
        logits = layers.pdense(emb["head"], xs, ids["embed"]["head"], probe)
        return torch.stack([tt._loss_from_logits(lg, batch["labels"])
                            for lg in logits])
    costs = []
    for sign in probe.ctx.signs:
        emb_s = _perturbed_part(emb, ids["embed"], probe, sign)
        costs.append(_forward_cost(
            cfg, emb_s, lambda l: _perturbed_part(
                part(l), ids["layers"], probe, sign, layer=l), batch))
        del emb_s
    return torch.stack(costs)
