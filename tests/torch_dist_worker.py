"""Rank bodies of ``tests/test_torch_distributed.py``'s gloo worlds, and
the same (2, 2) worlds over NCCL on four cards.

Run as ``python tests/torch_dist_worker.py SCENARIO RANK WORLD DIR``:
each rank joins a gloo world through a file store in DIR, reads its
inputs from ``DIR/inputs.npz`` where the scenario has any, and rank 0
writes ``DIR/out.pt`` (and ``DIR/out.json``).  Imports torch and
repro_torch only; the test compares the outputs with the reference.

On a host with four cards, ``python tests/torch_dist_worker.py cards
DIR`` runs the ``cards4`` scenario: four NCCL ranks, one a card, with
the 4-rank world's pods (every layout, fused and unfused) against
``LocalMesh`` on each card, the fused step on a (2, 2) ("data", "model")
mesh with its kernels on the shards against the unsharded fused step,
and the dry run's collective bytes for the smoke train cell against the
bytes the real step sends; it prints the record and exits 1 if a check
fails.

``python tests/torch_dist_worker.py cards_full DIR`` runs a model too big
for one card on four cards (``cards_full4`` ranks, a (2, 2) ("data",
"model") mesh): qwen2-72b at full width and depth under the default
rules and llama4-scout under ``MOE_EP_RULES`` at the depth the mesh's
peaks allow, each made by the sharded init, served and trained (fused
central and forward steps), held against a one-card witness that
redraws the model a part at a time (``tests/torch_witness.py``), and
the dry run's qwen2-72b cell run for real against the dry run's
collective bytes.  For each MoE model it also records, at step 1, every
block's output and layer 0's attention probabilities on the mesh and on
the witness (routed as the mesh's), and it runs llama4-scout in bf16 at
the f32 control's depth.  It prints the card line, a summary and the
checks, writes the whole record to ``DIR/cards_full.json`` and exits 1
if a check or a rank fails.
"""
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)
# the port's sources and chip_smoke.py's gates, for a launch without
# PYTHONPATH (``cards``, ``cards_full``)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, "src"), _ROOT]

from repro_torch.core import perturbations as pert  # noqa: E402
from repro_torch.core.utils import (tree_flatten, tree_leaves,  # noqa: E402
                                    tree_map)
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.world import close_world, init_world  # noqa: E402


def _flat(tree):
    return torch.cat([shd.full(x).detach().reshape(-1).float()
                      for x in tree_leaves(tree)])


def _bitwise(a, b):
    return all(torch.equal(shd.full(x), y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def signs_on_shards(mesh):
    """generate / generate_signs_only / perturbed_tree on every leaf of
    the qwen3 smoke tree placed by param_shardings: full_tensor() ≡ the
    unsharded result, and each local shard ≡ its slice."""
    import repro_torch as rt
    from repro_torch.launch import specs
    cfg = rt.get_smoke_config("qwen3-14b")
    params = rt.model_init(cfg, 0, device="cpu")
    placed = shd.device_put(params, specs.param_shardings(cfg, mesh))
    out = {}
    n_sharded = sum(any(p.is_shard() for p in x.placements)
                    for x in tree_leaves(placed))
    for ptype in pert.PERTURBATION_TYPES:
        kw = dict(ptype=ptype, step=7, seed=3, dtheta=1e-2, tau_p=2)
        out[f"generate/{ptype}"] = _bitwise(pert.generate(placed, **kw),
                                            pert.generate(params, **kw))
    out["signs_only"] = _bitwise(
        pert.generate_signs_only(placed, step=5, seed=1),
        pert.generate_signs_only(params, step=5, seed=1))
    for sign in (1.0, -1.0):
        kw = dict(step=4, seed=9, dtheta=1e-2, sign=sign, chunk=100)
        out[f"perturbed_tree/{sign}"] = _bitwise(
            pert.perturbed_tree(placed, **kw),
            pert.perturbed_tree(params, **kw))
    return out, n_sharded


def dense_family(mesh):
    """The dense cut's smoke models on the mesh: loss, prefill logits
    and one decode step against the unsharded model."""
    import repro_torch as rt
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    out = {}
    g = np.random.default_rng(0)
    for arch in ("qwen3-14b", "mistral-nemo-12b", "granite-34b",
                 "qwen2-72b", "qwen2-vl-2b", "musicgen-medium"):
        cfg = rt.get_smoke_config(arch).replace(dtype="float32")
        params = rt.model_init(cfg, 0, device="cpu")
        b, s = 4, 16
        if cfg.family in ("vlm", "audio") and arch != "musicgen-medium":
            batch = {"embeds": torch.from_numpy(
                g.standard_normal((b, s, cfg.d_model)).astype(np.float32))}
        elif cfg.n_codebooks:
            batch = {"tokens": torch.from_numpy(g.integers(
                0, cfg.vocab, (b, cfg.n_codebooks, s)).astype(np.int32))}
        else:
            batch = {"tokens": torch.from_numpy(
                g.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
        if cfg.n_codebooks:
            labels = batch["tokens"].permute(0, 2, 1).contiguous()
        else:
            labels = torch.from_numpy(
                g.integers(0, cfg.vocab, (b, s)).astype(np.int32))
        full_batch = dict(batch, labels=labels)
        want = rt.model_loss(params, cfg, full_batch)
        wl, wc = rt.model_prefill(params, cfg, batch, s + 2)
        with shd.use_mesh(mesh):
            placed = shd.device_put(params, specs.param_shardings(cfg, mesh))
            got = rt.model_loss(placed, cfg, shard_batch(full_batch, mesh))
            gl, gc = rt.model_prefill(placed, cfg, shard_batch(batch, mesh),
                                      s + 2)
        rec = {"loss": float(got), "loss_ref": float(want),
               "prefill": float((shd.full(gl) - wl).abs().max())}
        if "tokens" in batch:
            # two decode steps: the second reads the first's cache write
            errs = []
            for tok in (batch["tokens"][..., -1], batch["tokens"][..., 0]):
                wd, wc = rt.model_decode(params, cfg, tok, wc)
                with shd.use_mesh(mesh):
                    gd, gc = rt.model_decode(placed, cfg, tok, gc)
                errs.append(float((shd.full(gd) - wd).abs().max()))
            rec["decode"] = max(errs)
        out[arch] = rec
    return out


FAMILIES = ("llama4-scout-17b-a16e", "deepseek-v3-671b", "rwkv6-7b",
            "zamba2-7b", "llama4-scout-17b-a16e/moe_ep")


def _rel(got, want):
    """max |got − want| over max(|want|, 1)."""
    got, want = shd.full(got).float(), want.float()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1.0))


def families(mesh):
    """MoE, MLA and the recurrent families' smoke models on the mesh:
    loss, prefill logits, two decode steps and one unfused MGD step's C̃
    against the unsharded model (``/moe_ep``: under ``MOE_EP_RULES``,
    experts over "model" and the dense parts FSDP over both axes)."""
    import repro_torch as rt
    from repro_torch.core import MGDConfig, build_mgd_step, mgd_init
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    out = {}
    g = np.random.default_rng(2)
    for case in FAMILIES:
        arch, _, rule_set = case.partition("/")
        rules = shd.RULE_SETS[rule_set] if rule_set else None
        cfg = rt.get_smoke_config(arch).replace(dtype="float32")
        params = rt.model_init(cfg, 0, device="cpu")
        b, s = 4, 16
        batch = {"tokens": torch.from_numpy(
            g.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
        full_batch = dict(batch, labels=torch.from_numpy(
            g.integers(0, cfg.vocab, (b, s)).astype(np.int32)))
        want = rt.model_loss(params, cfg, full_batch)
        wl, wc = rt.model_prefill(params, cfg, batch, s + 2)
        with shd.use_mesh(mesh, rules):
            placed = shd.device_put(params, specs.param_shardings(cfg, mesh))
            got = rt.model_loss(placed, cfg, shard_batch(full_batch, mesh))
            gl, gc = rt.model_prefill(placed, cfg, shard_batch(batch, mesh),
                                      s + 2)
        rec = {"loss": abs(float(got) - float(want)) / abs(float(want)),
               "prefill": _rel(gl, wl), "decode": 0.0,
               "sharded": sum(any(p.is_shard() for p in x.placements)
                              for x in tree_leaves(placed))}
        for tok in (batch["tokens"][:, -1], batch["tokens"][:, 0]):
            wd, wc = rt.model_decode(params, cfg, tok, wc)
            with shd.use_mesh(mesh, rules):
                gd, gc = rt.model_decode(placed, cfg, tok, gc)
            rec["decode"] = max(rec["decode"], _rel(gd, wd))
        mc = MGDConfig(dtheta=1e-2, eta=0.1, mode="central")
        step = build_mgd_step(lambda p, bt: rt.model_loss(p, cfg, bt), mc)
        _, _, wm = step(params, mgd_init(params, mc), full_batch)
        with shd.use_mesh(mesh, rules):
            _, _, gm = step(placed, mgd_init(placed, mc),
                            shard_batch(full_batch, mesh))
        rec["c_tilde"] = abs(float(gm["c_tilde"]) - float(wm["c_tilde"])) \
            / abs(float(wm["cost"]))
        out[case] = rec
    return out


def fused_steps():
    """The fused step (central, forward, replay) on (2, 4) and (4, 2)
    meshes, weights split by columns (wq, gate/up) and by rows (wo,
    down): against the unfused step on the same mesh and the unsharded
    fused step, and the fused update given the same C̃; ``central_fsdp``
    also splits every weight over "data", the batch's axis, which the
    product gathers (FSDP) where a partial sum would turn the batch split
    into a K split."""
    import repro_torch as rt
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.core import MGDConfig, build_mgd_step, mgd_init
    from repro_torch.core.mgd import fused_update_tau1
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    from repro_torch.models.layers import _shard_product
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, _step_cfg().vocab, (4, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}

    def run(mc, cfg, p, b, n):
        step = build_mgd_step(lambda p_, b_: rt.model_loss(p_, cfg, b_), mc,
                              probe_fn=rt.make_transformer_probe_fn(cfg))
        state = mgd_init(p, mc)
        cts, costs = [], []
        for _ in range(n):
            p, state, m = step(p, state, b)
            cts.append(float(m["c_tilde"]))
            costs.append(float(m["cost"]))
        return p, cts, costs

    out = {}
    modes = {"central": dict(mode="central"), "forward": dict(mode="forward"),
             "replay": dict(mode="central", replay=True, tau_theta=2)}
    cases = [(shape, name, kw, False) for shape in ((2, 4), (4, 2))
             for name, kw in modes.items()]
    cases.append(((2, 4), "central_fsdp", modes["central"], True))
    for shape, name, kw, fsdp in cases:
        cfg = _step_cfg().replace(dtype="float32", fsdp=fsdp)
        params = rt.model_init(cfg, 0, device="cpu")
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        with shd.use_mesh(mesh):
            placed = shd.device_put(params, specs.param_shardings(cfg, mesh))
            sb = shard_batch(batch, mesh)
        cols = rows = 0
        for x in tree_leaves(placed):
            cols += any(p.is_shard(x.dim() - 1) for p in x.placements)
            rows += any(p.is_shard(x.dim() - 2) for p in x.placements
                        if x.dim() >= 2)
        mc = MGDConfig(dtheta=1e-2, eta=0.1, fused=True, **kw)
        n = 2 if kw.get("replay") else 1     # replay updates at 2
        want, wct, wcost = run(mc, cfg, params, batch, n)
        with shd.use_mesh(mesh):
            got, gct, _ = run(mc, cfg, placed, sb, n)
            unf, uct, _ = run(dataclasses.replace(mc, fused=False), cfg,
                              placed, sb, n)
        rec = {"c_tilde": max(abs(a - b) / abs(c) for a, b, c
                              in zip(gct, wct, wcost)),
               "fused_is_unfused": gct == uct and _bitwise(
                   got, tree_map(shd.full, unf)),
               "cols": cols, "rows": rows}
        if name != "replay":
            c = torch.tensor(wct[0])
            with shd.use_mesh(mesh):
                upd = fused_update_tau1(mc, placed, 0, c)
            rec["update_bitwise"] = _bitwise(
                upd, fused_update_tau1(mc, params, 0, c))
        if fsdp:
            # wq-like (rows over "data", columns over "model") and wo-like
            # (columns over "data", rows over "model") products of a batch
            # split over "data": W gathered over "data", the batch kept
            x = distribute_tensor(torch.ones(4, 2, 8), mesh,
                                  [Shard(0), Replicate()])
            xo = distribute_tensor(torch.ones(4, 2, 8), mesh,
                                   [Shard(0), Shard(2)])
            w = torch.ones(8, 8)
            _, wq, pq = _shard_product((x,), distribute_tensor(
                w, mesh, [Shard(0), Shard(1)]))
            _, wo, po = _shard_product((xo,), distribute_tensor(
                w, mesh, [Shard(1), Shard(0)]))
            rec["gathers"] = (
                tuple(wq.placements) == (Replicate(), Shard(1))
                and pq == (Shard(0), Shard(2))
                and tuple(wo.placements) == (Replicate(), Shard(0))
                and po == (Shard(0), Partial()))
        out[f"{shape[0]}x{shape[1]}/{name}"] = rec
    return out


def _step_cfg():
    import repro_torch as rt
    return rt.get_smoke_config("qwen3-14b").replace(
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16, vocab=128)


def sharded_step(mesh, steps=30):
    """The reference's smoke model's MGD step on the mesh against the
    port's unsharded step from the same state."""
    import repro_torch as rt
    from repro_torch.core import MGDConfig, build_mgd_step, mgd_init
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    cfg = _step_cfg()
    mgd_cfg = MGDConfig(dtheta=1e-2, eta=0.1)
    params = rt.model_init(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}

    def loss_fn(p, b):
        return rt.model_loss(p, cfg, b)

    def run(p, b, n, mesh_=None):
        step = build_mgd_step(loss_fn, mgd_cfg)
        state = mgd_init(p, mgd_cfg)
        rec = {"cost": [], "c_tilde": [], "params": []}
        for _ in range(n):
            p, state, m = step(p, state, b)
            rec["cost"].append(float(m["cost"]))
            rec["c_tilde"].append(float(m["c_tilde"]))
            rec["params"].append(_flat(p).cpu())
        return rec

    ref = run(params, batch, steps)
    with shd.use_mesh(mesh):
        placed = shd.device_put(params, specs.param_shardings(cfg, mesh))
        got = run(placed, shard_batch(batch, mesh), steps)
    # the update given the same C̃: the step's two cost reads replayed
    reads = []

    def recording(p, b):
        c = loss_fn(p, b)
        reads.append(c)
        return c

    step = build_mgd_step(recording, mgd_cfg)
    want, _, _ = step(params, mgd_init(params, mgd_cfg), batch)
    replay = iter(list(reads))
    step = build_mgd_step(lambda p, b: next(replay), mgd_cfg)
    with shd.use_mesh(mesh):
        new, _, m = step(placed, mgd_init(placed, mgd_cfg),
                         shard_batch(batch, mesh))
    same = _bitwise(new, want)
    placed_sharded = sum(any(pl.is_shard() for pl in x.placements)
                         for x in tree_leaves(placed))
    return {"ref": ref, "got": got, "update_bitwise": same,
            "n_sharded": placed_sharded}


def elastic(mesh8, d):
    """Save from the (2, 4) mesh; restore onto (4, 2) and onto no mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import checkpoint as ckpt
    params = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
              "b": torch.arange(8, dtype=torch.bfloat16)}
    sh1 = {"w": shd.NamedSharding(mesh8, shd.P("data", "model")),
           "b": shd.NamedSharding(mesh8, shd.P("model"))}
    ckpt.save(os.path.join(d, "sharded"), 3, shd.device_put(params, sh1))
    if torch.distributed.get_rank() == 0:
        ckpt.save(os.path.join(d, "plain"), 3, params)
    mesh2 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    sh2 = {"w": shd.NamedSharding(mesh2, shd.P("model", "data")),
           "b": shd.NamedSharding(mesh2, shd.P("data"))}
    p2, _, step = ckpt.restore(os.path.join(d, "sharded"), params,
                               shardings=sh2)
    p3, _, _ = ckpt.restore(os.path.join(d, "sharded"), params)
    return {"onto_4x2": _bitwise(p2, params),
            "placements_4x2": [str(p2["w"].placements),
                               str(p2["b"].placements)],
            "onto_none": _bitwise(p3, params),
            "plain_leaves": all(type(x) is torch.Tensor
                                for x in tree_leaves(p3)),
            "step": step}


def mesh8(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    signs, n_sharded = signs_on_shards(mesh)
    out = {"signs": signs, "signs_n_sharded": n_sharded,
           "dense": dense_family(mesh),
           "families": families(mesh),
           "step": sharded_step(mesh),
           "fused": fused_steps(),
           "elastic": elastic(mesh, d)}
    return out


def _pod_runs(mesh, local_mesh, data_axis, inputs, fused, steps=36,
              device="cpu", **kw):
    """The XOR MLP's probe-parallel run with pods as ranks, and the same
    run on a LocalMesh in this process."""
    import repro_torch as rt
    from repro_torch.core import mse
    from repro_torch.models.simple import mlp_apply

    def t(name):
        return torch.from_numpy(inputs[name]).to(device)

    p0 = [{"b": t("b0"), "w": t("w0")}, {"b": t("b1"), "w": t("w1")}]
    batch = {"x": t("x"), "y": t("y")}
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3,
                          fused=fused)

    def loss(p, b):
        return mse(mlp_apply(p, b["x"]), b["y"])

    if fused:
        kw["probe_fn"] = rt.make_mlp_probe_fn()
    recs = []
    for m in (mesh, local_mesh):
        drv = rt.driver("probe_parallel", cfg, loss, mesh=m,
                        data_axis=data_axis, device=device, **kw)
        p, s = p0, drv.init(p0)
        rec = {"c_tilde": [], "cost": [], "params": []}
        for _ in range(steps):
            p, s, aux = drv.step(p, s, batch)
            rec["c_tilde"].append(float(aux["c_tilde"]))
            rec["cost"].append(float(aux["cost"]))
            rec["params"].append(_flat(p).cpu())
        rec["sharded_leaves"] = sum(
            shd.is_dtensor(x) and any(pl.is_shard() for pl in x.placements)
            for x in tree_leaves(p))
        recs.append(rec)
    return recs


SLICE = {"qwen2-72b": None, "llama4-scout-17b-a16e": "moe_ep"}
SLICE_STEPS = 3


def slice_cfg(arch):
    """The smoke config as the four-card slice runs its full one
    (``fsdp=True``)."""
    import repro_torch as rt
    return rt.get_smoke_config(arch).replace(fsdp=True)


def sharded_inits(mesh):
    """``model_init(..., shardings=)`` against ``device_put`` of the whole
    init, for the slice's two configs under their rules: every leaf's
    placements, global and local values bitwise."""
    import repro_torch as rt
    from repro_torch.launch import specs
    out = {}
    for arch, rules in SLICE.items():
        cfg = slice_cfg(arch)
        with shd.use_mesh(mesh, shd.RULE_SETS[rules] if rules else None):
            sh = specs.param_shardings(cfg, mesh)
            got = rt.model_init(cfg, 3, device="cpu", shardings=sh)
            want = shd.device_put(rt.model_init(cfg, 3, device="cpu"), sh)
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
        out[arch] = dict(
            bitwise=all(tuple(a.placements) == tuple(b.placements)
                        and a.shape == b.shape and a.stride() == b.stride()
                        and torch.equal(a.to_local(), b.to_local())
                        and torch.equal(a.full_tensor(), b.full_tensor())
                        for a, b in pairs),
            sharded=sum(any(p.is_shard() for p in a.placements)
                        for a, _ in pairs), leaves=len(pairs))
    return out


def slice_steps(mesh, inputs):
    """The slice's fused central step (the dry run's Δθ = 1e-3, η = 1e-2)
    on the (2, 2) mesh under each config's rules, from the reference's
    params and batch (``inputs``): C̃, cost and params of each step."""
    import repro_torch as rt
    from repro_torch import convert
    from repro_torch.core import build_mgd_step, mgd_init
    from repro_torch.core.utils import tree_unflatten
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import default_mgd_config
    mc = dataclasses.replace(default_mgd_config("central"), fused=True)
    out = {}
    for arch, rules in SLICE.items():
        cfg = slice_cfg(arch)
        leaves, treedef = tree_flatten(specs.abstract_params(cfg))
        ref = tree_unflatten(treedef, [inputs[f"{arch}/leaf{i}"]
                                       for i in range(len(leaves))])
        params = convert.to_torch(ref, device="cpu")
        toks = torch.from_numpy(inputs[f"{arch}/tokens"])
        step = build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mc,
                              probe_fn=rt.make_transformer_probe_fn(cfg))
        rec = {"c_tilde": [], "cost": [], "params": []}
        with shd.use_mesh(mesh, shd.RULE_SETS[rules] if rules else None):
            p = shd.device_put(params, specs.param_shardings(cfg, mesh))
            b = shard_batch({"tokens": toks, "labels": toks}, mesh)
            state = mgd_init(p, mc)
            for _ in range(SLICE_STEPS):
                p, state, m = step(p, state, b)
                rec["c_tilde"].append(float(m["c_tilde"]))
                rec["cost"].append(float(m["cost"]))
                rec["params"].append(_flat(p))
        rec["sharded"] = sum(any(pl.is_shard() for pl in x.placements)
                             for x in tree_leaves(p))
        out[arch] = rec
    return out


BF16_ARCH = "llama4-scout-17b-a16e"
BF16_ROWS = 2      # 2 × 16 tokens: one MoE group, so every rank routes it
BF16_STEPS = 2


def bf16_ulps(got, want):
    """max |got − want| in bf16 ulps of max |want| (2⁻⁷ of its binade)."""
    got, want = shd.full(got).float(), shd.full(want).float()
    top = float(want.abs().max())
    if top == 0.0:
        return float((got - want).abs().max())
    return float((got - want).abs().max()) / 2.0 ** (
        np.floor(np.log2(top)) - 7)


class _Taps:
    """The outputs of the model's modules while active, in call order:
    each attention projection and the head (``transformer.dense``), the
    shared expert's products (``layers.dense``), the router's logits
    (``moe.dense``), the MoE output, each block's output and the logits,
    each as (name, whole tensor, a pending ``Partial`` sum or not) — the
    mesh's gathered, so a run on the mesh and one without line up."""

    PROJ = ("wq", "wk", "wv", "wo")

    def __init__(self, n_layers):
        self.n_layers = n_layers

    def __enter__(self):
        from repro_torch.models import layers, moe, transformer as tr
        self.out, self._saved, count = [], [], {}

        def tap(mod, attr, name):
            orig = getattr(mod, attr)

            def wrapped(*a, **k):
                y = orig(*a, **k)
                i = count[name] = count.get(name, -1) + 1
                y0 = y[0] if isinstance(y, tuple) else y
                partial = shd.is_dtensor(y0) and any(
                    p.is_partial() for p in y0.placements)
                self.out.append((self._label(name, i), shd.full(y0)
                                 .detach().clone(), partial))
                return y
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)

        tap(tr, "dense", "attn")
        tap(layers, "dense", "shared")
        tap(moe, "dense", "router")
        tap(tr, "moe_apply", "moe")
        tap(tr, "block_apply", "block")
        tap(tr, "_logits", "logits")
        return self

    def _label(self, name, i):
        if name == "attn":
            if i >= 4 * self.n_layers:
                return "head"
            return f"layer{i // 4}/{self.PROJ[i % 4]}"
        if name == "shared":
            return f"layer{i // 3}/shared/{('gate', 'up', 'down')[i % 3]}"
        return name if name == "logits" else f"layer{i}/{name}"

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)


def bf16_modules(mesh, inputs):
    """llama4-scout's smoke config (``fsdp=True``) in bf16 under
    ``MOE_EP_RULES`` on the (2, 2) mesh against the unsharded port, from
    the reference's bf16 init and the same batch, the unsharded run's
    routing pinned to the mesh's (``_Routing``): every module's output
    (``_Taps``) in bf16 ulps at the loss at θ₀, whether each dense
    product was a pending ``Partial`` sum on the mesh, the loss, and the
    fused central step's C̃ and cost at steps 0 and 1 (the dry run's
    Δθ = 1e-3, η = 1e-2), step 1 taken by the unsharded port from the
    mesh's own θ₁ so that it reads the forward alone."""
    import repro_torch as rt
    from repro_torch.core import build_mgd_step, mgd_init
    from repro_torch.core.utils import tree_unflatten
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import default_mgd_config
    cfg = slice_cfg(BF16_ARCH).replace(dtype="bfloat16")
    leaves, treedef = tree_flatten(specs.abstract_params(cfg))
    params = tree_unflatten(treedef, [
        torch.from_numpy(inputs[f"{BF16_ARCH}/bf16/leaf{i}"].view(np.int16))
        .view(torch.bfloat16) if a.dtype == torch.bfloat16 else
        torch.from_numpy(inputs[f"{BF16_ARCH}/bf16/leaf{i}"])
        for i, a in enumerate(leaves)])
    toks = torch.from_numpy(inputs[f"{BF16_ARCH}/tokens"][:BF16_ROWS])
    batch = {"tokens": toks, "labels": toks}
    loss_fn = (lambda p, b: rt.model_loss(p, cfg, b))   # noqa: E731
    rules = shd.RULE_SETS["moe_ep"]
    with shd.use_mesh(mesh, rules):
        placed = shd.device_put(params, specs.param_shardings(cfg, mesh))
        sb = shard_batch(batch, mesh)
        with _Routing() as mlog, _Taps(cfg.n_layers) as mtap, \
                torch.no_grad():
            mesh_loss = float(loss_fn(placed, sb))
    with _Routing(mlog.ids) as ulog, _Taps(cfg.n_layers) as utap, \
            torch.no_grad():
        one_loss = float(loss_fn(params, batch))
    assert [n for n, _, _ in mtap.out] == [n for n, _, _ in utap.out]
    routing = _routing_gap(mlog, ulog)
    modules = {n: bf16_ulps(g, w) for (n, g, _), (_, w, _)
               in zip(mtap.out, utap.out)}
    partial = {n: p for n, _, p in mtap.out
               if n == "head" or n.split("/")[-1] in _Taps.PROJ
               or "/shared/" in n}
    mc = dataclasses.replace(default_mgd_config("central"), fused=True)
    step = build_mgd_step(loss_fn, mc,
                          probe_fn=rt.make_transformer_probe_fn(cfg))
    steps = []
    with shd.use_mesh(mesh, rules):
        p, state = placed, mgd_init(placed, mc)
        for n in range(BF16_STEPS):
            start = tree_map(shd.full, p)
            with _Routing() as mlog:
                p, state, m = step(p, state, sb)
            with shd.use_mesh(None), _Routing(mlog.ids):
                _, _, um = step(start, mgd_init(start, mc)._replace(step=n),
                                batch)
            steps.append(dict(mesh_c_tilde=float(m["c_tilde"]),
                              c_tilde=float(um["c_tilde"]),
                              mesh_cost=float(m["cost"]),
                              cost=float(um["cost"])))
    return dict(modules=modules, partial=partial, mesh_loss=mesh_loss,
                loss=one_loss, steps=steps, routing=routing)


def mesh4(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.probe_parallel import LocalMesh
    from repro_torch.distributed.pipeline import pipeline_forward
    inputs = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    pod4 = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    pod2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    for fused in (False, True):
        out[f"pod4/{fused}"] = _pod_runs(pod4, LocalMesh(pod=4), None,
                                         inputs, fused)
        out[f"pod2data2/{fused}"] = _pod_runs(
            pod2, LocalMesh(pod=2, data=2), "data", inputs, fused)
    # param_specs= on the unfused path: w's columns over "model"
    pm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "model"))
    for fused in (False, True):
        out[f"pod2model2_param_specs/{fused}"] = _pod_runs(
            pm, LocalMesh(pod=2), None, inputs, fused,
            param_specs=[(r"w$", (None, "model"))])
    # the four-card slice's pieces at smoke size on (2, 2)
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out["sharded_init"] = sharded_inits(dm)
    out["slice_steps"] = slice_steps(dm, inputs)
    out["bf16_modules"] = bf16_modules(dm, inputs)
    y = pipeline_forward(lambda w, x: torch.tanh(x @ w),
                         torch.from_numpy(inputs["ws"]),
                         torch.from_numpy(inputs["px"]), mesh=pod4,
                         axis="pod", microbatches=4)
    out["pipeline"] = y
    return out


def _xor_inputs():
    """The XOR MLP's params (seed 0) and its four examples, one a pod."""
    import repro_torch as rt
    p = rt.mlp_init(0, (2, 2, 1), device="cpu")
    x = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
    y = np.array([[0.], [1.], [1.], [0.]], np.float32)
    return dict(w0=p[0]["w"].numpy(), b0=p[0]["b"].numpy(),
                w1=p[1]["w"].numpy(), b1=p[1]["b"].numpy(),
                x=x.reshape(4, 1, 2), y=y.reshape(4, 1, 1))


SMOKE_CELL = dict(arch="qwen3-14b", seq=16, batch=8)


def cards4(rank, d):
    """Four NCCL ranks, one a card: the 4-rank world's pods, the fused
    step with its kernels on (2, 2) shards, the smoke train cell's
    collective bytes and seconds."""
    import repro_torch as rt
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels
    from repro_torch.core import build_mgd_step, mgd_init
    from repro_torch.core.mgd import fused_update_tau1
    from repro_torch.core.probe_parallel import LocalMesh
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    from repro_torch.launch.comm_bytes import CollectiveBytes
    from repro_torch.launch.dryrun import default_mgd_config
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": torch.cuda.get_device_name(dev)}
    inputs = _xor_inputs()
    pods = {}
    pod4 = init_device_mesh("cuda", (4,), mesh_dim_names=("pod",))
    pod2 = init_device_mesh("cuda", (2, 2), mesh_dim_names=("pod", "data"))
    pm = init_device_mesh("cuda", (2, 2), mesh_dim_names=("pod", "model"))
    for fused in (False, True):
        pods[f"pod4/{fused}"] = _pod_runs(pod4, LocalMesh(pod=4), None,
                                          inputs, fused, device=dev)
        pods[f"pod2data2/{fused}"] = _pod_runs(
            pod2, LocalMesh(pod=2, data=2), "data", inputs, fused,
            device=dev)
        pods[f"pod2model2_param_specs/{fused}"] = _pod_runs(
            pm, LocalMesh(pod=2), None, inputs, fused, device=dev,
            param_specs=[(r"w$", (None, "model"))])
    out["pods"] = {k: dict(
        bitwise=r["c_tilde"] == lo["c_tilde"] and all(
            torch.equal(a, b) for a, b in zip(r["params"], lo["params"])),
        c_tilde_max_diff=max(abs(a - b) for a, b in zip(r["c_tilde"],
                                                        lo["c_tilde"])),
        sharded_leaves=r["sharded_leaves"]) for k, (r, lo) in pods.items()}
    # the fused step on (2, 2) ("data", "model") shards, kernels on them
    dm = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    cfg = _step_cfg().replace(dtype="float32")
    params = rt.model_init(cfg, 0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    probe_fn = rt.make_transformer_probe_fn(cfg)
    fused = {}
    for name, kw in {"central": dict(mode="central"),
                     "forward": dict(mode="forward"),
                     "replay": dict(mode="central", replay=True,
                                    tau_theta=2)}.items():
        mc = rt.MGDConfig(dtheta=1e-2, eta=0.1, fused=True, **kw)
        step = build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mc,
                              probe_fn=probe_fn)

        def run(p, b):
            st, cts, costs = mgd_init(p, mc), [], []
            for _ in range(2):
                p, st, m = step(p, st, b)
                cts.append(float(m["c_tilde"]))
                costs.append(float(m["cost"]))
            return cts, costs

        want, costs = run(params, batch)
        with shd.use_mesh(dm):
            placed = shd.device_put(params, specs.param_shardings(cfg, dm))
            kernels.reset_launch_counts()
            got, _ = run(placed, shard_batch(batch, dm))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        rec = {"c_tilde": max(abs(a - b) / abs(c) for a, b, c
                              in zip(got, want, costs)),
               "launches": counts}
        if name != "replay":
            c = torch.tensor(want[0], device=dev)
            with shd.use_mesh(dm):
                upd = fused_update_tau1(mc, placed, 0, c)
            rec["update_bitwise"] = _bitwise(
                upd, fused_update_tau1(mc, params, 0, c))
        fused[name] = rec
    out["fused"] = fused
    # the dry run's smoke train cell, run for real: its collectives
    cfg = rt.get_smoke_config(SMOKE_CELL["arch"]).replace(dtype="bfloat16")
    mc = default_mgd_config("forward")
    step = build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mc)
    params = rt.model_init(cfg, 0, device=dev)
    toks = torch.zeros((SMOKE_CELL["batch"], SMOKE_CELL["seq"]),
                       dtype=torch.int32, device=dev)
    with shd.use_mesh(dm):
        placed = shd.device_put(params, specs.param_shardings(cfg, dm))
        b = shard_batch({"tokens": toks, "labels": toks}, dm)
        st = mgd_init(placed, mc)
        placed, st, _ = step(placed, st, b)          # warm-up
        coll = CollectiveBytes()
        with coll:
            placed, st, _ = step(placed, st, b)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            placed, st, _ = step(placed, st, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    c = coll.result()
    out["cell"] = dict(SMOKE_CELL,
                       collective_bytes_per_device=c["total_bytes"],
                       collective_by_type=c["by_type"],
                       n_collectives=len(c["ops"]),
                       step_s=sorted(times)[len(times) // 2])
    return out


DRY_CELL = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.distributed.world import close_world, fake_world
from repro_torch.launch import dryrun
cell = json.loads(sys.argv[1])
dryrun.get_config = lambda a: configs.get_smoke_config(a).replace(
    dtype="bfloat16")
dryrun.SHAPES = dict(configs.SHAPES, train_4k=configs.ShapeSpec(
    "train_4k", cell["seq"], cell["batch"], "train"))
fake_world(4)
mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(cell["arch"], "train_4k", multi_pod=False, mesh=mesh,
                      out_dir=None, device_type="cuda", verbose=False)
close_world()
print(json.dumps(rec))
"""


def cards(d):
    """``cards4`` on four cards, beside the dry run of its smoke cell on a
    fake world of four; prints the record, returns 1 if a check fails."""
    import subprocess
    os.makedirs(d, exist_ok=True)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    dry = subprocess.Popen([sys.executable, "-c", DRY_CELL,
                            json.dumps(SMOKE_CELL)], env=env,
                           stdout=subprocess.PIPE, text=True)
    ranks = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "cards4", str(r), "4", d], env=env)
             for r in range(4)]
    try:
        rcs = [p.wait(timeout=1200) for p in ranks]
        dry_out, _ = dry.communicate(timeout=1200)
    finally:
        for p in ranks + [dry]:
            if p.poll() is None:
                p.kill()
    if any(rcs) or dry.returncode:
        print(json.dumps({"ranks_rc": rcs, "dry_rc": dry.returncode}))
        return 1
    out = torch.load(os.path.join(d, "out.pt"), weights_only=False)
    rec = json.loads(dry_out.strip().splitlines()[-1])
    out["cell"]["dry_run_collective_bytes_per_device"] = \
        rec["collective_bytes_per_device"]
    out["cell"]["dry_run_by_type"] = rec["collective_by_type"]
    out["seconds"] = time.perf_counter() - t0
    out["checks"] = checks = dict(
        # the unfused step's row-split partial sums round apart from the
        # unsharded ones (the gloo test's 1e-6 of C̃); the rest is bitwise
        pods=all(v["bitwise"] or (k == "pod2model2_param_specs/False"
                                  and v["c_tilde_max_diff"] <= 1e-6)
                 for k, v in out["pods"].items()),
        param_specs_sharded=all(
            v["sharded_leaves"] > 0 for k, v in out["pods"].items()
            if "param_specs" in k),
        fused_c_tilde=all(v["c_tilde"] <= 1e-5
                          for v in out["fused"].values()),
        fused_update=all(v.get("update_bitwise", True)
                         for v in out["fused"].values()),
        fused_kernels=all(v["launches"]["mgd_update_window"] > 0
                          for v in out["fused"].values()),
        collective_bytes=out["cell"]["collective_bytes_per_device"]
        == rec["collective_bytes_per_device"])
    print(json.dumps(out, default=str))
    return 0 if all(checks.values()) else 1


# --- a model too big for one card, on four (cards_full) ---------------------

FULL_DEVICE, FULL_BACKEND = "cuda", "nccl"
FULL_SEED = 0
QWEN, LLAMA = "qwen2-72b", "llama4-scout-17b-a16e"
QWEN_LAYERS = 80
# the unfused forward step the dry run builds, run for real at the deepest
# qwen2-72b depth whose dry-run args + temp + alias per rank stay within
# 70 GiB: this eager step keeps the old params beside the new ones, which
# the dry run counts as written over them (alias, donated in the
# reference).  The dry run on a fake (2, 2) world at batch 8 × 64, fake
# tensors on the CPU: 29 layers 66.4 GiB, 30 layers 70.7 (args + temp
# alone: 37 layers 69.1, 38 71.8); fake CUDA tensors: 29 layers 67.4
DRY_LAYERS = 29
LLAMA_PROBE_LAYERS = (2, 4)  # the mesh's peaks here choose llama4's depth
LLAMA_MAX_LAYERS = 48
FREE_GB = 8.0                # each card keeps this much free at that depth
ONE_CARD_LLAMA4 = 8          # chip_smoke.py phase 17d: the deepest one
#                              card holds, extrapolated along the line
#                              through its peaks at 1, 2, 3 layers
INIT_SLACK_GB = 2.0          # init peak ≤ the rank's shards + a layer + this
FULL_BATCH, FULL_SEQ = 8, 64
CENTRAL_STEPS = 3            # fused central; GATED_STEPS of them held
FORWARD_STEPS = 2            # fused forward (B1): one counted, one timed
PROMPT, NEW = 32, 32         # launch/serve.py's 4 × 32 prompt, 32 tokens
FULL_TIMEOUT_S = 1500        # the ranks are stopped after this
CONTROL_POSITIONS = 4        # decode positions each gate control runs
# steps 0 and 1 are held against the witness; the controls must miss at
# step 1: from the random init qwen2-72b's 80-layer C̃ lies within 2⁻¹¹
# of the cost of 0 (0.82 of it on four H100s), where the
# C̃ = 0 control cannot miss; after one update the cost and C̃ have grown
GATED_STEPS = 2
CONTROL_STEP = 1


def _full_cfg(arch, n_layers, dtype=None):
    import repro_torch as rt
    cfg = rt.get_config(arch).replace(n_layers=n_layers)
    return cfg.replace(dtype=dtype) if dtype else cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _local_gb(tree):
    return sum(shd.local(x).numel() * shd.local(x).element_size()
               for x in tree_leaves(tree)) / 1e9


def _block(t, offset, shape):
    return t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _updates_bitwise(cfg, updates, params, dev):
    """Every local block of ``params`` (the mesh's params after
    ``updates`` from the sharded init) against the witness's part after
    them, a part redrawn at a time on this rank's card: (all bitwise,
    blocks held)."""
    import torch_witness as tw
    same, n = True, 0
    parts = [("embed", params["embed"])] + [
        (layer, params["layers"]) for layer in range(cfg.n_layers)]
    for part, tree in parts:
        want = tw.redraw(cfg, FULL_SEED, part, device=dev, updates=updates)
        for got, w in zip(tree_leaves(tree), tree_leaves(want)):
            local_shape, offset = pert.shard_layout(got)
            local = shd.local(got)
            if part != "embed":
                i = part - offset[0]
                if not 0 <= i < local_shape[0]:
                    continue
                local, local_shape, offset = local[i], local_shape[1:], \
                    offset[1:]
            same = same and torch.equal(local, _block(w, offset,
                                                      local_shape))
            n += 1
        del want
    return same, n


def _probe_ct(probe_fn, params, batch, n, seed, mc):
    """(C̃, cost) of step ``n``'s central probe pair from ``params``, probe
    seed ``seed``'s signs at ``mc``'s Δθ."""
    from repro_torch.core.probe_parallel import pod_seed
    with torch.no_grad():
        cp, cm = (float(c) for c in probe_fn(params, batch, pert.Probe(
            n, pod_seed(seed, 0), pert.ProbeCtx(signs=(1.0, -1.0),
                                                dtheta=mc.dtheta,
                                                tau_p=mc.tau_p))))
    return 0.5 * (cp - cm), 0.5 * (cp + cm)


class _Routing:
    """Every MoE routing while active (``moe._gates`` wrapped): in
    ``calls`` each token's own first expert and router margin (top-1 −
    top-2 probability), in ``ids`` the expert ids it was sent to.  With
    ``pin`` (one expert-id tensor a call, in token order, −1 where free)
    call i sends its tokens to ``pin[i]``'s experts instead of its own
    top-k, their gates its own probabilities there renormalized as
    ``moe._gates`` does: the routes of another run's, so that a near tie
    that its rounding breaks the other way does not part the two."""

    def __init__(self, pin=None):
        self.pin = pin

    def __enter__(self):
        from repro_torch.core.utils import f32
        from repro_torch.models import moe
        self.calls, self.ids, self._gates = [], [], moe._gates

        def gates(probs, k):
            g, idx = self._gates(probs, k)
            top = torch.topk(probs.float(), 2, dim=-1).values
            self.calls.append((idx[..., 0].reshape(-1).cpu(),
                               (top[..., 0] - top[..., 1]).reshape(-1)
                               .cpu()))
            if self.pin is not None:
                want = self.pin[len(self.calls) - 1].to(idx.device) \
                    .reshape(idx.shape)
                idx = torch.where(want >= 0, want, idx)
                vals = probs.gather(-1, idx)
                g = vals / (vals.sum(-1, keepdim=True) + f32(1e-9))
            self.ids.append(idx.cpu())
            return g, idx

        moe._gates = gates
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._gates = self._gates


def _routing_gap(mesh_log, one_log):
    """Where the mesh's routing and the one card's own part: per routing
    call (a layer, in order) the tokens whose first expert differs, and
    the one card's router margin at those tokens; ``calls`` counts each
    side's routing calls (equal when the runs match)."""
    flips, margins, first = [], [], None
    for layer, ((ei, _), (wi, wm)) in enumerate(zip(mesh_log.calls,
                                                    one_log.calls)):
        if ei.shape != wi.shape:
            return dict(shapes=[tuple(ei.shape), tuple(wi.shape)])
        diff = ei != wi
        flips.append(int(diff.sum()))
        if flips[-1] and first is None:
            first = layer
            margins = sorted(float(m) for m in wm[diff])
    return dict(calls=[len(mesh_log.calls), len(one_log.calls)],
                decisions=sum(int(w.numel()) for w, _ in one_log.calls),
                flips_per_layer=flips, first_flip_layer=first,
                first_layer_flip_margins=margins[:8],
                median_margin_first_layer=float(
                    one_log.calls[0][1].median()) if one_log.calls else None)


def _attention_probs(q, k):
    """Causal softmax(q·kᵀ/√d) in f32 of q [B, S, H, d], k [B, S, KVH,
    d] (each query head reading its group's key head): [B, H, S, S]."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    q = q.float().reshape(b, s, kvh, h // kvh, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k.float()) / dh ** 0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return torch.softmax(scores.masked_fill(~mask, float("-inf")), -1) \
        .reshape(b, h, s, s)


class _Hidden:
    """Each block's output and layer 0's attention probabilities while
    active (``transformer.block_apply`` and the first ``_qkv`` wrapped),
    whole tensors (gathered on a mesh): the per-layer gap of two routes
    of one forward."""

    def __enter__(self):
        from repro_torch.models import transformer as tr
        self.blocks, self.probs = [], None
        self._block, self._qkv = tr.block_apply, tr._qkv

        def block(*a, **k):
            x, cache = self._block(*a, **k)
            self.blocks.append(shd.full(x).detach())
            return x, cache

        def qkv(*a, **k):
            q, kk, v = self._qkv(*a, **k)
            if self.probs is None:
                self.probs = _attention_probs(shd.full(q), shd.full(kk))
            return q, kk, v

        tr.block_apply, tr._qkv = block, qkv
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tr
        tr.block_apply, tr._qkv = self._block, self._qkv


def _hidden_gap(mesh, one):
    """The per-layer gap of the hidden state (bf16 ulps of each block
    output's largest value), the first layer past one ulp (the rounding
    of one product), and layer 0's attention probabilities' largest
    gap."""
    ulps = [bf16_ulps(a, b) for a, b in zip(mesh.blocks, one.blocks)]
    return dict(layer_ulps=ulps, layers=[len(mesh.blocks), len(one.blocks)],
                first_layer_past_one_ulp=next(
                    (i for i, u in enumerate(ulps) if u > 1.0), None),
                attn_probs_layer0_max_gap=float(
                    (mesh.probs - one.probs).abs().max()))


def _witness_rel(cfg):
    """The witness gate's tolerance in units of the cost: chip_smoke.py's
    LM gate (2⁻¹¹) in bf16, its f32 MoE gate (2⁻¹⁶) in f32."""
    from chip_smoke import LM_CT_REL, MOE_DECODE_REL
    return {"bfloat16": LM_CT_REL, "float32": MOE_DECODE_REL}[cfg.dtype]


def _pinned(routes, i):
    """Routing pinned to the mesh's i-th logged run (an MoE model), else
    nothing."""
    return _Routing(routes[i].ids) if routes else contextlib.nullcontext()


def _witness_gate(cfg, mc, batch, mesh_rec, updates, dev):
    """Rank 0's one-card witness: the cost at θ₀ and, at each gated step
    n, the central probe pair from the model after the mesh's first n
    updates (``torch_witness.redraw``), the model streamed a part at a
    time.  The mesh's numbers against them in tolerances of
    ``_witness_rel`` of the cost, with the gate's two controls (C̃ = 0,
    another seed's C̃ on the mesh from the same params).  An MoE model's
    witness routes each token as the mesh's same run did (``_Routing``
    pinned to the mesh's logs), and records where its own routing would
    have parted from the mesh's."""
    import torch_witness as tw
    rel = _witness_rel(cfg)
    routes = mesh_rec.pop("routes", None)
    hidden = mesh_rec.pop("hidden", None)
    t0 = time.perf_counter()
    with torch.no_grad(), _pinned(routes, 0) as log:
        loss = float(tw.stream_cost(cfg, FULL_SEED, batch, device=dev))
    out = dict(loss=loss, mesh_loss=mesh_rec["loss0"], rel=rel,
               loss_err_in_tol=abs(mesh_rec["loss0"] - loss)
               / (rel * abs(loss)), steps=[])
    if routes:
        out["routing"] = _routing_gap(routes[0], log)
    if hidden:
        # the forward at θ after CONTROL_STEP updates, routed as the
        # mesh's: each block's output and layer 0's attention
        mesh_hidden, route = hidden
        with torch.no_grad(), _Routing(route.ids), _Hidden() as one:
            tw.stream_cost(cfg, FULL_SEED, batch, device=dev,
                           updates=updates[:CONTROL_STEP])
        out["hidden"] = dict(_hidden_gap(mesh_hidden, one),
                             step=CONTROL_STEP)
        del one
    for n in range(GATED_STEPS):
        with _pinned(routes, n + 1) as log:
            ct, cost = _probe_ct(
                lambda p, b, probe: tw.stream_probe(
                    cfg, FULL_SEED, b, probe, device=dev,
                    updates=updates[:n]),
                None, batch, n, mc.seed, mc)
        tol = rel * abs(cost)
        mct, mcost = mesh_rec["c_tilde"][n], mesh_rec["cost"][n]
        out["steps"].append(dict(
            c_tilde=ct, cost=cost, tol=tol, mesh_c_tilde=mct,
            mesh_cost=mcost, c_tilde_err_in_tol=abs(mct - ct) / tol,
            cost_err_in_tol=abs(mcost - cost) / tol,
            control_zero_in_tol=abs(ct) / tol,
            control_other_seed_in_tol=abs(
                mesh_rec["c_tilde_other_seed"][n] - ct) / tol))
        if routes:
            out["steps"][-1]["routing"] = _routing_gap(routes[n + 1], log)
    out["seconds"] = time.perf_counter() - t0
    return out


def _serve(cfg, params, mesh, dev, rel=None):
    """launch/serve.py's 4 × 32 prompt and 32 greedy tokens on the mesh
    (``greedy_generate``'s loop, timed, its logits kept), the KV cache
    placed as ``specs.cache_shardings`` says; then the decode gate of
    chip_smoke.py's ``decode_gate``: every prefill and decode logit
    against the mesh's full forward of the same tokens within GATE_ULPS
    bf16 ulps of max|logit| (phase 12's; ``rel``·max|logit| with
    ``rel``), and its two controls (the cache one position short, the
    last written position zeroed) missing it.  An MoE model serves at
    phase 13's capacity factor at which nothing drops (``MOE_DECODE_CF``),
    so the decode and the full forward drop no token; its gate and
    controls hold the decode against the full forward routed as the
    prefill and decode steps routed each token (``_Routing`` pinned to
    their logs), and ``unpinned_in_limits`` is the gate against the full
    forward's own routing."""
    import repro_torch as rt
    from chip_smoke import GATE_ULPS, MOE_DECODE_CF, PEAK_BYTES, bf16_ulp
    from repro_torch.core import rng
    from repro_torch.launch import specs
    if cfg.n_experts:
        cfg = cfg.replace(moe_capacity_factor=MOE_DECODE_CF[cfg.name])
    prompts = rng.randint(rng.prng_key(FULL_SEED + 1), (4, PROMPT), 0,
                          cfg.vocab, device=dev).to(torch.int32)
    max_len = PROMPT + NEW
    log = _Routing() if cfg.n_experts else contextlib.nullcontext()
    with torch.no_grad(), log:
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = rt.model_prefill(params, cfg, {"tokens": prompts},
                                         max_len)
        pf = shd.full(logits)
        toks = pf[:, -1].argmax(-1).to(torch.int32)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        want = specs.cache_shardings(cfg, {k: v for k, v in cache.items()
                                           if k != "length"}, mesh)
        cache_placed = all(
            tuple(shd.placements(w.spec, mesh))
            == tuple(cache[k].placements)
            for k, w in want.items())
        out, dec, times = [toks], [], []
        for _ in range(1, NEW):
            t0 = time.perf_counter()
            lg, cache = rt.model_decode(params, cfg, toks, cache)
            lg = shd.full(lg)
            toks = lg.argmax(-1).to(torch.int32)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            dec.append(lg)
            out.append(toks)
    with torch.no_grad():
        del cache
        seq = torch.cat([prompts, torch.stack(out, 1)], 1)
        own = full = shd.full(rt.model_forward(params, cfg, {"tokens": seq}))
        if cfg.n_experts:
            with _Routing(_serve_pins(log.ids, prompts.shape[0])):
                full = shd.full(rt.model_forward(params, cfg,
                                                 {"tokens": seq}))

        def errs(pre, decs, ref=full):
            e = float((pre.float() - ref[:, :PROMPT].float()).abs().max())
            for j, lg in enumerate(decs):
                e = max(e, float((lg.float() - ref[:, PROMPT + j].float())
                                 .abs().max()))
            return e

        err = errs(pf, dec)
        top = float(full.float().abs().max())
        limit = rel * top if rel else GATE_ULPS * bf16_ulp(top)
        controls = {}
        for name in ("length_short", "zeroed_last"):
            lg, cache = rt.model_prefill(params, cfg, {"tokens": prompts},
                                         max_len)
            if name == "length_short":
                cache["length"] = cache["length"] - 1
            decs = []
            for t in range(PROMPT, PROMPT + CONTROL_POSITIONS):
                if name == "zeroed_last":
                    last = int(cache["length"]) - 1
                    for key in ("k", "v"):
                        shd.write_at(cache[key], 2, last, torch.zeros(
                            tuple(cache[key].shape[:2])
                            + tuple(cache[key].shape[3:]),
                            dtype=cfg.torch_dtype, device=dev))
                lg_t, cache = rt.model_decode(params, cfg, seq[:, t], cache)
                decs.append(shd.full(lg_t))
            controls[f"control_{name}_in_limits"] = errs(
                shd.full(lg), decs) / limit
            del cache
        controls["unpinned_in_limits"] = errs(pf, dec, own) / limit
    times.sort()
    bound_ms = _local_gb(params) * 1e9 / PEAK_BYTES * 1e3
    return dict(dtype=cfg.dtype, capacity_factor=cfg.moe_capacity_factor,
                prefill_ms=prefill_s * 1e3,
                decode_ms_per_token=times[len(times) // 2] * 1e3,
                decode_ms_all=[t * 1e3 for t in times],
                decode_bound_ms=bound_ms, cache_placed=cache_placed,
                gate_err=err, gate_limit=limit,
                gate_err_in_limits=err / limit, max_abs_logit=top,
                **controls, generated=seq[0, PROMPT:PROMPT + 8].tolist())


def _serve_pins(ids, b):
    """The full forward's routing pins from the logged prefill and decode
    steps (each a routing call a layer, in order): token (i, t) goes where
    the prefill (t < PROMPT) or decode step t − PROMPT sent it; the last
    token, which no decode step took, is free (−1)."""
    n_dec = NEW - 1
    layers = len(ids) // (1 + n_dec)
    if len(ids) != layers * (1 + n_dec):
        raise ValueError(f"{len(ids)} routing calls for {1 + n_dec} runs")
    k = ids[0].shape[-1]
    pins = []
    for layer in range(layers):
        pin = torch.full((b, PROMPT + NEW, k), -1, dtype=ids[0].dtype)
        pin[:, :PROMPT] = ids[layer].reshape(b, PROMPT, k)
        for j in range(n_dec):
            pin[:, PROMPT + j] = ids[(1 + j) * layers + layer].reshape(b, k)
        pins.append(pin.reshape(-1, k))
    return pins


def _draw_gb(cfg, dev):
    """The device memory one layer's draw takes at its peak (its leaves
    and their f32 draws), measured."""
    import repro_torch as rt
    if dev.type != "cuda":
        return 0.0
    _reset_peak(dev)
    base = torch.cuda.memory_allocated(dev)
    layer = rt.models.transformer.init_part(cfg, FULL_SEED, 0, device=dev)
    del layer
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def _run_model(arch, rules, n_layers, mesh, dev, *, witness=True,
               serve=True, steps=(CENTRAL_STEPS, FORWARD_STEPS),
               dtype=None, rel=None):
    """One full-width model on the mesh: the sharded init; serving from
    θ₀ (the decode gate at ``rel``, see ``_serve``); fused central steps
    (step 0 counted for collectives, its update against the witness's
    blocks, steps 0 to GATED_STEPS − 1 against the witness) and fused
    forward steps.  Returns this rank's record."""
    import repro_torch as rt
    from repro_torch import kernels
    from repro_torch.core import build_mgd_step, mgd_init
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    from repro_torch.launch.comm_bytes import CollectiveBytes
    from repro_torch.launch.dryrun import default_mgd_config
    cfg = _full_cfg(arch, n_layers, dtype)
    rec = dict(arch=arch, layers=n_layers, rules=rules or "default",
               dtype=cfg.dtype)
    rule_set = shd.RULE_SETS[rules] if rules else None
    rec["draw_gb"] = _draw_gb(cfg, dev)
    with shd.use_mesh(mesh, rule_set):
        _reset_peak(dev)
        t0 = time.perf_counter()
        params = rt.model_init(cfg, FULL_SEED, device=dev,
                               shardings=specs.param_shardings(cfg, mesh))
        _sync(dev)
        rec.update(init_s=time.perf_counter() - t0,
                   init_peak_gb=_peak_gb(dev), shards_gb=_local_gb(params),
                   sharded_leaves=sum(any(p.is_shard() for p in x.placements)
                                      for x in tree_leaves(params)))
        if serve:
            _reset_peak(dev)
            rec["serve"] = _serve(cfg, params, mesh, dev, rel=rel)
            rec["serve_peak_gb"] = _peak_gb(dev)
        batch = rt.lm_sampler(FULL_BATCH, FULL_SEQ, cfg.vocab, seed=0,
                              device=dev)(0)
        sb = shard_batch(batch, mesh)
        probe_fn = rt.make_transformer_probe_fn(cfg)
        loss_fn = (lambda p, b: rt.model_loss(p, cfg, b))   # noqa: E731
        mc = dataclasses.replace(default_mgd_config("central"), fused=True)
        routes = []         # an MoE model's routings: loss0, the steps

        def logged(on):
            if not (on and cfg.n_experts):
                return contextlib.nullcontext()
            routes.append(_Routing())
            return routes[-1]

        if witness:
            with torch.no_grad(), logged(True):
                rec["loss0"] = float(loss_fn(params, sb))
        step = build_mgd_step(loss_fn, mc, probe_fn=probe_fn)
        state = mgd_init(params, mc)
        rec.update(cost=[], c_tilde=[], step_s=[], c_tilde_other_seed=[])
        central = dict.fromkeys(kernels.launch_counts(), 0)
        updates = []

        def take_counts():      # the steps' launches, not the checks'
            for k, v in kernels.launch_counts().items():
                central[k] += v
            kernels.reset_launch_counts()

        kernels.reset_launch_counts()
        coll = CollectiveBytes()
        hidden = None
        for n in range(steps[0]):
            if witness and n < GATED_STEPS:
                # the control: another seed's C̃ from the same params
                take_counts()
                rec["c_tilde_other_seed"].append(_probe_ct(
                    probe_fn, params, sb, n, mc.seed + 1, mc)[0])
                if cfg.n_experts and n == CONTROL_STEP:
                    # an MoE model's hidden states here, for the witness
                    with torch.no_grad(), _Routing() as route, \
                            _Hidden() as mesh_hidden:
                        loss_fn(params, sb)
                    hidden = (mesh_hidden, route)
                kernels.reset_launch_counts()
            _sync(dev)
            t0 = time.perf_counter()
            with coll if n == 0 else contextlib.nullcontext(), \
                    logged(witness and n < GATED_STEPS):
                params, state, m = step(params, state, sb)
            _sync(dev)
            rec["step_s"].append(time.perf_counter() - t0)
            rec["cost"].append(float(m["cost"]))
            rec["c_tilde"].append(float(m["c_tilde"]))
            updates.append((mc, n, m["c_tilde"]))
            take_counts()
            if witness and n == 0:
                rec["update_bitwise"], rec["update_blocks"] = \
                    _updates_bitwise(cfg, updates, params, dev)
            if witness and n == GATED_STEPS - 1:
                t0 = time.perf_counter()
                if torch.distributed.get_rank() == 0:
                    rec["witness"] = _witness_gate(
                        cfg, mc, batch, dict(rec, routes=routes,
                                             hidden=hidden), updates, dev)
                hidden = None
                torch.distributed.barrier()
                rec["witness_s"] = time.perf_counter() - t0
            kernels.reset_launch_counts()
        routes.clear()
        rec["launches_central"] = central
        c = coll.result()
        rec["central_collectives"] = dict(total=c["total_bytes"],
                                          by_type=c["by_type"],
                                          n=len(c["ops"]))
        fmc = dataclasses.replace(mc, mode="forward")
        fstep = build_mgd_step(loss_fn, fmc, probe_fn=probe_fn)
        fstate = mgd_init(params, fmc)
        kernels.reset_launch_counts()
        coll = CollectiveBytes()
        rec["forward_step_s"], m = [], {}
        for n in range(steps[1]):
            _sync(dev)
            t0 = time.perf_counter()
            with coll if n == 0 else contextlib.nullcontext():
                params, fstate, m = fstep(params, fstate, sb)
            _sync(dev)
            rec["forward_step_s"].append(time.perf_counter() - t0)
        rec["forward_c_tilde"] = [float(m["c_tilde"])] if m else []
        rec["launches_forward"] = kernels.launch_counts()
        c = coll.result()
        rec["forward_collectives"] = dict(total=c["total_bytes"],
                                          by_type=c["by_type"],
                                          n=len(c["ops"]))
        rec["train_peak_gb"] = _peak_gb(dev)
        rec["finite"] = all(np.isfinite(rec["cost"] + rec["c_tilde"]))
    if dev.type == "cuda":
        rec["total_gb"] = torch.cuda.get_device_properties(dev) \
            .total_memory / 1e9
    del params, state, fstate
    _reset_peak(dev)
    return rec


def _dry_step(mesh, dev):
    """The dry run's cell run for real: qwen2-72b at DRY_LAYERS, the
    unfused forward step of ``default_mgd_config``, batch 8 × 64: one
    step's collective bytes counted, one timed, the peak."""
    import repro_torch as rt
    from repro_torch.core import build_mgd_step, mgd_init
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import specs
    from repro_torch.launch.comm_bytes import CollectiveBytes
    from repro_torch.launch.dryrun import default_mgd_config
    cfg = _full_cfg(QWEN, DRY_LAYERS)
    mc = default_mgd_config("forward")
    step = build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mc)
    with shd.use_mesh(mesh):
        _reset_peak(dev)
        params = rt.model_init(cfg, FULL_SEED, device=dev,
                               shardings=specs.param_shardings(cfg, mesh))
        toks = torch.zeros((FULL_BATCH, FULL_SEQ), dtype=torch.int32,
                           device=dev)
        b = shard_batch({"tokens": toks, "labels": toks}, mesh)
        args_gb = _local_gb(params)
        st = mgd_init(params, mc)
        coll = CollectiveBytes()
        times = []
        for n in range(2):
            _sync(dev)
            t0 = time.perf_counter()
            with coll if n == 0 else contextlib.nullcontext():
                params, st, m = step(params, st, b)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        c = coll.result()
        rec = dict(arch=QWEN, layers=DRY_LAYERS, args_gb=args_gb,
                   collective_bytes=c["total_bytes"], by_type=c["by_type"],
                   n_collectives=len(c["ops"]), step_s=times,
                   peak_gb=_peak_gb(dev), cost=float(m["cost"]))
    del params, st
    _reset_peak(dev)
    return rec


def _llama_depth(mesh, dev):
    """llama4-scout's depth on the mesh: the deepest at which every card
    keeps FREE_GB free, at most LLAMA_MAX_LAYERS, from this mesh's
    training peaks at LLAMA_PROBE_LAYERS layers, linear in the depth (the
    largest rank's).  The run at that depth checks every peak (init,
    steps, serving) against the card."""
    peaks = {}
    for n_layers in LLAMA_PROBE_LAYERS:
        rec = _run_model(LLAMA, "moe_ep", n_layers, mesh, dev,
                         witness=False, serve=False, steps=(1, 0))
        peaks[n_layers] = rec["train_peak_gb"]
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, peaks)
    a, b = LLAMA_PROBE_LAYERS
    pa, pb = (max(p[a] for p in every), max(p[b] for p in every))
    slope = (pb - pa) / (b - a)
    if dev.type != "cuda":
        return b + 1, dict(peaks=every, slope_gb=slope)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    depth = int((total - FREE_GB - (pa - a * slope)) // slope)
    return min(depth, LLAMA_MAX_LAYERS), dict(peaks=every, slope_gb=slope,
                                              total_gb=total)


def cards_full4(rank, d):
    """A rank of ``cards_full``: one card, the (2, 2) ("data", "model")
    mesh; qwen2-72b at full depth, the dry run's cell for real,
    llama4-scout at the depth its peaks allow."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(FULL_DEVICE, rank if FULL_DEVICE == "cuda" else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh(FULL_DEVICE, (2, 2),
                            mesh_dim_names=("data", "model"))
    rec = dict(rank=rank, card=torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu")
    t0 = time.perf_counter()
    rec["qwen"] = _run_model(QWEN, None, QWEN_LAYERS, mesh, dev)
    rec["dry"] = _dry_step(mesh, dev)
    depth, rec["llama_depth"] = _llama_depth(mesh, dev)
    rec["llama"] = _run_model(LLAMA, "moe_ep", depth, mesh, dev)
    # phase 13 holds an MoE model's decode in f32 (in bf16 a near-tied
    # routing can flip between two rounding orders): the same checks in
    # f32, at the deeper of LLAMA_PROBE_LAYERS
    from chip_smoke import MOE_DECODE_REL
    rec["llama_f32"] = _run_model(
        LLAMA, "moe_ep", LLAMA_PROBE_LAYERS[-1], mesh, dev, dtype="float32",
        rel=MOE_DECODE_REL, steps=(GATED_STEPS, 0))
    # and in bf16 at that depth: the witness at 2⁻¹¹ without 30 layers'
    # amplification (ROADMAP C9)
    rec["llama_bf16_4"] = _run_model(
        LLAMA, "moe_ep", LLAMA_PROBE_LAYERS[-1], mesh, dev, serve=False,
        steps=(GATED_STEPS, 0))
    rec["seconds"] = time.perf_counter() - t0
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, rec)
    return every


DRY_FULL = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.distributed.world import close_world, fake_world
from repro_torch.launch import dryrun, roofline
cell = json.loads(sys.argv[1])
dryrun.SHAPES = dict(configs.SHAPES, train_4k=configs.ShapeSpec(
    "train_4k", cell["seq"], cell["batch"], "train"))
fake_world(4)
mesh = init_device_mesh(cell["device"], (2, 2),
                        mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(cell["arch"], "train_4k", multi_pod=False, mesh=mesh,
                      out_dir=None, device_type=cell["device"],
                      verbose=False,
                      cfg_overrides={"n_layers": cell["layers"]})
close_world()
rec["roofline"] = roofline.roofline_terms(rec)
print(json.dumps(rec))
"""


def _witness_held(w):
    """The loss at θ₀ and every gated step's C̃ and cost within the
    gate's tolerance of the witness's, both controls missing it at
    CONTROL_STEP, and (MoE) each pinned witness run making as many
    routing calls as the mesh's run it was pinned to."""
    ctl = w["steps"][CONTROL_STEP]
    calls = [r["calls"] for r in [w.get("routing")] + [
        st.get("routing") for st in w["steps"]] if r]
    return (w["loss_err_in_tol"] <= 1.0
            and all(st["c_tilde_err_in_tol"] <= 1.0
                    and st["cost_err_in_tol"] <= 1.0 for st in w["steps"])
            and ctl["control_zero_in_tol"] > 1.0
            and ctl["control_other_seed_in_tol"] > 1.0
            and all(a == b > 0 for a, b in calls))


def _decode_held(g, unpinned=False):
    """The decode gate and its controls (an MoE model's against the full
    forward pinned to the decode's routing; with ``unpinned`` also
    against its own)."""
    return (g["gate_err_in_limits"] <= 1.0 and g["cache_placed"]
            and g["control_length_short_in_limits"] > 1.0
            and g["control_zeroed_last_in_limits"] > 1.0
            and (not unpinned or g["unpinned_in_limits"] <= 1.0))


def _full_checks(ranks, dry):
    """The cards_full checks over the four ranks' records, and a reading
    held to a gate that is not a check: llama4-scout's bf16 decode
    against the full forward's own routing, where a near-tied routing
    flips between the two rounding orders (ROADMAP C9; its f32 run holds
    that gate as a check)."""
    def every(fn):
        return all(fn(r) for r in ranks)

    def launches(r, model, key, name):
        return FULL_DEVICE != "cuda" or r[model][key][name] > 0

    def peak(m):
        return max(m["init_peak_gb"], m["train_peak_gb"], m["serve_peak_gb"])

    checks = dict(
        qwen_full_depth=ranks[0]["qwen"]["layers"] == QWEN_LAYERS,
        init_peak=every(lambda r: all(
            r[m]["init_peak_gb"] <= r[m]["shards_gb"] + r[m]["draw_gb"]
            + INIT_SLACK_GB for m in ("qwen", "llama"))),
        finite=every(lambda r: all(r[m]["finite"] for m in (
            "qwen", "llama", "llama_f32", "llama_bf16_4"))),
        qwen_kernels=every(lambda r: launches(
            r, "qwen", "launches_central", "perturbed_matmul_pair")
            and launches(r, "qwen", "launches_central", "mgd_update_window")
            and launches(r, "qwen", "launches_forward", "perturbed_matmul")),
        llama_kernels=every(lambda r: launches(
            r, "llama", "launches_central", "mgd_update_window")),
        qwen_witness=_witness_held(ranks[0]["qwen"]["witness"]),
        llama_witness=_witness_held(ranks[0]["llama"]["witness"]),
        llama_f32_witness=_witness_held(ranks[0]["llama_f32"]["witness"]),
        llama_bf16_4_witness=_witness_held(
            ranks[0]["llama_bf16_4"]["witness"]),
        updates_bitwise=every(lambda r: all(
            r[m]["update_bitwise"] for m in ("qwen", "llama", "llama_f32",
                                             "llama_bf16_4"))),
        qwen_decode=every(lambda r: _decode_held(r["qwen"]["serve"])),
        llama_decode=every(lambda r: _decode_held(r["llama"]["serve"])),
        llama_f32_decode=every(lambda r: _decode_held(
            r["llama_f32"]["serve"], unpinned=True)),
        llama_depth=FULL_DEVICE != "cuda" or ONE_CARD_LLAMA4
        < ranks[0]["llama"]["layers"] <= LLAMA_MAX_LAYERS,
        llama_free=every(lambda r: FULL_DEVICE != "cuda" or r["llama"][
            "total_gb"] - peak(r["llama"]) >= FREE_GB),
        dry_collective_bytes=every(
            lambda r: r["dry"]["collective_bytes"]
            == dry["collective_bytes_per_device"]
            and r["dry"]["by_type"] == dry["collective_by_type"]))
    readings = dict(llama_bf16_decode_unpinned=every(
        lambda r: r["llama"]["serve"]["unpinned_in_limits"] <= 1.0))
    return checks, readings


def _summary(ranks, dry):
    """The record's numbers a reader wants, per rank where they differ."""
    def per(model, key):
        return [r[model][key] for r in ranks]

    out = {}
    for model in ("qwen", "llama", "llama_f32"):
        m = ranks[0][model]
        out[model] = dict(
            layers=m["layers"], rules=m["rules"], dtype=m["dtype"],
            init_s=per(model, "init_s"),
            init_peak_gb=per(model, "init_peak_gb"),
            shards_gb=per(model, "shards_gb"), draw_gb=per(model, "draw_gb"),
            train_peak_gb=per(model, "train_peak_gb"),
            serve_peak_gb=per(model, "serve_peak_gb"),
            central_step_s=m["step_s"], forward_step_s=m["forward_step_s"],
            cost=m["cost"], c_tilde=m["c_tilde"],
            launches_central=m["launches_central"],
            launches_forward=m["launches_forward"],
            central_collectives=per(model, "central_collectives"),
            forward_collectives=per(model, "forward_collectives"),
            witness=m["witness"], witness_s=m["witness_s"],
            update_blocks=per(model, "update_blocks"),
            serve={k: v for k, v in m["serve"].items()
                   if k != "decode_ms_all"},
            decode_ms_per_token=[r[model]["serve"]["decode_ms_per_token"]
                                 for r in ranks],
            decode_bound_ms=[r[model]["serve"]["decode_bound_ms"]
                             for r in ranks])
    m = ranks[0]["llama_bf16_4"]
    out["llama_bf16_4"] = dict(
        layers=m["layers"], dtype=m["dtype"], cost=m["cost"],
        c_tilde=m["c_tilde"], central_step_s=m["step_s"],
        central_collectives=per("llama_bf16_4", "central_collectives"),
        witness=m["witness"])
    out["llama_depth"] = ranks[0]["llama_depth"]
    out["dry"] = dict(
        measured=[r["dry"] for r in ranks],
        dry_run=dict(collective_bytes=dry["collective_bytes_per_device"],
                     by_type=dry["collective_by_type"],
                     args_gib=dry["memory"]["argument_bytes"] / 2**30,
                     temp_gib=dry["memory"]["temp_bytes"] / 2**30,
                     alias_gib=dry["memory"]["alias_bytes"] / 2**30,
                     roofline={k: dry["roofline"][k] for k in (
                         "compute", "memory", "collective", "dominant",
                         "step_time_bound")},
                     run_s=dry["seconds"]["run"]))
    out["rank_seconds"] = [r["seconds"] for r in ranks]
    return out


def cards_full(d):
    """``cards_full4`` on four cards beside the dry run of the
    DRY_LAYERS cell on a fake world of four; writes the whole record to
    ``DIR/cards_full.json``, prints the card line, the summary and the
    checks, returns 1 if a check fails or a rank fails (the others are
    then stopped at once)."""
    import subprocess
    os.makedirs(d, exist_ok=True)
    for name in ("store", "out.pt"):         # an earlier run's
        if os.path.exists(os.path.join(d, name)):
            os.remove(os.path.join(d, name))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # expandable segments: the ranks free and take tens of GB a step
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    if FULL_DEVICE == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(card, flush=True)
    t0 = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-c", DRY_FULL, json.dumps(dict(
            arch=QWEN, layers=DRY_LAYERS, seq=FULL_SEQ, batch=FULL_BATCH,
            device=FULL_DEVICE))], env=env, stdout=subprocess.PIPE,
        text=True)
    ranks = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "cards_full4", str(r), "4", d], env=env)
             for r in range(4)]
    procs = ranks + [dry]
    try:
        while any(p.poll() is None for p in ranks):
            if any(p.poll() not in (None, 0) for p in ranks) \
                    or time.perf_counter() - t0 > FULL_TIMEOUT_S:
                break
            time.sleep(1.0)
        rcs = [p.poll() for p in ranks]
        dry_out = dry.communicate(timeout=1800)[0] if not any(rcs) else ""
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rc != 0 for rc in rcs) or dry.returncode:
        print(json.dumps({"ranks_rc": rcs, "dry_rc": dry.returncode}))
        return 1
    ranks_rec = torch.load(os.path.join(d, "out.pt"), weights_only=False)
    dry_rec = json.loads(dry_out.strip().splitlines()[-1])
    checks, readings = _full_checks(ranks_rec, dry_rec)
    out = dict(summary=_summary(ranks_rec, dry_rec), checks=checks,
               readings=readings, seconds=time.perf_counter() - t0)
    with open(os.path.join(d, "cards_full.json"), "w") as f:
        json.dump(dict(out, ranks=ranks_rec, dry_run=dry_rec), f,
                  default=str, indent=1)
    print(json.dumps(out, default=str), flush=True)
    return 0 if all(checks.values()) else 1


def main():
    if sys.argv[1] in ("cards", "cards_full"):
        sys.exit({"cards": cards, "cards_full": cards_full}[sys.argv[1]](
            sys.argv[2]))
    scenario, rank, world, d = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    backend = {"cards4": "nccl", "cards_full4": FULL_BACKEND}.get(scenario,
                                                                 "gloo")
    init_world(backend, rank, world, os.path.join(d, "store"),
               timeout_s=1800.0)
    try:
        out = {"mesh8": mesh8, "mesh4": mesh4,
               "cards4": cards4, "cards_full4": cards_full4}[scenario](
                   rank, d)

        if rank == 0:
            torch.save(out, os.path.join(d, "out.pt"))
            with open(os.path.join(d, "out.json"), "w") as f:
                json.dump({"ok": True}, f)
    finally:
        close_world()


if __name__ == "__main__":
    main()
