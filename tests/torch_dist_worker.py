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
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
# the port's sources, for a launch without PYTHONPATH (``cards``)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import perturbations as pert  # noqa: E402
from repro_torch.core.utils import tree_leaves, tree_map  # noqa: E402
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
    import time
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
    import time
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


def main():
    if sys.argv[1] == "cards":
        sys.exit(cards(sys.argv[2]))
    scenario, rank, world, d = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    init_world("nccl" if scenario == "cards4" else "gloo", rank, world,
               os.path.join(d, "store"))
    try:
        out = {"mesh8": mesh8, "mesh4": mesh4,
               "cards4": cards4}[scenario](rank, d)

        if rank == 0:
            torch.save(out, os.path.join(d, "out.pt"))
            with open(os.path.join(d, "out.json"), "w") as f:
                json.dump({"ok": True}, f)
    finally:
        close_world()


if __name__ == "__main__":
    main()
