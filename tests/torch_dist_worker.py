"""Rank bodies of ``tests/test_torch_distributed.py``'s gloo worlds.

Run as ``python tests/torch_dist_worker.py SCENARIO RANK WORLD DIR``:
each rank joins a gloo world through a file store in DIR, reads its
inputs from ``DIR/inputs.npz`` where the scenario has any, and rank 0
writes ``DIR/out.pt`` (and ``DIR/out.json``).  Imports torch and
repro_torch only; the test compares the outputs with the reference.
"""
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

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
            rec["params"].append(_flat(p))
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
           "step": sharded_step(mesh),
           "elastic": elastic(mesh, d)}
    return out


def _pod_runs(mesh, local_mesh, data_axis, inputs, fused, steps=36,
              **kw):
    """The XOR MLP's probe-parallel run with pods as ranks, and the same
    run on a LocalMesh in this process."""
    import repro_torch as rt
    from repro_torch.core import mse
    from repro_torch.models.simple import mlp_apply
    p0 = [{"b": torch.from_numpy(inputs["b0"]),
           "w": torch.from_numpy(inputs["w0"])},
          {"b": torch.from_numpy(inputs["b1"]),
           "w": torch.from_numpy(inputs["w1"])}]
    batch = {"x": torch.from_numpy(inputs["x"]),
             "y": torch.from_numpy(inputs["y"])}
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3,
                          fused=fused)

    def loss(p, b):
        return mse(mlp_apply(p, b["x"]), b["y"])

    if fused:
        kw["probe_fn"] = rt.make_mlp_probe_fn()
    recs = []
    for m in (mesh, local_mesh):
        drv = rt.driver("probe_parallel", cfg, loss, mesh=m,
                        data_axis=data_axis, device="cpu", **kw)
        p, s = p0, drv.init(p0)
        rec = {"c_tilde": [], "cost": [], "params": []}
        for _ in range(steps):
            p, s, aux = drv.step(p, s, batch)
            rec["c_tilde"].append(float(aux["c_tilde"]))
            rec["cost"].append(float(aux["cost"]))
            rec["params"].append(_flat(p))
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
    out["pod2model2_param_specs"] = _pod_runs(
        pm, LocalMesh(pod=2), None, inputs, False,
        param_specs=[(r"w$", (None, "model"))])
    y = pipeline_forward(lambda w, x: torch.tanh(x @ w),
                         torch.from_numpy(inputs["ws"]),
                         torch.from_numpy(inputs["px"]), mesh=pod4,
                         axis="pod", microbatches=4)
    out["pipeline"] = y
    return out


def main():
    scenario, rank, world, d = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    init_world("gloo", rank, world, os.path.join(d, "store"))
    try:
        out = {"mesh8": mesh8, "mesh4": mesh4}[scenario](rank, d)
        if rank == 0:
            torch.save(out, os.path.join(d, "out.pt"))
            with open(os.path.join(d, "out.json"), "w") as f:
                json.dump({"ok": True}, f)
    finally:
        close_world()


if __name__ == "__main__":
    main()
