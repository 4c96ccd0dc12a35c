"""Multi-pod dry run: every (arch × shape × mesh) cell, counted on fake
ranks with nothing allocated.

The twin of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for 512 virtual devices.  Here each cell runs in a
process of its own with a 256- or 512-rank fake process group
(``distributed.world.fake_world``) under ``FakeTensorMode``: the step
runs eagerly, op by op, on DTensors whose local shards are fake tensors
of this rank's shapes, so it sees the real sharded program — every
redistribution DTensor makes, every layer (Python loops, no trip
counts) — and allocates nothing.

Per cell it keeps the reference's builders (the forward-mode Algorithm 1
step of ``default_mgd_config``, prefill, one decode token against a
seq_len cache) and record: ``params``, ``params_active``, ``model_flops``
(``count_params``, ``active_params``, ``model_flops``, copied), the
counted flops and bytes (``launch.op_cost``: global, logical),
``collective_bytes_per_device``, ``collective_by_type`` and
``n_collectives`` (``launch.comm_bytes``: this rank's wire bytes), and
per-rank memory.  The reference's ``jaxpr_flops``/``jaxpr_bytes`` are
``counted_flops``/``counted_bytes`` here; its ``xla_*_per_device`` (XLA's
own cost analysis of the compiled program) has no counterpart and is
dropped.

Memory is per rank: ``argument_bytes`` are the local shards of params,
optimizer state and batch (and the decode cache); ``temp_bytes`` is the
peak of the live local bytes the step allocates above them.  As the
reference donates params (and the cache), the updated params are
counted as written over the donated inputs: their allocations are left
out of the peak, and ``alias_bytes`` reports them.

Every family runs: the dense decoders, MoE (experts over "expert"), MLA
(latent caches over "kvseq") and the recurrent ones (states over
(batch, heads)).  Only what the reference skips is skipped: ``long_500k``
outside ``configs.LONG_CONTEXT_OK`` (``configs.runnable_cells``).  The
fake tensors lie on the card unless ``--device cpu`` asks for the CPU.
Output goes to ``artifacts/dryrun_torch/``::

    python -m repro_torch.launch.dryrun --arch qwen3-14b [--both-meshes]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_IDS, LONG_CONTEXT_OK, SHAPES,
                                get_config, runnable_cells)
from repro_torch.core import MGDConfig, build_mgd_step, mgd_init
from repro_torch.core.utils import (tensors_of, tree_flatten, tree_leaves,
                                    tree_unflatten)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.comm_bytes import CollectiveBytes
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import (init_cache, model_decode, model_loss,
                                model_prefill)

OUT_DIR = "artifacts/dryrun_torch"
CELL_TIMEOUT_S = 7200       # a cell's process (prefill_32k of qwen2-72b is
#                             the longest on a CPU)


def default_mgd_config(mode: str = "forward") -> MGDConfig:
    """Paper-faithful baseline: Algorithm 1, τ_p = τ_θ = τ_x = 1
    (C₀ refresh + perturbed forward = 2 forwards/step)."""
    return MGDConfig(ptype="rademacher", dtheta=1e-3, eta=1e-2,
                     tau_p=1, tau_theta=1, tau_x=1, mode=mode)


def count_params(aparams) -> int:
    return sum(int(math.prod(x.shape)) for x in tree_leaves(aparams))


def active_params(cfg, aparams) -> int:
    n = count_params(aparams)
    if cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_moe_layers = cfg.n_layers
        n -= n_moe_layers * (cfg.n_experts - cfg.n_experts_active) * per_expert
    return n


def model_flops(cfg, shape, kind: str, n_forwards: int) -> float:
    """Analytic useful FLOPs per step (the roofline's MODEL_FLOPS)."""
    aparams = specs.abstract_params(cfg)
    n_active = active_params(cfg, aparams)
    n_embed = cfg.vocab * max(cfg.n_codebooks, 1) * cfg.d_model
    n_mm = n_active - n_embed          # embedding lookup is a gather
    b, s = shape.global_batch, shape.seq_len
    if kind == "train" or kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_mm * tokens
        if cfg.family not in ("ssm",):
            # causal attention: 2 matmuls × 2 flops × S²/2 × heads·dh (+GQA)
            attn_layers = (cfg.n_layers if cfg.family != "hybrid"
                           else cfg.n_layers // (cfg.attn_every + 1))
            d_attn = cfg.n_heads * cfg.head_dim
            if cfg.use_mla:
                d_attn = cfg.n_heads * (cfg.qk_nope_head_dim
                                        + cfg.qk_rope_head_dim
                                        + cfg.v_head_dim) / 2
            flops += attn_layers * b * s * s * d_attn * 2.0  # ≈2·2·S²/2·d
    else:  # decode: one token per sequence
        tokens = b
        flops = 2.0 * n_mm * tokens
        if cfg.family not in ("ssm",):
            attn_layers = (cfg.n_layers if cfg.family != "hybrid"
                           else cfg.n_layers // (cfg.attn_every + 1))
            if cfg.use_mla:
                # absorbed decode: scores+values vs the r-dim latent cache
                d_attn = cfg.n_heads * (cfg.kv_lora_rank
                                        + cfg.qk_rope_head_dim)
            else:
                d_attn = cfg.n_heads * cfg.head_dim
            flops += attn_layers * b * s * d_attn * 2.0 * 2.0
    return flops * n_forwards


# ---------------------------------------------------------------------------
# Placed fake inputs and per-rank memory
# ---------------------------------------------------------------------------


def _local_bytes(x) -> int:
    t = shd.local(x)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _placed(meta, sharding, device):
    """An empty tensor of ``meta``'s shape and dtype placed under
    ``sharding``: only this rank's shard exists (fake under
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.perturbations import local_layout
    shape = tuple(meta.shape)
    pl = sharding.placements
    local_shape, _ = local_layout(shape, sharding.mesh, pl)
    local = torch.zeros(local_shape, dtype=meta.dtype, device=device)
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def _place_tree(tree, shardings, device):
    leaves, treedef = tree_flatten(tree)
    shs = tree_flatten(shardings)[0]
    return tree_unflatten(treedef, [_placed(x, s, device)
                                    for x, s in zip(leaves, shs)])


_PROPAGATING = [0]


class _MarkPropagation:
    """While active, DTensor's sharding propagation (which runs each new
    op once on fake tensors of the GLOBAL shapes to learn its output
    metadata) raises a flag, so ``LiveBytes`` does not take those
    shadow tensors for this rank's allocations.  It wraps the
    propagator's private metadata method, where the installed torch has
    one."""

    NAMES = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self.saved = []
        for name in self.NAMES:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is None:
                continue

            def wrapped(*a, _orig=orig, **k):
                _PROPAGATING[0] += 1
                try:
                    return _orig(*a, **k)
                finally:
                    _PROPAGATING[0] -= 1

            self.saved.append((name, orig))
            setattr(ShardingPropagator, name, wrapped)
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name, orig in self.saved:
            setattr(ShardingPropagator, name, orig)


class LiveBytes(TorchDispatchMode):
    """The live local bytes this rank's step allocates: every plain
    (local, possibly fake) tensor a non-view, out-of-place op makes is
    counted until it is freed (not DTensor's shape propagation's, see
    ``_MarkPropagation``).  ``peak(excluding=...)`` replays the log
    without the allocations of the given tensors."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(shd.is_dtensor(a) for a in tensors_of((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if _PROPAGATING[0]:
            return out
        schema = getattr(func, "_schema", None)
        if schema is None or func.is_view or any(
                a.alias_info is not None and a.alias_info.is_write
                for a in schema.arguments):
            return out
        for t in tensors_of(out):
            n = t.numel() * t.element_size()
            if n and t.device.type != "meta":
                key = id(t)
                self.log.append(("a", key, n))
                weakref.finalize(t, self.log.append, ("f", key, n))
        return out

    def peak(self, excluding=()):
        skip = set(excluding)
        live = peak = 0
        for kind, key, n in self.log:
            if key in skip:
                continue
            live += n if kind == "a" else -n
            peak = max(peak, live)
        return peak


# ---------------------------------------------------------------------------
# Cell builders: (fn, args, donated arg indices, n_forwards)
# ---------------------------------------------------------------------------


def build_train(cfg, shape, mesh, device, mgd_mode="forward"):
    mgd_cfg = default_mgd_config(mgd_mode)
    step_fn = build_mgd_step(lambda p, b: model_loss(p, cfg, b), mgd_cfg)
    params = _place_tree(specs.abstract_params(cfg),
                         specs.param_shardings(cfg, mesh), device)
    state = mgd_init(params, mgd_cfg)
    batch = specs.train_input_specs(cfg, shape)
    batch = _place_tree(batch, specs.batch_shardings(batch, mesh), device)
    return step_fn, (params, state, batch), (0, 1), 2


def build_prefill(cfg, shape, mesh, device):
    params = _place_tree(specs.abstract_params(cfg),
                         specs.param_shardings(cfg, mesh), device)
    batch = specs.prefill_input_specs(cfg, shape)
    batch = _place_tree(batch, specs.batch_shardings(batch, mesh), device)

    def prefill_fn(params, batch):
        return model_prefill(params, cfg, batch, shape.seq_len)

    return prefill_fn, (params, batch), (), 1


def build_decode(cfg, shape, mesh, device):
    """serve_step: ONE new token against a seq_len-deep cache."""
    tok, acache = specs.decode_input_specs(cfg, shape, mesh)
    params = _place_tree(specs.abstract_params(cfg),
                         specs.param_shardings(cfg, mesh), device)
    del acache["length"]
    cache = _place_tree(acache, specs.cache_shardings(cfg, acache, mesh),
                        device)
    cache["length"] = 0             # the host int the step reads
    tok = _place_tree(tok, specs.batch_shardings(tok, mesh), device)

    if "embeds" in tok:
        def serve_step(params, tok_in, cache):
            return model_decode(params, cfg, None, cache,
                                embeds=tok_in["embeds"])
    else:
        def serve_step(params, tok_in, cache):
            return model_decode(params, cfg, tok_in["tokens"], cache)

    return serve_step, (params, tok, cache), (2,), 1


def build_cell(cfg, shape, mesh, device, mgd_mode="forward"):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, device, mgd_mode)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, device)
    return build_decode(cfg, shape, mesh, device)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _path(out_dir, arch, shape_name, multi_pod, tag):
    suffix = "multipod" if multi_pod else "singlepod"
    tag_s = f"_{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}_{shape_name}_{suffix}{tag_s}.json")


def skipped_record(arch, shape_name, multi_pod, tag=""):
    return {"arch": arch, "shape": shape_name,
            "kind": SHAPES[shape_name].kind, "multi_pod": multi_pod,
            "chips": 512 if multi_pod else 256, "tag": tag,
            "skipped": (f"{shape_name} is for the sub-quadratic archs "
                        f"{sorted(LONG_CONTEXT_OK)} (the reference's "
                        f"runnable cells)")}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = OUT_DIR, mgd_mode: str = "forward",
             cfg_overrides=None, tag: str = "", rule_set=None, mesh=None,
             device_type=None, verbose=True) -> dict:
    """One cell in this process, whose (fake) world must be the mesh's
    size.  ``mesh`` overrides the production mesh (tests);
    ``cfg_overrides`` such as ``{"n_layers": 4}`` cut the config."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import _device_type, make_production_mesh
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    if (arch, shape_name, True) not in runnable_cells():
        rec = skipped_record(arch, shape_name, multi_pod, tag)
        _write(rec, out_dir, arch, shape_name, multi_pod, tag)
        return rec
    shape = SHAPES[shape_name]
    device = _device_type(device_type)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type=device)
    chips = math.prod(mesh.shape)
    t0 = time.time()
    result = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "multi_pod": multi_pod, "chips": chips, "tag": tag,
        "mesh": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
        "mgd_mode": mgd_mode if shape.kind == "train" else None,
        "overrides": {k: str(v) for k, v in (cfg_overrides or {}).items()},
        "rule_set": rule_set or "default",
    }
    rules = shd.RULE_SETS[rule_set] if rule_set else None
    with shd.use_mesh(mesh, rules), FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, donate, n_fwd = build_cell(cfg, shape, mesh, device,
                                             mgd_mode)
        arg_bytes = sum(_local_bytes(x) for x in tensors_of(args))
        live, cost, coll = LiveBytes(), OpCost(sharded=True), \
            CollectiveBytes()
        with _MarkPropagation(), live, coll, cost:   # cost sees DTensor ops
            out = fn(*args)
        t_run = time.time() - t0
        # donation: the updated params (train) / cache (decode) are
        # written over their inputs
        if shape.kind == "train":
            aliased = tensors_of(out[0])
        elif shape.kind == "decode":
            aliased = tensors_of(out[1])
        else:
            aliased = []
        aliased_locals = [shd.local(x) for x in aliased]
        alias_bytes = sum(_local_bytes(x) for x in aliased)
        out_bytes = sum(_local_bytes(x) for x in tensors_of(out)) - alias_bytes
        temp = live.peak(excluding=[id(t) for t in aliased_locals])
    jcost = cost.result()
    c = coll.result()
    aparams = specs.abstract_params(cfg)
    result.update({
        "params": count_params(aparams),
        "params_active": active_params(cfg, aparams),
        "counted_flops": jcost["flops"],
        "counted_bytes": jcost["bytes"],
        "unknown_while": jcost["unknown_while"],
        "model_flops": model_flops(cfg, shape, shape.kind, n_fwd),
        "collective_bytes_per_device": c["total_bytes"],
        "collective_by_type": c["by_type"],
        "n_collectives": len(c["ops"]),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": max(out_bytes, 0),
            "temp_bytes": temp,
            "alias_bytes": alias_bytes,
        },
        "seconds": {"run": round(t_run, 2)},
    })
    _write(result, out_dir, arch, shape_name, multi_pod, tag)
    if verbose:
        m = result["memory"]
        print(f"[dryrun] {arch} × {shape_name} × "
              f"{'x'.join(str(n) for n in mesh.shape)}: "
              f"run {result['seconds']['run']}s, "
              f"args {m['argument_bytes']/2**30:.2f} GiB/dev, "
              f"temp {m['temp_bytes']/2**30:.2f} GiB/dev, "
              f"coll {c['total_bytes']/2**20:.1f} MiB/dev/step",
              flush=True)
    return result


def _write(rec, out_dir, arch, shape_name, multi_pod, tag):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(_path(out_dir, arch, shape_name, multi_pod, tag),
                  "w") as f:
            json.dump(rec, f, indent=1)


def load_record(out_dir, arch, shape_name, multi_pod, tag=""):
    """A cell's record as ``run_cell`` wrote it."""
    with open(_path(out_dir, arch, shape_name, multi_pod, tag)) as f:
        return json.load(f)


def cell_in_process(arch, shape, multi_pod, **kw):
    """One cell in THIS process: joins a fake world of the mesh's size
    (so call it once a process)."""
    from repro_torch.distributed.world import close_world, fake_world
    fake_world(512 if multi_pod else 256)
    try:
        return run_cell(arch, shape, multi_pod=multi_pod, **kw)
    finally:
        close_world()


def main(argv=None):
    from repro_torch.launch.mesh import _device_type
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mgd-mode", default="forward",
                    choices=["forward", "central"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--rules", default=None,
                    choices=[None, "pure_dp", "dp_fsdp", "moe_ep"])
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="fake tensors' device (default: the card; "
                         "without one, pass --device cpu)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--cell", action="store_true",
                    help="run exactly one cell in this process")
    args = ap.parse_args(argv)
    if args.cell:
        cell_in_process(args.arch, args.shape, args.multi_pod,
                        out_dir=args.out, mgd_mode=args.mgd_mode,
                        tag=args.tag, rule_set=args.rules,
                        device_type=args.device)
        return
    cells = [(a, s) for a, s, ok in runnable_cells() if ok]
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    _device_type(args.device)      # no card and no --device cpu: raise here
    failures, n_run = [], 0
    for arch, shape in cells:
        for mp in meshes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--cell", "--arch", arch, "--shape", shape,
                   "--out", args.out, "--mgd-mode", args.mgd_mode,
                   "--tag", args.tag]
            cmd += ["--multi-pod"] if mp else []
            cmd += ["--rules", args.rules] if args.rules else []
            cmd += ["--device", args.device] if args.device else []
            try:
                rc = subprocess.run(cmd, timeout=CELL_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failures.append((arch, shape, mp, rc))
                print(f"[dryrun] FAIL {arch} × {shape} mp={mp}: {rc}")
            n_run += 1
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {n_run} cells ran clean")


if __name__ == "__main__":
    main()
