"""The port's distribution layer in one process: sharding rules,
compression, the dry-run tools.

* ``distributed/sharding.py``'s translation is the reference's, entry for
  entry: ``logical_spec`` on the reference test's five cases and a grid
  of shapes × names on the (16, 16) and (2, 16, 16) meshes, and
  ``param_specs`` under ``launch/specs.py::param_rules`` for every arch's
  smoke params under all four ``RULE_SETS``.  Meshes are arithmetic
  stand-ins here, as in ``tests/test_distributed.py``.
* ``distributed/compression.py``: codes, scale and residual bitwise the
  reference's eager ``quantize_int8`` / ``compressed_gradients``.
* ``launch/op_cost.py`` against the reference's ``jaxpr_cost``: the
  qwen3 smoke train step's flops.  At S = 16 (one attention block) they
  are equal.  At S = 64 (4 × 4 blocks of 16) the port counts less by
  exactly the attention blocks wholly above the diagonal, which its
  masked attention skips and the reference's computes and masks: 6 of
  16 block pairs, each 2 einsums (scores, values) of 2·B·16·16·H·dh
  flops, per layer and forward.
* ``launch/comm_bytes.py`` on known redistributions, ``roofline_terms``
  with the H100 constants, and the dry run of one smoke cell of each
  kind on a fake (2, 2, 2) mesh: a record in the reference's layout
  (``jaxpr_*`` renamed ``counted_*``, ``xla_*`` dropped) whose global
  counted flops equal the unsharded step's.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from repro import configs as jconfigs
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshd
from repro.launch import jaxpr_cost as jcost
from repro.launch import specs as jspecs
import repro_torch as rt
from repro_torch import configs as tconfigs
from repro_torch.core import rng
from repro_torch.core.utils import path_str, tree_paths
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as tspecs


class FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class FakeMesh2:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _same(port, ref) -> bool:
    return tuple(port) == tuple(ref)


@pytest.mark.parametrize("shape,names,want", [
    ((256, 4096), ["batch", None], JP(("pod", "data"), None)),
    ((1, 524288), ["batch", "kvseq"], JP(None, ("data", "model"))),
    ((128, 32768), ["batch", "kvseq"], JP(("pod", "data"), "model")),
    ((8,), ["batch"], JP("pod")),
])
def test_logical_spec_reference_cases(shape, names, want):
    """The four logical_spec cases of tests/test_distributed.py."""
    got = shd.logical_spec(shape, names, FakeMesh())
    assert _same(got, jshd.logical_spec(shape, names, FakeMesh()))
    assert _same(got, want)


def test_param_specs_right_alignment():
    rules = [(r"w$", ("fsdp", "model"))]
    tree = {"layers": {"w": torch.empty((28, 4096, 1024), device="meta")}}
    specs = shd.param_specs(tree, rules, FakeMesh())
    assert specs["layers"]["w"] == (None, "data", "model")


NAMES = ["batch", "seq", "model", "expert", "fsdp", "pod", "sp", "kvseq",
         None]
DIMS = [1, 2, 8, 12, 16, 32, 48, 256, 4096]


@pytest.mark.parametrize("mesh", [FakeMesh2(), FakeMesh()],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("rules", sorted(jshd.RULE_SETS))
def test_logical_spec_grid_matches_reference(mesh, rules):
    """Every (dim, dim) × (name, name) pair, left- and right-aligned."""
    with shd.use_mesh(mesh, shd.RULE_SETS[rules]), \
            jshd.use_mesh(mesh, jshd.RULE_SETS[rules]):
        for shape in itertools.product(DIMS, DIMS):
            for names in itertools.product(NAMES, NAMES):
                for align in ("left", "right"):
                    got = shd.logical_spec(shape, names[:1] if align ==
                                           "right" else names, mesh,
                                           align=align)
                    want = jshd.logical_spec(shape, names[:1] if align ==
                                             "right" else names, mesh,
                                             align=align)
                    assert _same(got, want), (shape, names, align)


def _ref_specs(cfg_name, rules, mesh):
    jcfg = jconfigs.get_smoke_config(cfg_name)
    with jshd.use_mesh(mesh, jshd.RULE_SETS[rules]):
        tree = jshd.param_specs(jspecs.abstract_params(jcfg),
                                jspecs.param_rules(jcfg), mesh)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(spec)
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_match_reference_every_rule_set(arch):
    """param_specs under param_rules, leaf for leaf by path, for the
    smoke params of every arch under all four RULE_SETS, on both
    production meshes (and with fsdp on)."""
    for mesh, rules, fsdp in itertools.product(
            (FakeMesh2(), FakeMesh()), sorted(shd.RULE_SETS), (False, True)):
        tcfg = tconfigs.get_smoke_config(arch).replace(fsdp=fsdp)
        jcfg = jconfigs.get_smoke_config(arch).replace(fsdp=fsdp)
        with shd.use_mesh(mesh, shd.RULE_SETS[rules]):
            got = shd.param_specs(tspecs.abstract_params(tcfg),
                                  tspecs.param_rules(tcfg), mesh)
        with jshd.use_mesh(mesh, jshd.RULE_SETS[rules]):
            ref = jshd.param_specs(jspecs.abstract_params(jcfg),
                                   jspecs.param_rules(jcfg), mesh)
        want = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: isinstance(x, JP))[0]:
            want["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)] = tuple(spec)
        have = {path_str(p): tuple(s) for p, s in tree_paths(got)}
        assert have == want, (arch, rules, fsdp)


def test_param_rules_are_the_references():
    for fsdp in (False, True):
        tcfg = tconfigs.get_smoke_config("qwen3-14b").replace(fsdp=fsdp)
        jcfg = jconfigs.get_smoke_config("qwen3-14b").replace(fsdp=fsdp)
        assert tspecs.param_rules(tcfg) == jspecs.param_rules(jcfg)


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


class OneMesh:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


@pytest.mark.parametrize("arch", ["qwen3-14b", "musicgen-medium",
                                  "deepseek-v3-671b", "zamba2-7b"])
def test_batch_and_cache_shardings_match_reference(arch):
    """batch_shardings / cache_shardings give the reference's specs (on
    a one-device mesh, the only real jax mesh a one-device process has;
    every axis divides there, so every named axis shows), and
    decode_input_specs(mesh=...) the shapes it gives without one."""
    jm = _one_device_mesh()
    tcfg, jcfg = (tconfigs.get_smoke_config(arch),
                  jconfigs.get_smoke_config(arch))
    shape = tconfigs.SHAPES["decode_32k"]
    jshape = jconfigs.SHAPES["decode_32k"]
    ttok, tcache = tspecs.decode_input_specs(tcfg, shape, OneMesh())
    ttok0, tcache0 = tspecs.decode_input_specs(tcfg, shape)
    assert [(p, tuple(v.shape)) for p, v in tree_paths(tcache)] == \
        [(p, tuple(v.shape)) for p, v in tree_paths(tcache0)]
    jtok, jcache = jspecs.decode_input_specs(jcfg, jshape, jm)
    got = {path_str(p): tuple(s.spec) for p, s in tree_paths(
        tspecs.cache_shardings(tcfg, tcache, OneMesh()))}
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jspecs.cache_shardings(jcfg, jcache, jm))[0]}
    assert got == want
    tb = tspecs.train_input_specs(tcfg, tconfigs.SHAPES["train_4k"])
    jb = jspecs.train_input_specs(jcfg, jconfigs.SHAPES["train_4k"])
    got = {k: tuple(s.spec) for k, s in
           tspecs.batch_shardings(tb, FakeMesh()).items()}
    want = {k: tuple(jshd.logical_spec(v.shape, ["batch"], FakeMesh()))
            for k, v in jb.items()}
    assert got == want


# --- compression ------------------------------------------------------------


def test_quantize_int8_bitwise_reference():
    g = np.random.default_rng(0).standard_normal((37, 53)).astype(np.float32)
    r = (np.random.default_rng(1).standard_normal((37, 53)) * 0.01
         ).astype(np.float32)
    for step in (0, 5, 123):
        q, s, nr = jcomp.quantize_int8(
            jnp.asarray(g), jnp.asarray(r),
            jax.random.fold_in(jax.random.PRNGKey(17), step))
        tq, ts, tnr = tcomp.quantize_int8(
            torch.from_numpy(g), torch.from_numpy(r),
            rng.fold_in(rng.prng_key(17), step))
        assert np.array_equal(np.asarray(q), tq.numpy())
        assert np.asarray(s) == ts.numpy()
        assert np.array_equal(np.asarray(nr), tnr.numpy())


def test_compressed_gradients_bitwise_reference():
    gen = np.random.default_rng(2)
    grads = {"a": gen.standard_normal((8, 16)).astype(np.float32),
             "b": [gen.standard_normal((5,)).astype(np.float32),
                   gen.standard_normal((3, 4)).astype(np.float32)]}
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    tg = rt.core.utils.tree_map(torch.from_numpy, grads)
    jr, tr = jcomp.compress_init(jg), tcomp.compress_init(tg)
    for step in range(3):
        jg2, jr = jcomp.compressed_gradients(jg, jr, step)
        tg2, tr = tcomp.compressed_gradients(tg, tr, step)
        for a, b in zip(jax.tree_util.tree_leaves((jg2, jr)),
                        rt.core.utils.tree_leaves((tg2, tr))):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert tcomp.dequantize_int8(torch.tensor([3], dtype=torch.int8),
                                 torch.tensor(0.5)).item() == 1.5


# --- op_cost / comm_bytes / roofline -----------------------------------------


def _ref_train_flops(seq):
    from repro.api import driver as jdriver
    from repro.core import mgd_init as jmgd_init
    from repro.launch import dryrun as jdry
    from repro.models import model_loss as jloss
    jcfg = jconfigs.get_smoke_config("qwen3-14b")
    jmc = jdry.default_mgd_config("forward")
    step = jdriver("discrete", jmc, lambda p, b: jloss(p, jcfg, b)).step
    ap = jspecs.abstract_params(jcfg)
    ast = jax.eval_shape(functools.partial(jmgd_init, cfg=jmc), ap)
    ab = {k: jax.ShapeDtypeStruct((4, seq), jnp.int32)
          for k in ("tokens", "labels")}
    return jcost.abstract_cost(step, ap, ast, ab)


def _port_train_cost(seq):
    from repro_torch.core import build_mgd_step, mgd_init
    from repro_torch.launch.dryrun import default_mgd_config
    from repro_torch.launch.op_cost import op_cost
    cfg = rt.get_smoke_config("qwen3-14b")
    mc = default_mgd_config("forward")
    params = rt.model_init(cfg, 0, device="cpu")
    toks = torch.zeros((4, seq), dtype=torch.int32)
    step = build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mc)
    _, cost = op_cost(step, params, mgd_init(params, mc),
                      {"tokens": toks, "labels": toks})
    return cost


def test_op_cost_flops_match_jaxpr_cost():
    """One attention block (S = 16): equal.  S = 64: lower by exactly the
    above-diagonal blocks the port's masked attention skips."""
    assert _port_train_cost(16)["flops"] == _ref_train_flops(16)["flops"]
    got, want = _port_train_cost(64)["flops"], _ref_train_flops(64)["flops"]
    cfg = rt.get_smoke_config("qwen3-14b")
    blk = cfg.attn_q_block
    nb = 64 // blk
    skipped = nb * nb - nb * (nb + 1) // 2
    per_block = 2 * (2 * 4 * blk * blk * cfg.n_heads * cfg.head_dim)
    assert want - got == skipped * per_block * cfg.n_layers * 2
    assert abs(want - got) / want < 0.07
    assert _port_train_cost(64)["unknown_while"] == 0


@pytest.fixture
def fake_world():
    from repro_torch.distributed.world import close_world, fake_world
    worlds = []

    def start(n):
        fake_world(n)
        worlds.append(n)

    yield start
    if worlds:
        close_world()


def test_comm_bytes_known_redistributions(fake_world):
    """x [64, 5120] (rows over data) · W [5120, 17408] (columns over
    model) on (16, 16), gathered to rows only: one all-gather whose
    result is this rank's [4, 17408] f32 rows; a Partial → Replicate is
    an all-reduce at 2× the result's bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.launch.comm_bytes import collective_bytes
    fake_world(256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data",
                                                              "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 5120), mesh,
                               [Shard(0), Replicate()], shape=(64, 5120),
                               stride=(5120, 1))
        w = DTensor.from_local(torch.empty(5120, 1088), mesh,
                               [Replicate(), Shard(1)],
                               shape=(5120, 17408), stride=(17408, 1))
        y, got = collective_bytes(
            lambda: (x @ w).redistribute(mesh, [Shard(0), Replicate()]))
        assert tuple(y.to_local().shape) == (4, 17408)
        assert got["by_type"] == {"all-gather": 4 * 17408 * 4}
        assert got["total_bytes"] == 4 * 17408 * 4 and len(got["ops"]) == 1
        p = DTensor.from_local(torch.empty(8, 8), mesh,
                               [Replicate(), Partial()], shape=(8, 8),
                               stride=(8, 1))
        _, got = collective_bytes(
            lambda: p.redistribute(mesh, [Replicate(), Replicate()]))
        assert got["by_type"] == {"all-reduce": 2.0 * 8 * 8 * 4}


def test_roofline_terms_are_the_references_formula_on_h100():
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline as troof
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    rec = {"chips": 256, "counted_flops": 6.2e15, "counted_bytes": 3.1e13,
           "collective_bytes_per_device": 2.5e11, "model_flops": 5.9e15}
    t = troof.roofline_terms(rec)
    assert t["compute"] == 6.2e15 / (256 * 989e12)
    assert t["memory"] == 3.1e13 / (256 * 3.35e12)
    assert t["collective"] == 2.5e11 / 50e9
    assert t["dominant"] == "collective"
    # the reference's formula, with its constants swapped for the H100's
    jrec = {"chips": 256, "jaxpr_flops": 6.2e15, "jaxpr_bytes": 3.1e13,
            "collective_bytes_per_device": 2.5e11, "model_flops": 5.9e15}
    old = (jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.LINK_BW)
    try:
        jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.LINK_BW = 989e12, 3.35e12, 50e9
        assert jroof.roofline_terms(jrec) == t
    finally:
        jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.LINK_BW = old
    # PERF.md's table: one row an (arch, shape), both meshes side by side
    full = dict(rec, arch="a", shape="train_4k", multi_pod=False,
                params=2e9, memory=dict(argument_bytes=2**30,
                                        temp_bytes=2**31, output_bytes=0))
    rows = troof.cells_table([full, {"arch": "b", "shape": "train_4k",
                                     "multi_pod": False, "skipped": "A15b"}])
    assert "| a | train_4k | 2.00 | 1.0508 / not run |" in rows
    assert "| b | train_4k | skipped: A15b" in rows


REF_KEYS = {"arch", "shape", "kind", "multi_pod", "chips", "tag",
            "mgd_mode", "overrides", "params", "params_active",
            "unknown_while", "model_flops", "collective_bytes_per_device",
            "collective_by_type", "n_collectives", "memory", "seconds"}


def _smoke_cells(monkeypatch):
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "get_config", lambda a: (
        tconfigs.get_smoke_config(a).replace(dtype="bfloat16")))
    shapes = dict(tconfigs.SHAPES)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shapes[name] = tconfigs.ShapeSpec(name, 64, 8, shapes[name].kind)
    monkeypatch.setattr(dryrun, "SHAPES", shapes)
    return dryrun


def _check_record(rec, tmp_path, chips, name, multi_pod):
    assert REF_KEYS <= set(rec)
    assert not any(k.startswith(("jaxpr", "xla")) for k in rec)
    assert rec["chips"] == chips and rec["unknown_while"] == 0
    assert rec["collective_bytes_per_device"] > 0
    assert set(rec["memory"]) >= {"argument_bytes", "temp_bytes",
                                  "output_bytes", "alias_bytes"}
    assert rec["memory"]["argument_bytes"] > 0
    suffix = "multipod" if multi_pod else "singlepod"
    assert (tmp_path / f"qwen3-14b_{name}_{suffix}.json").exists()


def test_dryrun_train_cell_on_a_fake_2x2x2_mesh(fake_world, tmp_path,
                                                monkeypatch):
    """The smoke train cell on a fake (2, 2, 2) mesh: the reference's
    record layout, global counted flops equal to the unsharded step's,
    collectives > 0, the updated params counted as donated."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.op_cost import op_cost
    fake_world(8)
    dryrun = _smoke_cells(monkeypatch)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    rec = dryrun.run_cell("qwen3-14b", "train_4k", multi_pod=True,
                          mesh=mesh, out_dir=str(tmp_path),
                          device_type="cpu", verbose=False)
    _check_record(rec, tmp_path, 8, "train_4k", True)
    cfg = tconfigs.get_smoke_config("qwen3-14b").replace(dtype="bfloat16")
    mc = dryrun.default_mgd_config("forward")
    params = rt.model_init(cfg, 0, device="cpu")
    toks = torch.zeros((8, 64), dtype=torch.int32)
    step = rt.build_mgd_step(lambda p, b: rt.model_loss(p, cfg, b), mc)
    _, cost = op_cost(step, params, rt.mgd_init(params, mc),
                      {"tokens": toks, "labels": toks})
    assert rec["counted_flops"] == cost["flops"]
    assert rec["memory"]["alias_bytes"] > 0
    assert dryrun.load_record(str(tmp_path), "qwen3-14b", "train_4k",
                              True) == rec


def test_dryrun_prefill_and_decode_cells_on_a_fake_2x2_mesh(
        fake_world, tmp_path, monkeypatch):
    """Prefill and one decode token against a seq_len cache, on a fake
    (2, 2) ("data", "model") mesh: records in the reference's layout."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(4)
    dryrun = _smoke_cells(monkeypatch)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("qwen3-14b", name, multi_pod=False, mesh=mesh,
                              out_dir=str(tmp_path), device_type="cpu",
                              verbose=False)
        _check_record(rec, tmp_path, 4, name, False)
        assert 0.5 < rec["counted_flops"] / rec["model_flops"] < 1.5


FAMILY_LAYERS = {"llama4-scout-17b-a16e": 1, "deepseek-v3-671b": 1,
                 "rwkv6-7b": 1, "zamba2-7b": 3}

FAMILY_CELL = r'''
import sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.distributed.world import close_world, fake_world
from repro_torch.launch import dryrun
arch, layers, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dryrun.get_config = lambda a: configs.get_smoke_config(a).replace(
    dtype="bfloat16", n_layers=layers)
dryrun.SHAPES = dict(configs.SHAPES,
                     train_4k=configs.ShapeSpec("train_4k", 16, 8, "train"))
fake_world(8)
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
dryrun.run_cell(arch, "train_4k", multi_pod=True, mesh=mesh, out_dir=out,
                device_type="cpu", verbose=False)
close_world()
'''


@pytest.fixture(scope="module")
def family_cells(tmp_path_factory):
    """The smoke train cell of MoE, MLA and the recurrent families on a
    fake (2, 2, 2) mesh, one process a cell, all four at once; beside
    them, the reference's ``jaxpr_cost`` of the same steps."""
    import os
    import subprocess
    import sys
    out = tmp_path_factory.mktemp("family_cells")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    procs = {a: subprocess.Popen(
        [sys.executable, "-c", FAMILY_CELL, a, str(n), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a, n in FAMILY_LAYERS.items()}
    from repro.api import driver as jdriver
    from repro.core import mgd_init as jmgd_init
    from repro.launch import dryrun as jdry
    from repro.models import model_loss as jloss
    want = {}
    for arch, n in FAMILY_LAYERS.items():
        jcfg = jconfigs.get_smoke_config(arch).replace(dtype="bfloat16",
                                                       n_layers=n)
        jmc = jdry.default_mgd_config("forward")
        step = jdriver("discrete", jmc, lambda p, b: jloss(p, jcfg, b)).step
        ap = jspecs.abstract_params(jcfg)
        ast = jax.eval_shape(functools.partial(jmgd_init, cfg=jmc), ap)
        ab = {k: jax.ShapeDtypeStruct((8, 16), jnp.int32)
              for k in ("tokens", "labels")}
        want[arch] = jcost.abstract_cost(step, ap, ast, ab)
    errs = {}
    for arch, p in procs.items():
        _, err = p.communicate(timeout=600)
        if p.returncode:
            errs[arch] = err[-3000:]
    return out, want, errs


@pytest.mark.parametrize("arch", list(FAMILY_LAYERS))
def test_dryrun_train_cell_of_each_family_on_a_fake_2x2x2_mesh(
        family_cells, arch):
    """MoE (llama4-scout), MLA (deepseek-v3) and the recurrent families
    (rwkv6, zamba2) run the dry run's train cell sharded: a record in the
    reference's layout whose counted flops match the reference's
    ``jaxpr_cost`` of the same step at
    ``test_op_cost_flops_match_jaxpr_cost``'s tolerance (7%; one
    attention block, S = 16)."""
    from repro_torch.launch import dryrun
    out, want, errs = family_cells
    assert arch not in errs, errs.get(arch)
    rec = dryrun.load_record(str(out), arch, "train_4k", True)
    assert "skipped" not in rec and REF_KEYS <= set(rec)
    assert rec["chips"] == 8 and rec["unknown_while"] == 0
    assert rec["collective_bytes_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["alias_bytes"] > 0
    ref = want[arch]["flops"]
    assert abs(rec["counted_flops"] - ref) / ref < 0.07


def test_meshes_and_the_dry_run_need_the_card_or_the_cpu_asked_for(
        fake_world, tmp_path, monkeypatch):
    """Without a card ``make_host_mesh()`` and ``run_cell`` raise rather
    than build gloo meshes on the CPU; ``device_type="cpu"`` asks for
    them (``run_cell`` with it: the smoke cells' tests above)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake_world(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("qwen3-14b", "decode_32k", multi_pod=False,
                        out_dir=str(tmp_path), verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.device_type == "cpu" and tuple(mesh.shape) == (4,)


def test_dryrun_reports_families_outside_the_cut_as_skipped(tmp_path):
    """The one cut left is the reference's own: long_500k for the archs
    outside ``LONG_CONTEXT_OK`` is reported as skipped (its runnable
    cells); every family runs every other cell."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("deepseek-v3-671b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path), verbose=False)
    assert "runnable" in rec["skipped"] and "A15b" not in rec["skipped"]
    assert dryrun.load_record(str(tmp_path), "deepseek-v3-671b",
                              "long_500k", False) == rec
    assert [(a, s) for a, s, ok in tconfigs.runnable_cells()
            if not ok] == [
        (a, "long_500k") for a in tconfigs.ARCH_IDS
        if a not in tconfigs.LONG_CONTEXT_OK]


# --- the reference's own program on a fake (2, 2) world (ROADMAP C9) --------

# the reference's dry-run train cell (``launch/dryrun.py``'s build_cell,
# jit, lower, compile, ``hlo_collectives.collective_bytes``) on four XLA
# CPU devices as (2, 2) ("data", "model"), the smoke config with fsdp=True
# in bf16, batch 4 × 16; prints its bytes by type and how many all-gathers
# run over all four devices.  ``run_cell`` itself is not called: its
# out_shardings name three of the step's four metrics, which the installed
# jax refuses for a train cell
REF_DRY_CELL = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.distributed import sharding as shd
from repro.launch import dryrun
from repro.launch.hlo_collectives import collective_bytes
arch, rules = sys.argv[1], sys.argv[2] or None
cfg = configs.get_smoke_config(arch).replace(dtype="bfloat16", fsdp=True)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
with shd.use_mesh(mesh, shd.RULE_SETS[rules] if rules else None):
    fn, args, sh, _ = dryrun.build_cell(
        cfg, configs.ShapeSpec("train_4k", 16, 4, "train"), mesh)
    metrics = dict.fromkeys(("cost", "c_tilde", "updated",
                             "grad_norm_proxy"), NamedSharding(mesh, P()))
    text = jax.jit(fn, in_shardings=sh, out_shardings=(sh[0], sh[1], metrics),
                   donate_argnums=(0, 1)).lower(*args).compile().as_text()
coll = collective_bytes(text, default_trip=1)
print(json.dumps(dict(by_type=coll["by_type"], gathers_over_all_four=sum(
    1 for line in text.splitlines() if " all-gather(" in line
    and "replica_groups=[1,4]" in line))))
"""

# the port's dry run of the same cell on a fake world of four
PORT_DRY_CELL = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.distributed.world import close_world, fake_world
from repro_torch.launch import dryrun
arch, rules = sys.argv[1], sys.argv[2] or None
dryrun.get_config = lambda a: configs.get_smoke_config(a).replace(
    dtype="bfloat16", fsdp=True)
dryrun.SHAPES = dict(configs.SHAPES,
                     train_4k=configs.ShapeSpec("train_4k", 16, 4, "train"))
fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(arch, "train_4k", multi_pod=False, mesh=mesh,
                      out_dir=None, device_type="cpu", verbose=False,
                      rule_set=rules)
close_world()
print(json.dumps(dict(by_type=rec["collective_by_type"])))
"""

SLICE_RULES = {"llama4-scout-17b-a16e": "moe_ep", "qwen2-72b": ""}


@pytest.fixture(scope="module")
def slice_dry_cells():
    """Both packages' dry-run cells of the four-card slice's two configs,
    four processes at once: {(package, arch): bytes by type, ...}."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {(pkg, arch): subprocess.Popen(
        [sys.executable, "-c", script, arch, rules], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg, script in (("reference", REF_DRY_CELL),
                            ("port", PORT_DRY_CELL))
        for arch, rules in SLICE_RULES.items()}
    out = {}
    for key, p in procs.items():
        stdout, err = p.communicate(timeout=600)
        assert p.returncode == 0, (key, err[-3000:])
        out[key] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch", list(SLICE_RULES))
def test_slice_dry_run_reduces_what_the_references_program_reduces(
        slice_dry_cells, arch):
    """The dry-run train cell of the four-card slice's configs (smoke,
    fsdp=True, bf16, batch 4 × 16, a (2, 2) ("data", "model") world)
    in both packages.  The reference's compiled program gathers the
    weights its rules give to "fsdp" and reduces activations only where
    a weight is split for tensor parallelism: under ``MOE_EP_RULES``
    (llama4-scout) "fsdp" is ("data", "model"), and its dense W are
    all-gathered over all four devices; under the default rules
    (qwen2-72b) W is gathered over "data" and ``wo``/``down``'s partial
    sums are all-reduced over "model".  XLA's CPU carries the bf16
    collectives as f32, so its bytes are ~2× a bf16 wire.  The port's
    all-reduce bytes lie within 10 % of half the reference's, and it
    sends no reduce-scatter: measured, llama4-scout 32,800 against
    68,640 / 2 (the parent, reducing its dense products, 688,160 and a
    65,536-byte reduce-scatter), qwen2-72b 83,488 against 165,408 / 2."""
    ref = slice_dry_cells[("reference", arch)]
    port = slice_dry_cells[("port", arch)]["by_type"]
    print(arch, "reference", ref, "port", port)
    if SLICE_RULES[arch] == "moe_ep":
        assert ref["gathers_over_all_four"] > 0
    half = ref["by_type"]["all-reduce"] / 2
    assert abs(port.get("all-reduce", 0.0) - half) <= 0.1 * half, (port,
                                                                   ref)
    assert "reduce-scatter" not in port, port
