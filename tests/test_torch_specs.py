"""Shapes with no allocation, and the public names of ``repro.core`` the
port had lacked.

* ``launch/specs.py::abstract_params`` gives, for all ten arch ids, full
  and smoke, the reference's leaf paths, shapes and dtypes, every leaf on
  the ``meta`` device; the input specs match the reference's
  ``ShapeDtypeStruct``s; the mesh-bound names (A15) give the
  reference's rules and specs.
* ``model_init`` on the CPU draws what it drew before the meta device
  was allowed (digests of four smoke configs' params, seed 0).
* ``make_mgd_epoch`` equals ``api.make_epoch`` over the same step
  bitwise, and tracks the reference's scanned ``make_mgd_epoch`` on XOR
  at the MLP's cross-framework tolerance (C̃ 1e-6, params 2e-4).
* ``COSTS``, ``make_mgd_epoch`` and ``tree_cast`` are exported as the
  reference exports them.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import configs as jconfigs
from repro.data import tasks as jtasks
from repro.data.pipeline import dataset_sampler as jdataset_sampler
from repro.launch import specs as jspecs
from repro.models.simple import make_mlp_probe_fn as jprobe_fn
from repro.models.simple import mlp_apply as jmlp_apply
from repro.models.simple import mlp_init as jmlp_init
import repro_torch as rt
import repro_torch.core as tcore
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.utils import tree_cast, tree_leaves
from repro_torch.data.pipeline import dataset_sampler
from repro_torch.launch import specs as tspecs

CT_ATOL = 1e-6
PARAM_ATOL = 2e-4
CONFIGS = [(arch, smoke) for arch in tconfigs.ARCH_IDS
           for smoke in (False, True)]
CONFIG_IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CONFIGS]


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _torch_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        assert tree.device.type == "meta", (prefix, tree.device)
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
    out = {}
    for k, v in items:
        out.update(_torch_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _get(mod, arch, smoke):
    return (mod.get_smoke_config if smoke else mod.get_config)(arch)


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=CONFIG_IDS)
def test_abstract_params_match_reference(arch, smoke):
    want = _jax_leaves(jspecs.abstract_params(_get(jconfigs, arch, smoke)))
    got = _torch_leaves(tspecs.abstract_params(_get(tconfigs, arch, smoke)))
    assert got == want


def test_param_counts_of_the_projected_configs():
    """The committed ``scaling_laws`` baseline's ``params_*`` values."""
    count = {a: sum(x.numel() for x in tree_leaves(
        tspecs.abstract_params(tconfigs.get_config(a))))
        for a in ("qwen3-14b", "deepseek-v3-671b")}
    assert count == {"qwen3-14b": 14_768_307_200,
                     "deepseek-v3-671b": 703_797_812_224}


@pytest.mark.parametrize("shape", sorted(tconfigs.SHAPES))
def test_input_specs_match_reference(shape):
    for arch in tconfigs.ARCH_IDS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        jshape, tshape = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
        for fn in ("train_input_specs", "prefill_input_specs"):
            assert (_torch_leaves(getattr(tspecs, fn)(tcfg, tshape))
                    == _jax_leaves(getattr(jspecs, fn)(jcfg, jshape))), \
                (arch, fn)
        jtok, jcache = jspecs.decode_input_specs(jcfg, jshape)
        ttok, tcache = tspecs.decode_input_specs(tcfg, tshape)
        assert _torch_leaves(ttok) == _jax_leaves(jtok), arch
        assert _torch_leaves(tcache) == _jax_leaves(jcache), arch


def test_mesh_bound_names_raise():
    """Named when the mesh-bound names raised (ROADMAP A15); they now
    give the reference's rule table and specs: ``param_shardings``,
    ``batch_shardings`` and ``cache_shardings`` on a (2, 16, 16) mesh
    stand-in, ``decode_input_specs(mesh=...)`` the shapes it gives
    without one."""
    from repro.distributed import sharding as jshd

    class FakeMesh:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 16, "model": 16}

    mesh = FakeMesh()
    cfg = tconfigs.get_smoke_config("qwen3-14b")
    jcfg = jconfigs.get_smoke_config("qwen3-14b")
    assert tspecs.param_rules(cfg) == jspecs.param_rules(jcfg)
    got = [tuple(s.spec) for s in tree_leaves(
        tspecs.param_shardings(cfg, mesh))]
    want = [tuple(s) for s in jax.tree_util.tree_leaves(
        jshd.param_specs(jspecs.abstract_params(jcfg),
                         jspecs.param_rules(jcfg), mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert got == want and any(any(e is not None for e in s) for s in got)
    shape = tconfigs.SHAPES["decode_32k"]
    tok, cache = tspecs.decode_input_specs(cfg, shape, mesh=mesh)
    tok0, cache0 = tspecs.decode_input_specs(cfg, shape)
    assert _torch_leaves(cache) == _torch_leaves(cache0)
    b = tspecs.batch_shardings(tok, mesh)
    assert tuple(b["tokens"].spec) == (("pod", "data"),)
    c = tspecs.cache_shardings(cfg, cache, mesh)
    assert tuple(c["k"].spec) == (None, ("pod", "data"), "model", None,
                                  None)
    assert tuple(c["length"].spec) == ()


# digests of model_init(smoke config, 0, device="cpu"), every leaf's f32
# bytes in flatten order, as drawn before the meta device was allowed
INIT_DIGESTS = {
    "qwen3-14b":
        "fa3bf31dc08e15ece0553819d9b73cfa898543441af7f3df3549f79dcbcd046b",
    "rwkv6-7b":
        "c2dd41a1d9630fd6f953171585259085abe6acc863e36f34b5f879df41c5d715",
    "zamba2-7b":
        "52c0881564f097c8b18bbb681297cc38a3bf1fc986dd6783223f9361be56c7f0",
    "deepseek-v3-671b":
        "5c811e33960438bd837aae74800de296b82115ba38419dbb633383742d3d96b8",
}


@pytest.mark.parametrize("arch", sorted(INIT_DIGESTS))
def test_model_init_on_cpu_draws_as_before(arch):
    params = rt.model_init(tconfigs.get_smoke_config(arch), 0, device="cpu")
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.float().numpy().tobytes())
    assert h.hexdigest() == INIT_DIGESTS[arch]


# --- A16: make_mgd_epoch, COSTS, tree_cast -----------------------------------

XOR_X, XOR_Y = (np.array(a) for a in jtasks.xor_dataset())
EPOCH_CASES = [dict(mode="central"), dict(mode="forward", tau_x=2),
               dict(mode="central", fused=True),
               dict(mode="forward", fused=True, replay=True, tau_theta=4)]
EPOCH_IDS = ["central", "forward-taux2", "central-fused",
             "forward-fused-replay4"]


def _xor_params():
    return jax.tree_util.tree_map(
        np.asarray, jmlp_init(jax.random.PRNGKey(0), (2, 2, 1)))


def _tloss(p, b):
    return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])


def _port_epoch(cfg, calls, steps):
    params = convert.to_torch(_xor_params(), device="cpu")
    sample = dataset_sampler(torch.from_numpy(XOR_X),
                             torch.from_numpy(XOR_Y), 1)
    run = tcore.make_mgd_epoch(
        _tloss, cfg, steps, sample,
        probe_fn=rt.make_mlp_probe_fn() if cfg.fused else None)
    state = tcore.mgd_init(params, cfg)
    cts = []
    for _ in range(calls):
        params, state, m = run(params, state)
        cts.append(m["c_tilde"])
    return params, state, torch.cat(cts)


@pytest.mark.parametrize("case", EPOCH_CASES, ids=EPOCH_IDS)
def test_make_mgd_epoch_equals_make_epoch(case):
    cfg = tcore.MGDConfig(dtheta=1e-2, eta=0.5, seed=3, **case)
    params, state, cts = _port_epoch(cfg, 2, 12)
    drv = rt.driver("discrete", cfg, _tloss,
                    probe_fn=rt.make_mlp_probe_fn() if cfg.fused else None,
                    device="cpu")
    p = convert.to_torch(_xor_params(), device="cpu")
    s = drv.init(p)
    run = rt.make_epoch(drv, 12, dataset_sampler(
        torch.from_numpy(XOR_X), torch.from_numpy(XOR_Y), 1))
    auxes = []
    for _ in range(2):
        p, s, aux = run(p, s)
        auxes.append(aux["c_tilde"])
    assert state.step == s.step == 24
    assert torch.equal(cts, torch.cat(auxes))
    for a, b in zip(tree_leaves(params), tree_leaves(p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", EPOCH_CASES, ids=EPOCH_IDS)
def test_make_mgd_epoch_tracks_reference(case):
    base = dict(dtheta=1e-2, eta=0.5, seed=3, **case)
    t_params, _, t_cts = _port_epoch(tcore.MGDConfig(**base), 2, 16)
    jcfg = jcore.MGDConfig(
        kernel_impl="interpret" if case.get("fused") else None, **base)
    run = jcore.make_mgd_epoch(
        lambda p, b: jcore.mse(jmlp_apply(p, b["x"]), b["y"]), jcfg, 16,
        jdataset_sampler(jnp.asarray(XOR_X), jnp.asarray(XOR_Y), 1),
        probe_fn=jprobe_fn() if case.get("fused") else None)
    p = jax.tree_util.tree_map(jnp.asarray, _xor_params())
    s = jcore.mgd_init(p, jcfg)
    j_cts = []
    for _ in range(2):
        p, s, m = run(p, s)
        j_cts.append(np.asarray(m["c_tilde"]))
    np.testing.assert_allclose(t_cts.numpy(), np.concatenate(j_cts),
                               rtol=0, atol=CT_ATOL)
    for a, b in zip(tree_leaves(t_params), jax.tree_util.tree_leaves(p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)


def test_core_exports_match_reference():
    for name in ("make_mgd_epoch", "COSTS"):
        assert name in jcore.__all__ and name in tcore.__all__
        assert getattr(tcore, name) is not None
    assert set(tcore.COSTS) == set(jcore.COSTS)
    tree = [{"w": torch.ones(2, 3), "b": torch.zeros(3)}]
    cast = tree_cast(tree, torch.bfloat16)
    assert [x.dtype for x in tree_leaves(cast)] == [torch.bfloat16] * 2
    assert torch.equal(cast[0]["w"].float(), tree[0]["w"])
