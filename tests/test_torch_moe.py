"""The port's mixture of experts against the JAX package's.

Parameters are the reference's (``repro.models.moe.moe_init`` on the
llama4-scout and deepseek-v3 smoke configs, f32), carried with
``repro_torch.convert``; activations are made by numpy and fed to both.

* ``moe_apply`` against the reference within 1e-6 (outputs of scale ~1;
  the router's f32 matmul and softmax round apart from XLA's in the last
  ulp, ~1e-7).
* The routing bitwise: the experts each token picks equal the
  reference's, and, given the reference's own router probabilities, the
  port's gates, kept set and ``combine`` [G, Sg, E, C] equal the
  reference's bit for bit, with capacity drops and without.  The
  reference's intermediates are read by wrapping the ``jax.lax.top_k``
  and ``jnp.einsum`` that ``repro.models.moe`` calls.
* ``capacity`` equals the reference's on a grid; ties in the router go to
  the lower expert index, as in ``jax.lax.top_k``.
* With capacity ≥ the group size nothing drops, and prefill + decode
  equals the full forward below 5e-4, the bound ``tests/test_models.py``
  holds the reference to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import moe as jmoe
from repro.models import transformer as jt
import repro_torch as rt
from repro_torch import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

OUT_ATOL = 1e-6
PROB_ATOL = 1e-6
SELF_ATOL = 5e-4
B, S = 2, 32


def _cfgs(arch, **kw):
    return (jsmoke(arch).replace(**kw),
            rt.get_smoke_config(arch).replace(**kw))


def _moe_params(jcfg, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _x(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


class _Spy:
    """Stands in for a module: ``hooks`` first, the module otherwise."""

    def __init__(self, module, **hooks):
        self._module, self._hooks = module, hooks

    def __getattr__(self, name):
        return self._hooks.get(name, getattr(self._module, name))


def _reference_with_routing(monkeypatch, jp, jcfg, x, **kw):
    """The reference's ``moe_apply`` output, with its router probabilities
    (the input of ``top_k``), its normalized gates' expert ids and its
    ``combine`` (the first operand of the final einsum)."""
    seen = {}

    def top_k(probs, k):
        seen["probs"] = np.asarray(probs)
        vals, idx = jax.lax.top_k(probs, k)
        seen["idx"] = np.asarray(idx)
        return vals, idx

    def einsum(spec, *ops, **kwargs):
        if spec == "gsec,egcd->gsd":
            seen["combine"] = np.asarray(ops[0])
        return jnp.einsum(spec, *ops, **kwargs)

    monkeypatch.setattr(jmoe, "jax", _Spy(jax, lax=_Spy(jax.lax,
                                                         top_k=top_k)))
    monkeypatch.setattr(jmoe, "jnp", _Spy(jnp, einsum=einsum))
    y = np.asarray(jmoe.moe_apply(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jcfg, **kw))
    monkeypatch.undo()
    return y, seen


@pytest.mark.parametrize("arch,kw,drops", [
    ("llama4-scout-17b-a16e", dict(group_size=32, capacity_factor=1.0),
     True),
    ("llama4-scout-17b-a16e", dict(group_size=32, capacity_factor=8.0),
     False),
    ("deepseek-v3-671b", dict(group_size=32, capacity_factor=1.0), True),
    ("deepseek-v3-671b", dict(group_size=32, capacity_factor=8.0), False),
], ids=["llama4-drops", "llama4-nodrop", "deepseek-drops",
        "deepseek-nodrop"])
def test_moe_apply_matches_reference(monkeypatch, arch, kw, drops):
    jcfg, tcfg = _cfgs(arch)
    jp = _moe_params(jcfg)
    x = _x(jcfg)
    want, seen = _reference_with_routing(monkeypatch, jp, jcfg, x, **kw)
    tp = convert.to_torch(jp, device="cpu")
    got = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)

    # the port's own routing picks the reference's experts
    g = B * S // kw["group_size"]
    probs = tmoe.router_probs(tp, torch.from_numpy(x).reshape(
        g, kw["group_size"], -1))
    np.testing.assert_allclose(probs.numpy(), seen["probs"], rtol=0,
                               atol=PROB_ATOL)
    c = tmoe.capacity(kw["group_size"], jcfg.n_experts_active,
                      jcfg.n_experts, kw["capacity_factor"])
    _, idx, combine, keep = tmoe.route(probs, jcfg.n_experts_active, c)
    np.testing.assert_array_equal(idx.numpy(), seen["idx"])
    # given the reference's probabilities, its dispatch bit for bit
    _, idx_r, combine_r, keep_r = tmoe.route(
        torch.from_numpy(seen["probs"]), jcfg.n_experts_active, c)
    assert combine_r.dtype == torch.float32
    np.testing.assert_array_equal(combine_r.numpy(), seen["combine"])
    assert torch.equal(keep_r, keep) and torch.equal(idx_r, idx)
    routed = B * S * jcfg.n_experts_active
    assert (int(keep.sum()) < routed) == drops


def test_moe_apply_dense_ref_matches_reference_and_dispatch():
    """The dense oracle against the reference's, and ``moe_apply`` with no
    drops against the oracle."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    jp = _moe_params(jcfg, seed=3)
    x = _x(jcfg, seed=4)
    want = np.asarray(jmoe.moe_apply_dense_ref(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jcfg))
    tp = convert.to_torch(jp, device="cpu")
    dense = tmoe.moe_apply_dense_ref(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(dense.numpy(), want, rtol=0, atol=OUT_ATOL)
    grouped = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, group_size=16,
                             capacity_factor=16.0)
    np.testing.assert_allclose(grouped.numpy(), dense.numpy(), rtol=0,
                               atol=OUT_ATOL)


def test_capacity_matches_reference_on_a_grid():
    for gs in (1, 7, 32, 128, 512):
        for k in (1, 2, 8):
            for e in (4, 16, 256):
                for factor in (0.5, 1.0, 1.25, 8.0, 32.0):
                    assert tmoe.capacity(gs, k, e, factor) == \
                        jmoe.capacity(gs, k, e, factor)
    assert tmoe.capacity(128, 8, 256, 32.0) == 128     # no drop possible


def test_tied_router_picks_the_lower_expert(monkeypatch):
    """A router whose expert columns repeat gives tied probabilities; the
    top-k takes the lower expert index first, as ``jax.lax.top_k``."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    jp = _moe_params(jcfg, seed=5)
    w = jp["router"]["w"].copy()
    w[:, 4:] = w[:, :4]                        # experts i and i + 4 tie
    jp = dict(jp, router=dict(jp["router"], w=w))
    x = _x(jcfg, seed=6)
    kw = dict(group_size=32, capacity_factor=8.0)
    want, seen = _reference_with_routing(monkeypatch, jp, jcfg, x, **kw)
    probs = torch.from_numpy(seen["probs"])
    assert torch.equal(probs[..., :4], probs[..., 4:])
    _, idx = tmoe.top_k(probs, jcfg.n_experts_active)
    np.testing.assert_array_equal(idx.numpy(), seen["idx"])
    # the top pair is a tie, taken lower id first
    assert (idx[..., 0] < 4).all() and torch.equal(idx[..., 1],
                                                   idx[..., 0] + 4)
    ties = torch.stack([probs, probs], -1).reshape(-1, 2)
    assert torch.equal(tmoe.top_k(ties, 2)[1], torch.tensor([0, 1]).expand(
        ties.shape[0], 2))
    got = tmoe.moe_apply(convert.to_torch(jp, device="cpu"),
                         torch.from_numpy(x), tcfg, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)


def test_drop_recorder_counts_the_routings_capacity_drops():
    _, tcfg = _cfgs("llama4-scout-17b-a16e")
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                       torch.float32, "cpu")
    x = torch.from_numpy(_x(tcfg, seed=2))
    with tmoe.DropRecorder() as rec:
        tmoe.moe_apply(tp, x, tcfg, group_size=32, capacity_factor=1.0)
        tmoe.moe_apply(tp, x, tcfg, group_size=32, capacity_factor=8.0)
    routed, dropped = rec.totals()
    assert routed == 2 * B * S
    probs = tmoe.router_probs(tp, x.reshape(2, 32, -1))
    keep = tmoe.route(probs, 1, tmoe.capacity(32, 1, 4, 1.0))[3]
    assert dropped == B * S - int(keep.sum()) > 0
    assert not tmoe._RECORDERS


def test_router_is_f32_in_a_bf16_model():
    """``convert`` carries the reference's f32 router and bf16 banks."""
    jcfg, _ = _cfgs("llama4-scout-17b-a16e", dtype="bfloat16")
    p = convert.to_torch(jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jcfg,
                                  jnp.bfloat16)), device="cpu")
    assert p["router"]["w"].dtype == torch.float32
    assert p["gate"].dtype == p["shared"]["up"]["w"].dtype == torch.bfloat16
    tcfg = rt.get_smoke_config("llama4-scout-17b-a16e").replace(
        dtype="bfloat16")
    own = tt.model_init(tcfg, 0, device="cpu")["layers"]["moe"]
    assert own["router"]["w"].dtype == torch.float32
    assert own["gate"].shape == (tcfg.n_layers, tcfg.n_experts,
                                 tcfg.d_model, tcfg.d_ff)
    assert own["gate"].dtype == torch.bfloat16


def test_moe_prefill_decode_parity_at_high_capacity():
    """Twin of ``tests/test_models.py::test_moe_prefill_decode_parity_at_
    high_capacity``: with capacity ≥ E/k nothing drops, and decode through
    groups of B tokens equals the full forward's groups."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", moe_capacity_factor=8.0)
    params = convert.to_torch(jax.tree_util.tree_map(
        np.asarray, jt.model_init(jcfg, jax.random.PRNGKey(0))),
        device="cpu")
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(5), (B, S), 0, jcfg.vocab)))
    full = tt.model_forward(params, tcfg, {"tokens": toks})
    pf, cache = tt.model_prefill(params, tcfg, {"tokens": toks[:, :16]}, 64)
    errs = [(pf[:, :16] - full[:, :16]).abs().max().item()]
    for t in range(16, S):
        lg, cache = tt.model_decode(params, tcfg, toks[:, t], cache)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < SELF_ATOL, max(errs)
    assert int(cache["length"]) == S

