"""The port's counter hash, signs, generators and leaf ids against the JAX
package, bitwise: these are what let the CUDA kernels regenerate θ̃
instead of storing it, so any drift here would change every sign."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perturbations as jpert
from repro.core.utils import leaf_id_tree as jleaf_id_tree
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.core import perturbations as tpert
from repro_torch.core import utils as tutils

SEED_CASES = [(0, 0, 0), (7, 3, 2), (3, 35, 1), (0xFFFFFFFF, 0, 3),
              (123456789, 2 ** 31 - 1, 9), (1, -1, 0), (42, -12345, 7),
              (2 ** 31 + 5, 1000003, 0)]


def _jax_seed(seed, step, lid):
    return int(np.asarray(jpert.leaf_seed(
        jnp.uint32(seed), jnp.asarray(step, jnp.int32), lid)))


@pytest.mark.parametrize("seed,step,lid", SEED_CASES)
def test_leaf_seed_matches_reference(seed, step, lid):
    """Host-int seeds, including negative (replay) steps that wrap as
    uint32 and seeds at the top of the uint32 range."""
    assert tpert.leaf_seed(seed, step, lid) == _jax_seed(seed, step, lid)


def test_leaf_seed_tensor_form_matches_host_form():
    steps = torch.arange(-50, 50, dtype=torch.int64)
    got = tpert.leaf_seed(11, steps, 3)
    want = [tpert.leaf_seed(11, int(s), 3) for s in steps]
    assert got.tolist() == want


@pytest.mark.parametrize("lseed_args", [(7, 3, 2), (0, 0, 0), (99, 12, 5)])
def test_rademacher_signs_bitwise_near_wraparound(lseed_args):
    """≥ 100k indices, half of them just below 2³², against
    ``repro.core.perturbations.rademacher_signs``."""
    half = 60_000
    idx = np.concatenate([
        np.arange(half, dtype=np.uint32),
        np.uint32(2 ** 32 - half) + np.arange(half, dtype=np.uint32)])
    lseed = _jax_seed(*lseed_args)
    want = np.asarray(jpert.rademacher_signs(jnp.uint32(lseed),
                                             jnp.asarray(idx)))
    got = tpert.rademacher_signs(
        lseed, torch.from_numpy(idx.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset", [0, 1, 40 * 17, 2 ** 31 + 3, 2 ** 32 - 1])
def test_shifted_leaf_seed_matches_reference(offset):
    lseed = _jax_seed(5, 9, 2)
    want = int(np.asarray(jpert.shifted_leaf_seed(
        jnp.uint32(lseed), jnp.asarray(offset, jnp.uint32))))
    assert tpert.shifted_leaf_seed(lseed, offset) == want


def _params_np():
    p = jmlp_init(jax.random.PRNGKey(0), (49, 4, 4))
    return jax.tree_util.tree_map(np.asarray, p)


def _like_np(shapes):
    return [{"w": np.zeros(s, np.float32), "b": np.zeros(s[-1:], np.float32)}
            for s in shapes]


@pytest.mark.parametrize("ptype", ["rademacher", "walsh", "sequential"])
@pytest.mark.parametrize("step,tau_p", [(0, 1), (5, 1), (17, 3), (250, 4)])
def test_generate_bitwise(ptype, step, tau_p):
    like = _like_np([(49, 4), (4, 4), (3, 5, 2)])
    want = jpert.generate(jax.tree_util.tree_map(jnp.asarray, like),
                          ptype=ptype, step=jnp.int32(step),
                          seed=jnp.uint32(13), dtheta=1e-2, tau_p=tau_p)
    got = tpert.generate(convert.to_torch(like, device="cpu"), ptype=ptype,
                         step=step, seed=13, dtheta=1e-2, tau_p=tau_p)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    tutils.tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("step", [0, 3, 1000])
def test_generate_sinusoidal_within_sin_rounding(step):
    """``sin`` is not bit-portable between XLA and torch: 1e-7·Δθ-scale
    agreement (a few f32 ulps of the Δθ-scaled wave)."""
    like = _like_np([(49, 4), (4, 4)])
    want = jpert.generate(jax.tree_util.tree_map(jnp.asarray, like),
                          ptype="sinusoidal", step=jnp.int32(step),
                          seed=jnp.uint32(0), dtheta=1e-2, tau_p=2)
    got = tpert.generate(convert.to_torch(like, device="cpu"),
                         ptype="sinusoidal", step=step, seed=0, dtheta=1e-2,
                         tau_p=2)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    tutils.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-8)


def test_signs_only_and_rademacher_leaf_bitwise():
    like = _like_np([(49, 4), (4, 4)])
    jl = jax.tree_util.tree_map(jnp.asarray, like)
    want = jpert.generate_signs_only(jl, step=jnp.int32(9),
                                     seed=jnp.uint32(4), tau_p=2)
    got = tpert.generate_signs_only(convert.to_torch(like, device="cpu"),
                                    step=9, seed=4, tau_p=2)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    tutils.tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # a row-major slice of a stacked bank: layer 2 of [3, 40, 17]
    off = 2 * 40 * 17
    want = jpert.rademacher_leaf((40, 17), jnp.float32, 5, step=jnp.int32(7),
                                 seed=jnp.uint32(1), dtheta=0.1, offset=off)
    lseed = tpert.shifted_leaf_seed(tpert.leaf_seed(1, 7, 5), off)
    got = tpert.leaf_theta(torch.empty((40, 17)), lseed, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_leaf_ids_49_4_4():
    """JAX flatten order: dict keys sorted, so each bias precedes its
    weight."""
    params = _params_np()
    want = jleaf_id_tree(params)
    got = tutils.leaf_id_tree(convert.to_torch(params, device="cpu"))
    assert got == want == [{"b": 0, "w": 1}, {"b": 2, "w": 3}]


def test_leaf_meta_matches_reference():
    params = _params_np()
    from repro.core.utils import leaf_meta as jleaf_meta
    assert tutils.leaf_meta(convert.to_torch(params, device="cpu")) \
        == jleaf_meta(params)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_apply_signed_matches_reference(sign):
    rng = np.random.default_rng(0)
    leaf = rng.standard_normal((4,)).astype(np.float32)
    theta = (rng.standard_normal((4,)) * 1e-2).astype(np.float32)
    want = jpert.apply_signed(jnp.asarray(leaf), jnp.asarray(theta), sign)
    got = tpert.apply_signed(torch.from_numpy(leaf), torch.from_numpy(theta),
                             sign)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("step,tau_p", [(0, 1), (7, 1), (7, 4)])
def test_probe_lseed_and_theta_match_reference(step, tau_p):
    jctx = jpert.ProbeCtx(signs=(1.0, -1.0), dtheta=1e-2, tau_p=tau_p)
    tctx = tpert.ProbeCtx(signs=(1.0, -1.0), dtheta=1e-2, tau_p=tau_p)
    jp = jpert.Probe(jnp.int32(step), jnp.uint32(3), jctx)
    tp = tpert.Probe(step, 3, tctx)
    for lid in range(4):
        assert tp.lseed(lid) == int(np.asarray(jp.lseed(lid)))
    np.testing.assert_array_equal(
        tpert.leaf_theta(torch.empty((4,)), tp.lseed(2),
                         tctx.dtheta).numpy(),
        np.asarray(jp.leaf_theta((4,), jnp.float32, 2)))
    assert tctx.is_pair and tctx.n_streams == 2


def test_tree_flatten_roundtrip_and_order():
    tree = {"z": [torch.zeros(1), (torch.ones(2), None)], "a": torch.ones(3)}
    leaves, treedef = tutils.tree_flatten(tree)
    assert [t.numel() for t in leaves] == [3, 1, 2]
    back = tutils.tree_unflatten(treedef, leaves)
    assert back["z"][1][1] is None and back["a"] is leaves[0]


def test_tree_flatten_and_map_free_leaves_without_gc():
    """Flattening leaves no reference cycle behind: with the cyclic
    garbage collector off, a leaf dies with its last outside reference.
    (At LM widths a cycle holding a parameter tree kept whole trees of
    old parameters alive across training steps.)"""
    import gc
    import weakref
    gc.disable()
    try:
        t = torch.zeros(3)
        tree = {"a": [t, (t,)], "b": None}
        leaves, treedef = tutils.tree_flatten(tree)
        out = tutils.tree_map(lambda x: x + 1,
                              tutils.tree_unflatten(treedef, leaves))
        refs = [weakref.ref(t), weakref.ref(out["a"][0])]
        del t, tree, leaves, out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
