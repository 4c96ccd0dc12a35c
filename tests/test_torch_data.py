"""The port's samplers against the JAX package's (ROADMAP C1).

Batch i of a sampler is ``batch_fn(fold_in(PRNGKey(seed), i), B)`` in both
packages, on ``core.rng``'s threefry.  Over indices 0..63:

* ``rng.randint`` and ``rng.bernoulli`` are bitwise ``jax.random``'s, so
  labels, shifts and the LM's chain bits are bitwise;
* images are ``template[label]`` rolled by the shift plus noise·normal:
  handed jax's own normals (``jax_normals``) the port's images are
  bitwise the reference's, and with its own normals (within
  ``rng.NORMAL_ULPS`` of jax's) within ``_image_tol`` of them;
* LM tokens are bitwise except where ``exp(u·log V)`` rounds across an
  integer in torch and not in XLA: at V = 151,936 (Qwen3-14B), batch
  8 × 65, seed 0, the Zipf draw flips at ``LM_EXP_FLIPS`` = 5 of 33,280
  positions (by one), and ``LM_TOKEN_FLIPS`` = 1 of them survives into
  the tokens (the chain overwrites the rest).

The reference is held eagerly.  Its samplers also run inside the jitted
``make_epoch`` scan, where XLA contracts ``imgs + noise·normal`` into a
fused multiply-add: there its own images differ from its eager ones by
one rounding (measured: 828 of 25,088 NIST7x7 pixels, max 2.4e-7; 63,737
of 200,704 Fashion pixels, max 4.8e-7), while labels, shifts and LM
tokens are unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.data import tasks as jtasks
from repro_torch.core import rng
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import tasks as ttasks

INDICES = range(64)
SPANS = [1, 3, 4, 5, 10, 2 ** 31 - 1]
LM_VOCAB, LM_BATCH, LM_SEQ = 151936, 8, 64
LM_EXP_FLIPS = 5
LM_TOKEN_FLIPS = 1


def _jkey(key):
    return jnp.array(key, dtype=jnp.uint32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("span", SPANS)
def test_randint_bitwise_jax(span):
    for minval in (0, -7, -(2 ** 30)):
        if minval + span > 2 ** 31 - 1:
            minval = -span // 2
        for seed, i in ((0, 0), (5, 3), (123456, 63)):
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), i)
            tk = rng.fold_in(rng.prng_key(seed), i)
            for shape in ((257,), (8, 2), ()):
                want = np.asarray(jax.random.randint(jk, shape, minval,
                                                     minval + span))
                got = rng.randint(tk, shape, minval, minval + span,
                                  device="cpu")
                assert got.dtype == torch.int64
                np.testing.assert_array_equal(got.numpy(), want)


def test_randint_empty_span_returns_minval():
    tk = rng.prng_key(3)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (9,), 4, 2))
    got = rng.randint(tk, (9,), 4, 2, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 4).all()


def test_bernoulli_bitwise_jax():
    for seed in (0, 9, 2 ** 31 - 1):
        for p in (0.75, 0.5, 0.1):
            want = np.asarray(jax.random.bernoulli(
                jax.random.PRNGKey(seed), p, (33, 65)))
            got = rng.bernoulli(rng.prng_key(seed), p, (33, 65),
                                device="cpu")
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want)


# --- image samplers ------------------------------------------------------------

# name: (reference batch_fn, port batch_fn, batch, noise, shift range)
IMAGE_SAMPLERS = {
    "nist7x7": (jtasks.nist7x7_batch, ttasks.nist7x7_batch, 8, 0.25,
                (-1, 2)),
    "fashion": (jtasks.fashion_batch, ttasks.fashion_batch, 4, 0.6, (-2, 3)),
    "cifar": (jtasks.cifar_batch, ttasks.cifar_batch, 4, 0.6, (-2, 3)),
}


def _image_tol(x_ref, normals, noise):
    """What the port's images may differ by, elementwise, when its normals
    are within ``NORMAL_ULPS`` of jax's: that many ulps of the noise term
    (scaled by ``noise``, plus its rounding) and one ulp of the sum."""
    term = np.abs(np.float32(noise) * normals)
    return ((rng.NORMAL_ULPS + 1) * np.spacing(term)
            + np.spacing(np.abs(x_ref)))


@pytest.mark.parametrize("name", sorted(IMAGE_SAMPLERS))
def test_image_sampler_matches_reference(name, monkeypatch):
    jfn, tfn, batch, noise, (lo, hi) = IMAGE_SAMPLERS[name]
    seed = 3
    jsample = jpipeline.generator_sampler(jfn, batch, seed=seed)
    tsample = tpipeline.generator_sampler(tfn, batch, seed=seed,
                                          device="cpu")
    own_normal = rng.normal
    drawn = {}

    def jax_normals(key, shape, device=None):
        drawn["port"] = own_normal(key, shape, device=device).numpy()
        drawn["jax"] = np.asarray(jax.random.normal(_jkey(key), shape))
        return torch.from_numpy(drawn["jax"].copy()).to(device)

    differ = total = 0
    for i in INDICES:
        want = jsample(i)
        x_ref, y_ref = np.asarray(want["x"]), np.asarray(want["y"])
        got = tsample(i)                         # the port's own normals
        # labels (one-hot) and shifts bitwise
        np.testing.assert_array_equal(got["y"].numpy(), y_ref)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        tkey = rng.fold_in(rng.prng_key(seed), i)
        k_shift, tk_shift = jax.random.split(key, 3)[1], rng.split(tkey)[1]
        np.testing.assert_array_equal(
            rng.randint(tk_shift, (batch, 2), lo, hi, device="cpu").numpy(),
            np.asarray(jax.random.randint(k_shift, (batch, 2), lo, hi)))
        # with jax's normals: the images bitwise
        with monkeypatch.context() as m:
            m.setattr(rng, "normal", jax_normals)
            patched = tsample(i)
        np.testing.assert_array_equal(patched["x"].numpy(), x_ref)
        # the port's own normals within NORMAL_ULPS, its images within tol
        assert _ulps(drawn["port"], drawn["jax"]).max() <= rng.NORMAL_ULPS
        gap = np.abs(got["x"].numpy() - x_ref).reshape(drawn["jax"].shape)
        assert (gap <= _image_tol(x_ref.reshape(gap.shape), drawn["jax"],
                                  noise)).all()
        differ += int((gap > 0).sum())
        total += gap.size
    assert got["x"].shape == x_ref.shape and got["x"].dtype == torch.float32
    assert differ / total < 0.1


def test_lm_sampler_matches_reference():
    """Tokens and labels bitwise but for the counted ``exp`` flips; the
    uniforms and the chain's Bernoulli bits bitwise."""
    jsample = jpipeline.lm_sampler(LM_BATCH, LM_SEQ, LM_VOCAB, seed=0)
    tsample = tpipeline.lm_sampler(LM_BATCH, LM_SEQ, LM_VOCAB, seed=0,
                                   device="cpu")
    shape = (LM_BATCH, LM_SEQ + 1)
    log_v = np.float32(np.log(LM_VOCAB))
    token_flips = z_flips = 0
    for i in INDICES:
        want, got = jsample(i), tsample(i)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64 and got[k].shape == (
                LM_BATCH, LM_SEQ)
        np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                      got["labels"][:, :-1].numpy())
        token_flips += int((got["tokens"].numpy()
                            != np.asarray(want["tokens"])).sum())
        k1, k2 = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0), i))
        t1, t2 = rng.split(rng.fold_in(rng.prng_key(0), i))
        u_j = np.asarray(jax.random.uniform(k1, shape, minval=1e-6))
        u_t = rng.uniform(t1, shape, 1e-6, 1.0, device="cpu")
        np.testing.assert_array_equal(u_t.numpy(), u_j)
        np.testing.assert_array_equal(
            rng.bernoulli(t2, 0.75, shape, device="cpu").numpy(),
            np.asarray(jax.random.bernoulli(k2, 0.75, shape)))
        z_j = np.asarray(jnp.exp(jnp.asarray(u_j) * log_v)
                         ).astype(np.int32)
        z_t = torch.exp(u_t * torch.tensor(log_v)).to(torch.int64).numpy()
        assert np.abs(z_t - z_j).max() <= 1
        z_flips += int((z_t != z_j).sum())
    assert z_flips == LM_EXP_FLIPS
    assert token_flips == LM_TOKEN_FLIPS


def test_samplers_are_pure_functions_of_the_index():
    sample = tpipeline.generator_sampler(ttasks.fashion_batch, 4, seed=3,
                                         device="cpu")
    a, b, c = sample(5), sample(5), sample(6)
    assert torch.equal(a["x"], b["x"]) and not torch.equal(a["x"], c["x"])
    x, y = ttasks.fashion_batch(rng.fold_in(rng.prng_key(3), 5), 4,
                                device="cpu")
    assert torch.equal(x, a["x"]) and torch.equal(y, a["y"])
    assert x.shape == (4, 28, 28, 1)
    assert ttasks.cifar_batch(rng.prng_key(1), 2, device="cpu")[0].shape \
        == (2, 32, 32, 3)


def test_templates_match_reference():
    for args in ((28, 1, 10, 23), (32, 3, 10, 29), (16, 2, 4, 17)):
        np.testing.assert_array_equal(ttasks._templates(*args),
                                      jtasks._templates(*args))


# --- chip-farm batch shards ----------------------------------------------------


def _batch(n=8):
    rs = np.random.default_rng(0)
    return {"x": rs.standard_normal((n, 3)).astype(np.float32),
            "y": {"a": np.arange(n, dtype=np.int32),
                  "b": [np.ones((n, 2), np.float32)]}}


@pytest.mark.parametrize("n_chips", [1, 2, 4])
def test_shard_chip_batch_matches_reference(n_chips):
    batch = _batch()
    tbatch = {"x": torch.from_numpy(batch["x"]),
              "y": {"a": torch.from_numpy(batch["y"]["a"]),
                    "b": [torch.from_numpy(batch["y"]["b"][0])]}}
    jpipeline.check_chip_shardable(batch, n_chips)
    tpipeline.check_chip_shardable(tbatch, n_chips)
    for chip in range(n_chips):
        want = jax.tree_util.tree_leaves(
            jpipeline.shard_chip_batch(batch, n_chips, chip))
        for src in (batch, tbatch):
            got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                np.asarray, tpipeline.shard_chip_batch(src, n_chips, chip)))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch,n_chips", [
    ({"x": np.zeros((6, 2)), "y": {"a": np.zeros((8,))}}, 4),
    ({"x": np.zeros((8, 2)), "y": [np.zeros((8,)), np.zeros((3,))]}, 2),
    ({"s": np.float32(1.0)}, 2),
])
def test_check_chip_shardable_raises_as_reference(batch, n_chips):
    with pytest.raises(ValueError) as want:
        jpipeline.check_chip_shardable(batch, n_chips)
    with pytest.raises(ValueError) as got:
        tpipeline.check_chip_shardable(batch, n_chips)
    assert str(got.value) == str(want.value)


def test_shard_batch_names_its_roadmap_item():
    """Named when shard_batch raised for ROADMAP A15; it now places a
    batch on a DeviceMesh, batch dim → ("pod", "data") as the
    reference's: here on a fake (2, 2) world, each leaf a DTensor
    sharded on its leading dim over "data", its full tensor the batch."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.world import close_world, fake_world
    fake_world(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        batch = {"x": torch.arange(8.0).reshape(4, 2),
                 "y": torch.arange(3.0)}
        got = tpipeline.shard_batch(batch, mesh)
        assert tuple(got["x"].placements) == (Shard(0), Replicate())
        assert tuple(got["y"].placements) == (Replicate(), Replicate())
        assert torch.equal(got["x"].to_local(), batch["x"][:2])
    finally:
        close_world()
