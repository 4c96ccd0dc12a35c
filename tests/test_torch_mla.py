"""The port's multi-head latent attention against the JAX package's.

Parameters are the reference's (``repro.models.mla.mla_init`` and
``repro.models.transformer.model_init`` on the deepseek-v3 smoke config,
f32), carried with ``repro_torch.convert``; activations are made by numpy
and fed to both.

* ``mla_attention`` (expand form) and ``mla_decode`` (absorbed form)
  against the reference's within 4e-6, with the cache payload (c_kv,
  k_rope): torch's and XLA's f32 matmuls, exp, rsqrt and sin/cos round
  apart in the last ulp, and the q-LoRA, RMSNorm, decompression,
  attention and output projection chain it; measured ≤ 1.2e-6 (≤ 5 ulps)
  on outputs of scale 2-4 over four seeds.
* The twin of ``tests/test_models.py::test_mla_absorbed_decode_parity``:
  absorbed decode from a prefilled cache against the expand-form full
  forward below 5e-4, the bound the reference is held to.
* The MLA cache keeps the reference's layout (keys, shapes, dtypes) and,
  after a prefill, the reference's values within 1e-5 (the second layer's
  latents come from the first layer's output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import mla as jmla
from repro.models import transformer as jt
import repro_torch as rt
from repro_torch import convert
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as tt

ELEM_ATOL = 4e-6
CACHE_ATOL = 1e-5
SELF_ATOL = 5e-4
B, S = 2, 32


def _cfgs(**kw):
    return (jsmoke("deepseek-v3-671b").replace(**kw),
            rt.get_smoke_config("deepseek-v3-671b").replace(**kw))


def _mla_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jmla.mla_init(jax.random.PRNGKey(seed), jcfg,
                                  jnp.float32))


def _x(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _positions(b=B, s=S):
    return np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))


def test_mla_attention_matches_reference():
    jcfg, tcfg = _cfgs()
    jp = _mla_params(jcfg)
    x, pos = _x(jcfg), _positions()
    y_j, (c_j, r_j) = jmla.mla_attention(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
        jnp.asarray(pos), jcfg, q_block=16, kv_block=16)
    y_t, (c_t, r_t) = tmla.mla_attention(
        convert.to_torch(jp, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(pos), tcfg, q_block=16, kv_block=16)
    assert y_t.shape == (B, S, jcfg.d_model)
    assert c_t.shape == (B, S, jcfg.kv_lora_rank)
    assert r_t.shape == (B, S, jcfg.qk_rope_head_dim)
    for got, want in ((y_t, y_j), (c_t, c_j), (r_t, r_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ELEM_ATOL)


def test_mla_decode_and_cache_update_match_reference():
    """The absorbed form against a cache of 20 latents (positions 20..31
    empty, masked), and the cache write at ``length − 1``."""
    jcfg, tcfg = _cfgs()
    jp = _mla_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    c = rng.standard_normal((B, S, jcfg.kv_lora_rank)).astype(np.float32)
    r = rng.standard_normal((B, S, jcfg.qk_rope_head_dim)).astype(np.float32)
    c[:, 20:] = 0.0
    r[:, 20:] = 0.0
    x1 = _x(jcfg, s=1, seed=4)
    length = 21
    jpj = jax.tree_util.tree_map(jnp.asarray, jp)
    jc, jr = jmla.mla_cache_update(jpj, jnp.asarray(x1),
                                   (jnp.asarray(c), jnp.asarray(r)),
                                   length, jcfg)
    want = jmla.mla_decode(jpj, jnp.asarray(x1), (jc, jr), length, jcfg)
    tp = convert.to_torch(jp, device="cpu")
    tc, tr = torch.from_numpy(c.copy()), torch.from_numpy(r.copy())
    out_c, out_r = tmla.mla_cache_update(tp, torch.from_numpy(x1), (tc, tr),
                                         length, tcfg)
    assert out_c is tc and out_r is tr          # written in place
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=ELEM_ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=ELEM_ATOL)
    assert torch.equal(tc[:, :20], torch.from_numpy(c[:, :20]))
    got = tmla.mla_decode(tp, torch.from_numpy(x1), (tc, tr), length, tcfg)
    assert got.shape == (B, 1, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEM_ATOL)
    # masking: a latent past length changes nothing
    tc[:, 25] = 7.0
    assert torch.equal(
        tmla.mla_decode(tp, torch.from_numpy(x1), (tc, tr), length, tcfg),
        got)


def test_mla_absorbed_decode_parity():
    """Twin of ``tests/test_models.py::test_mla_absorbed_decode_parity``:
    absorbed decode ≡ expand-form forward (dense MLP, no MoE)."""
    jcfg, tcfg = _cfgs(n_experts=0, n_experts_active=0, n_shared_experts=0)
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


def test_mla_cache_layout_matches_reference():
    jcfg, tcfg = _cfgs()
    want = jt.init_cache(jcfg, B, 40)
    got = tt.init_cache(tcfg, B, 40, device="cpu")
    assert set(got) == set(want) == {"c_kv", "k_rope", "length"}
    for key in ("c_kv", "k_rope"):
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float32
        assert not got[key].any()
    assert got["length"].dtype == torch.int32 and int(got["length"]) == 0
    assert not got["length"].is_cuda
    # after a prefill: the reference's latents
    jp = jt.model_init(jcfg, jax.random.PRNGKey(1))
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (B, 12)).astype(
        np.int32)
    _, jcache = jt.model_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 40)
    _, tcache = tt.model_prefill(
        convert.to_torch(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu"), tcfg,
        {"tokens": torch.from_numpy(toks)}, 40)
    assert int(tcache["length"]) == int(jcache["length"]) == 12
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=0,
                                   atol=CACHE_ATOL)
