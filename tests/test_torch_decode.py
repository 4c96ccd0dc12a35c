"""The port's serving path (KV cache, prefill, decode, generation) against
the JAX package's.

Parameters are the reference's (``repro.models.transformer.model_init``
on the qwen3-14b smoke config, f32), carried with ``repro_torch.convert``;
tokens are made by numpy and fed to both.

* ``decode_attention`` against the reference's, f32, within 1e-6.
* Prefill + teacher-forced decode against the port's own full forward
  below 5e-4, the bound ``tests/test_models.py`` holds the reference to.
* Prefill and decode logits against the reference's within the
  transformer's stated 2e-5 (``tests/test_torch_transformer.py``:
  single forwards differ by ≤ 4e-6 on logits of scale 4); the cached
  keys and values (scale ~3, the second layer's made from the first
  layer's output) within 1e-5 (measured ≤ 1.9e-6).
* ``greedy_generate`` emits the reference's tokens at temperature 0 and
  1, where every greedy choice's top-2 margin exceeds that tolerance.
* ``rng.gumbel``/``categorical`` against ``jax.random``: the uniforms
  bitwise, the Gumbel draws within ``rng.GUMBEL_ULPS`` ulps of
  max(|g|, 1) (torch's ``log`` rounds apart from XLA's), the draws equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.serving import decode as jdecode
import repro_torch as rt
from repro_torch import convert
from repro_torch.core import rng
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.serving import decode as tdecode

ATTN_ATOL = 1e-6
CACHE_ATOL = 1e-5    # keys/values of scale ~3, after a layer's rounding
LOGIT_ATOL = 2e-5
SELF_ATOL = 5e-4


def _cfgs(**kw):
    return (jsmoke("qwen3-14b").replace(**kw),
            rt.get_smoke_config("qwen3-14b").replace(**kw))


def _params(jcfg, seed=0):
    ref = jax.tree_util.tree_map(
        np.asarray, jt.model_init(jcfg, jax.random.PRNGKey(seed)))
    return (jax.tree_util.tree_map(jnp.asarray, ref),
            convert.to_torch(ref, device="cpu"))


def _tokens(vocab, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("length", [1, 7, 24])
def test_decode_attention_matches_reference(length):
    r = np.random.default_rng(length)
    q = r.normal(size=(2, 1, 8, 16)).astype(np.float32)
    k = r.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, 24, 2, 16)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.int32(length))
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), length)
    assert got.shape == (2, 1, 8, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_ATOL)
    # the mask: entries at or past `length` change nothing
    k2, v2 = k.copy(), v.copy()
    k2[:, length:] = 7.0
    v2[:, length:] = -3.0
    got2 = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k2),
                                  torch.from_numpy(v2), length)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("kw", [{}, {"tie_embeddings": True},
                                {"qk_norm": False, "qkv_bias": True}],
                         ids=["untied", "tied", "bias_no_qk_norm"])
def test_prefill_decode_tracks_full_forward(kw):
    """Teacher-forced decode from a 16-token prefill equals the full
    forward at every later position (the port against itself)."""
    _, tcfg = _cfgs(**kw)
    params = rt.model_init(tcfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, 24))
    full = tt.model_forward(params, tcfg, {"tokens": toks})
    pf, cache = tt.model_prefill(params, tcfg, {"tokens": toks[:, :16]}, 64)
    errs = [(pf - full[:, :16]).abs().max().item()]
    for t in range(16, 24):
        lg, cache = tt.model_decode(params, tcfg, toks[:, t], cache)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < SELF_ATOL, errs
    assert int(cache["length"]) == 24


def test_prefill_and_decode_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab, 2, 24)
    jpf, jc = jt.model_prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16])},
                               32)
    tpf, tc = tt.model_prefill(tp, tcfg,
                               {"tokens": torch.from_numpy(toks[:, :16])}, 32)
    np.testing.assert_allclose(tpf.numpy(), np.asarray(jpf), rtol=0,
                               atol=LOGIT_ATOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape == (2, 2, 32, 2, 16)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=0, atol=CACHE_ATOL)
    assert int(tc["length"]) == int(jc["length"]) == 16
    for t in range(16, 24):
        jl, jc = jt.model_decode(jp, jcfg, jnp.asarray(toks[:, t]), jc)
        tl, tc = tt.model_decode(tp, tcfg, torch.from_numpy(toks[:, t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        assert int(tc["length"]) == int(jc["length"]) == t + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=0, atol=CACHE_ATOL)


def test_cache_layout_and_in_place_writes():
    _, tcfg = _cfgs()
    cache = tt.init_cache(tcfg, 3, 10, device="cpu")
    assert set(cache) == {"k", "v", "length"}
    assert tuple(cache["k"].shape) == (2, 3, 10, 2, 16)
    assert cache["k"].dtype == torch.float32 and cache["k"] is not cache["v"]
    assert cache["length"].dtype == torch.int32
    assert cache["length"].device.type == "cpu" and int(cache["length"]) == 0
    params = rt.model_init(tcfg, 0, device="cpu")
    k_buf = cache["k"]
    _, c1 = tt.model_decode(params, tcfg, torch.tensor([1, 2, 3]), cache)
    assert c1["k"] is k_buf                   # written in place, no rebuild
    assert bool(k_buf[:, :, 0].abs().sum() > 0)
    assert bool((k_buf[:, :, 1:] == 0).all())
    full = tt.init_cache(tcfg, 1, 2, device="cpu")
    full["length"] = torch.tensor(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="full"):
        tt.model_decode(params, tcfg, torch.tensor([1]), full)
    with pytest.raises(ValueError, match="max_len"):
        tt.model_prefill(params, tcfg,
                         {"tokens": torch.zeros((1, 5), dtype=torch.int32)},
                         4)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_greedy_generate_matches_reference(temperature):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    prompts = _tokens(jcfg.vocab, 3, 12, seed=5)
    want = np.asarray(jdecode.greedy_generate(
        jp, jcfg, jnp.asarray(prompts), 10, temperature=temperature,
        seed=4))
    got = tdecode.greedy_generate(tp, tcfg, torch.from_numpy(prompts), 10,
                                  temperature=temperature, seed=4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    if temperature == 0.0:
        # every greedy choice is decided by more than the tolerance
        seq = np.concatenate([prompts, want[:, :-1]], axis=1)
        logits = np.asarray(jt.model_forward(jp, jcfg,
                                             {"tokens": jnp.asarray(seq)}))
        top2 = np.sort(logits[:, 11:], axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 2 * LOGIT_ATOL


def test_eos_mask_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    prompts = _tokens(jcfg.vocab, 3, 12, seed=5)
    free = np.asarray(jdecode.greedy_generate(jp, jcfg, jnp.asarray(prompts),
                                              10))
    eos = int(free[0, 2])                     # a token one request emits
    want = np.asarray(jdecode.greedy_generate(
        jp, jcfg, jnp.asarray(prompts), 10, eos_id=eos))
    got = tdecode.greedy_generate(tp, tcfg, torch.from_numpy(prompts), 10,
                                  eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 3:] == eos).all()


def test_serve_batch_ragged_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    r = np.random.default_rng(9)
    reqs = [r.integers(0, jcfg.vocab, n).astype(np.int32) for n in (5, 9, 3)]
    want = np.asarray(jdecode.serve_batch(
        jp, jcfg, [jnp.asarray(x) for x in reqs], 6))
    got = tdecode.serve_batch(tp, tcfg, [torch.from_numpy(x) for x in reqs],
                              6)
    np.testing.assert_array_equal(got.numpy(), want)
    # numpy requests pad the same way
    np.testing.assert_array_equal(
        tdecode.serve_batch(tp, tcfg, reqs, 6).numpy(), want)


@pytest.mark.parametrize("seed", [0, 11])
def test_gumbel_and_categorical_match_jax(seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    tk = rng.fold_in(rng.prng_key(seed), 7)
    shape = (4, 3000)
    tiny = float(np.finfo(np.float32).tiny)
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, tiny, 1.0))
    tu = rng.uniform(tk, shape, tiny, 1.0, device="cpu").numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    jg = np.asarray(jax.random.gumbel(jk, shape, jnp.float32))
    tg = rng.gumbel(tk, shape, device="cpu").numpy()
    ulps = np.abs(jg - tg) / np.spacing(np.maximum(np.abs(jg),
                                                   np.float32(1.0)))
    assert ulps.max() <= rng.GUMBEL_ULPS
    logits = np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = rng.categorical(tk, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    want0 = np.asarray(jax.random.categorical(jk, jnp.asarray(logits),
                                              axis=0))
    np.testing.assert_array_equal(
        rng.categorical(tk, torch.from_numpy(logits), axis=0).numpy(), want0)


def test_unported_families_raise_a14():
    """No family raises any more: the recurrent ones (ssm, hybrid) take a
    cache too.  For the dense smoke config and both recurrent ones,
    ``embeds`` prefill and decode run, and equal the token path fed the
    same embedding rows."""
    _, tcfg = _cfgs()
    for cfg in (tcfg, rt.get_smoke_config("rwkv6-7b"),
                rt.get_smoke_config("zamba2-7b")):
        assert int(tt.init_cache(cfg, 1, 8, device="cpu")["length"]) == 0
        params = rt.model_init(cfg, 0, device="cpu")
        toks = torch.tensor([[3, 17, 5, 60, 9]])
        emb = params["embed"]["tok"]["table"][toks.long()]
        pf_t, cache_t = tt.model_prefill(params, cfg,
                                         {"tokens": toks[:, :4]}, 8)
        pf_e, cache_e = tt.model_prefill(params, cfg,
                                         {"embeds": emb[:, :4]}, 8)
        assert torch.equal(pf_e, pf_t) and int(cache_e["length"]) == 4
        lg_t, _ = tt.model_decode(params, cfg, toks[:, 4], cache_t)
        lg_e, cache_e = tt.model_decode(params, cfg, None, cache_e,
                                        embeds=emb[:, 4:5])
        assert torch.equal(lg_e, lg_t) and int(cache_e["length"]) == 5
