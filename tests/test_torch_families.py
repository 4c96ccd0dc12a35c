"""The attention families of the port against the JAX package's: the
dense GQA decoders (mistral-nemo, qwen3, granite's MQA, qwen2's QKV
bias), the stub-frontend VLM (qwen2-vl: ``embeds`` and M-RoPE positions)
and audio (musicgen: codebooks) backbones, MoE (llama4-scout) and MLA
with MoE (deepseek-v3).

Parameters are the reference's (``repro.models.transformer.model_init``
on each smoke config, f32), carried with ``repro_torch.convert``; batches
are made by numpy and fed to both.

* Configs: value for value the reference's.
* Forward, loss and one decode step against the reference's: logits
  within 2e-5, the transformer's class (``test_torch_transformer.py``:
  single forwards differ by ≤ 4e-6 on logits of scale 4; measured here
  ≤ 5.0e-6 for all eight, granite-34b's three layers the most).
* musicgen's codebook prefill + decode against the full forward below
  5e-4 (``tests/test_models.py``'s bound) and the reference's logits
  within 2e-5; its bf16 codebook sum equals the reference's bitwise.
* One central MGD step through ``driver("discrete", ...)``, the twin of
  ``tests/test_config_bank.py`` without the mesh: bit-deterministic, and
  it moves some parameter.
* Three fused central steps at ``launch/train.py``'s Δθ = η = 1e-2: the
  port's fused run equals its unfused run bitwise, C̃ and parameters, for
  every family (for MoE and MLA the fused probe materializes θ ± θ̃ and
  the update runs in the window update's plain version); against the
  reference's run C̃ within 1e-6 at step 0 and 2e-5 over the three steps,
  parameters within 2e-5 (measured ≤ 4.8e-7, ≤ 3.4e-6 and ≤ 6.5e-6 over
  the eight: tighter than the 12-step transformer run's 1e-2 / 2e-2,
  which the cost growth at η/Δθ = 1 forces only later).
* ``fsdp`` and ``seq_parallel`` change no value: they place tensors on a
  mesh, and the port has one card.
* The materializing probe's chunked θ ± θ̃ equals the whole-tree
  ``generate`` + ``tree_add``/``tree_axpy`` bitwise; its signs at element
  indices past 2³¹ and 2³² (and at layer 47 of llama4-scout's expert
  bank, past 2³²) equal the reference's ``rademacher_leaf``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.core import perturbations as jpert
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro.models import transformer as jt
import repro_torch as rt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import mgd as tmgd
from repro_torch.core import perturbations as tpert
from repro_torch.core.utils import tree_add, tree_axpy, tree_leaves
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models import transformer as tt

ARCHS = [a for a in tconfigs.PORTED              # the recurrent families:
        if a not in ("rwkv6-7b", "zamba2-7b")]    # test_torch_recurrent.py
LOGIT_ATOL = 2e-5
SELF_ATOL = 5e-4
CT_PRE_ATOL = 1e-6
CT_RUN_ATOL = 2e-5
PARAM_RUN_ATOL = 2e-5
B, S = 2, 32


def _cfgs(arch, **kw):
    return jsmoke(arch).replace(**kw), rt.get_smoke_config(arch).replace(**kw)


def _ref_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jt.model_init(jcfg, jax.random.PRNGKey(seed)))


def _batch(cfg, b=B, s=S, seed=0):
    """The reference tests' inputs: ``embeds`` (+ M-RoPE ``positions``)
    for the stub frontends, labels [B, S, nq] with codebooks, tokens
    otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.family in ("vlm", "audio"):
        batch = {"embeds": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
        shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
        batch["labels"] = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        if cfg.mrope_sections:
            batch["positions"] = rng.integers(0, s, (b, s, 3)).astype(
                np.int32)
        return batch
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for get, jget in ((rt.get_config, jget_config),
                      (rt.get_smoke_config, jsmoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
            jget(arch))
    assert tconfigs.runnable_cells() == repro.configs.runnable_cells()
    assert tconfigs.LONG_CONTEXT_OK == repro.configs.LONG_CONTEXT_OK


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_decode_match_reference(arch):
    """Twin of ``tests/test_models.py::test_smoke_forward_loss_decode``,
    each output against the reference's."""
    jcfg, tcfg = _cfgs(arch)
    ref = _ref_params(jcfg)
    params = convert.to_torch(ref, device="cpu")
    batch = _batch(jcfg)
    want = np.asarray(jt.model_forward(ref, jcfg, _j(batch)))
    got = tt.model_forward(params, tcfg, _t(batch))
    shape = ((B, S, jcfg.n_codebooks, jcfg.vocab) if jcfg.n_codebooks
             else (B, S, jcfg.vocab))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    loss = tt.model_loss(params, tcfg, _t(batch))
    assert float(loss) > 0
    np.testing.assert_allclose(
        float(loss), float(jt.model_loss(ref, jcfg, _j(batch))), rtol=0,
        atol=LOGIT_ATOL)

    rng = np.random.default_rng(1)
    jcache = jt.init_cache(jcfg, B, 16)
    cache = tt.init_cache(tcfg, B, 16, device="cpu")
    if jcfg.family in ("vlm", "audio"):
        e1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jl, _ = jt.model_decode(ref, jcfg, None, jcache,
                                embeds=jnp.asarray(e1))
        tl, cache2 = tt.model_decode(params, tcfg, None, cache,
                                     embeds=torch.from_numpy(e1))
    else:
        tok = rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)
        jl, _ = jt.model_decode(ref, jcfg, jnp.asarray(tok), jcache)
        tl, cache2 = tt.model_decode(params, tcfg, torch.from_numpy(tok),
                                     cache)
    assert int(cache2["length"]) == 1 and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)


def test_prefill_decode_matches_full_forward_codebooks():
    """Twin of ``tests/test_models.py::test_prefill_decode_matches_full_
    forward`` for musicgen-medium: codebook tokens [B, nq, S]."""
    jcfg, tcfg = _cfgs("musicgen-medium")
    ref = _ref_params(jcfg)
    params = convert.to_torch(ref, device="cpu")
    toks = np.asarray(jax.random.randint(
        jax.random.PRNGKey(3), (B, jcfg.n_codebooks, S), 0, jcfg.vocab))
    full = tt.model_forward(params, tcfg, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(jt.model_forward(ref, jcfg,
                                       {"tokens": jnp.asarray(toks)}))
    np.testing.assert_allclose(full.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    pf, cache = tt.model_prefill(
        params, tcfg, {"tokens": torch.from_numpy(toks[:, :, :16])}, 64)
    errs = [(pf[:, :16] - full[:, :16]).abs().max().item()]
    for t in range(16, S):
        lg, cache = tt.model_decode(params, tcfg,
                                    torch.from_numpy(toks[:, :, t]), cache)
        assert tuple(lg.shape) == (B, jcfg.n_codebooks, jcfg.vocab)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < SELF_ATOL, max(errs)


def test_codebook_sum_rounds_as_the_reference_in_bf16():
    """Four bf16 embedding rows summed: both packages add in f32 and round
    once (``jnp.sum`` upcasts bf16, torch's sum accumulates in f32)."""
    jcfg, tcfg = _cfgs("musicgen-medium", dtype="bfloat16")
    ref = _ref_params(jcfg)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (B, jcfg.n_codebooks, S)).astype(np.int32)
    want = jt._embed_tokens(jax.tree_util.tree_map(jnp.asarray,
                                                   ref["embed"]),
                            jcfg, {"tokens": jnp.asarray(toks)})
    got = tt._embed_tokens(convert.to_torch(ref["embed"], device="cpu"),
                           tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


def test_mrope_sections_match_reference():
    """qwen2-vl's M-RoPE at its sections (16, 24, 24) over head_dim 128
    and at the smoke config's (2, 3, 3) over 16, from 3-D positions up to
    4096, within the transformer's 1e-6 for rotated values of scale ~4
    (torch's and XLA's sin/cos round apart; measured 2.4e-7, one ulp)."""
    rng = np.random.default_rng(4)
    for sections, dh in (((16, 24, 24), 128), ((2, 3, 3), 16)):
        x = rng.standard_normal((2, 12, 3, dh)).astype(np.float32)
        pos3 = rng.integers(0, 4096, (2, 12, 3)).astype(np.int32)
        want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                                 sections)
        got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                                1e6, sections)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def _tiny_batch(cfg):
    """``tests/test_config_bank.py``'s deterministic 2 × 8 batch."""
    b, s = 2, 8
    if cfg.family in ("vlm", "audio"):
        n = b * s * cfg.d_model
        batch = {"embeds": (0.25 * np.sin(np.arange(n, dtype=np.float32))
                            ).reshape(b, s, cfg.d_model)}
        shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
        batch["labels"] = (np.arange(np.prod(shape), dtype=np.int32)
                           % max(2, cfg.vocab // 2)).reshape(shape)
        if cfg.mrope_sections:
            batch["positions"] = (np.arange(b * s * 3, dtype=np.int32)
                                  % max(2, cfg.vocab // 2)).reshape(b, s, 3)
        return batch
    toks = (np.arange(b * s, dtype=np.int32) % max(2, cfg.vocab // 2)
            ).reshape(b, s)
    return {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_central_step_is_deterministic_and_moves(arch):
    """Twin of ``tests/test_config_bank.py``'s MGD step, without the mesh."""
    _, tcfg = _cfgs(arch)
    params = tt.model_init(tcfg, 0, device="cpu")
    batch = _t(_tiny_batch(tcfg))

    def one_step():
        drv = rt.driver("discrete", rt.DriverConfig(
            dtheta=1e-3, eta=1e-2, mode="central", seed=7),
            lambda p, b: tt.model_loss(p, tcfg, b), device="cpu")
        p1, _, aux = drv.step(params, drv.init(params), batch)
        return p1, float(aux["cost"])

    p_a, cost_a = one_step()
    p_b, cost_b = one_step()
    assert np.isfinite(cost_a) and cost_a == cost_b
    moved = 0
    for a, b, p0 in zip(tree_leaves(p_a), tree_leaves(p_b),
                        tree_leaves(params)):
        assert torch.equal(a, b)
        moved += int(not torch.equal(a, p0))
    assert moved > 0, "MGD step left every parameter untouched"


def _port_run(tcfg, mcfg, ref, batches):
    params = convert.to_torch(ref, device="cpu")
    step = tmgd.build_mgd_step(
        lambda p, b: tt.model_loss(p, tcfg, b), mcfg,
        probe_fn=tt.make_transformer_probe_fn(tcfg) if mcfg.fused else None)
    state = tmgd.mgd_init(params, mcfg)
    cts = []
    for b in batches:
        params, state, m = step(params, state, _t(b))
        cts.append(m["c_tilde"].item())
    return np.array(cts, np.float32), [t.numpy() for t in tree_leaves(params)]


def _ref_run(jcfg, mcfg, ref, batches):
    params = jax.tree_util.tree_map(jnp.asarray, ref)
    step = jax.jit(jcore.build_mgd_step(
        lambda p, b: jt.model_loss(p, jcfg, b), mcfg,
        probe_fn=jt.make_transformer_probe_fn(jcfg)))
    state = jcore.mgd_init(params, mcfg)
    cts = []
    for b in batches:
        params, state, m = step(params, state, _j(b))
        cts.append(float(m["c_tilde"]))
    return (np.array(cts, np.float32),
            [np.asarray(a) for a in jax.tree_util.tree_leaves(params)])


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_steps_equal_unfused_and_track_reference(arch):
    """Three fused central steps: bitwise the port's unfused run; against
    the reference's fused run (its kernels in interpret mode for the
    dense GQA decoders, its materializing probe for MoE and MLA) at the
    module docstring's tolerances."""
    jcfg, tcfg = _cfgs(arch)
    ref = _ref_params(jcfg)
    batches = [_batch(jcfg, s=16, seed=10 + i) for i in range(3)]
    base = dict(dtheta=1e-2, eta=1e-2, seed=0, mode="central")
    c_fus, p_fus = _port_run(tcfg, tmgd.MGDConfig(fused=True, **base), ref,
                             batches)
    c_mat, p_mat = _port_run(tcfg, tmgd.MGDConfig(**base), ref, batches)
    np.testing.assert_array_equal(c_fus, c_mat)
    for a, b in zip(p_fus, p_mat):
        np.testing.assert_array_equal(a, b)
    c_j, p_j = _ref_run(jcfg, jcore.MGDConfig(
        fused=True, kernel_impl="interpret", **base), ref, batches)
    np.testing.assert_allclose(c_fus[:1], c_j[:1], rtol=0, atol=CT_PRE_ATOL)
    np.testing.assert_allclose(c_fus, c_j, rtol=0, atol=CT_RUN_ATOL)
    for a, b in zip(p_fus, p_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_RUN_ATOL)
    assert not np.array_equal(p_fus[-1], tree_leaves(ref)[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_and_seq_parallel_change_no_value(arch):
    _, tcfg = _cfgs(arch)
    params = tt.model_init(tcfg, 1, device="cpu")
    batch = _t(_batch(tcfg, s=16))
    base = tt.model_forward(params, tcfg, batch)
    for kw in ({"fsdp": True}, {"seq_parallel": True},
               {"fsdp": True, "seq_parallel": True}):
        cfg = tcfg.replace(**kw)
        assert torch.equal(tt.model_forward(params, cfg, batch), base)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tt.model_init(cfg, 1, device="cpu")),
            tree_leaves(params)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_perturbed_tree_is_bitwise_the_whole_tree(dtype):
    """``perturbed_tree`` in chunks of 100 elements (smaller than every
    matrix leaf) against ``generate`` over the whole tree and
    ``tree_add``/``tree_axpy``, both signs, MoE banks included."""
    _, tcfg = _cfgs("deepseek-v3-671b", dtype=dtype)
    params = tt.model_init(tcfg, 2, device="cpu")
    theta = tpert.generate(params, ptype="rademacher", step=5, seed=3,
                           dtheta=1e-2, tau_p=2)
    for sign, want in ((1.0, tree_add(params, theta)),
                       (-1.0, tree_axpy(-1.0, theta, params))):
        got = tpert.perturbed_tree(params, step=5, seed=3, dtheta=1e-2,
                                   tau_p=2, sign=sign, chunk=100)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_materialized_probe_tracks_reference():
    """C± of the MoE/MLA probe (materialized, chunked) against the
    reference's materializing probe on the same params and tokens."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    ref = _ref_params(jcfg)
    batch = _batch(jcfg, s=16)
    jprobe = jpert.Probe(jnp.int32(3), jnp.uint32(7), jpert.ProbeCtx(
        signs=(1.0, -1.0), dtheta=1e-3))
    want = jt.model_probe_costs(jax.tree_util.tree_map(jnp.asarray, ref),
                                jcfg, _j(batch), jprobe)
    probe = tpert.Probe(3, 7, tpert.ProbeCtx(signs=(1.0, -1.0),
                                             dtheta=1e-3))
    got = tt.model_probe_costs(convert.to_torch(ref, device="cpu"), tcfg,
                               _t(batch), probe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="no fused probe path"):
        tt.model_forward_perturbed(convert.to_torch(ref, device="cpu"),
                                   tcfg, _t(batch), probe)


@pytest.mark.parametrize("start", [2 ** 31 - 6, 2 ** 32 - 6, 2 ** 32 + 5])
def test_signs_past_2_31_and_2_32_equal_the_reference(start):
    """θ̃ of 12 elements from ``start`` in a leaf: the index wraps at 2³²
    as the reference's uint32 iota does, and no int32 flips a sign past
    2³¹ (DeepSeek-V3's one-layer bank has 3.76 G elements)."""
    lid, step, seed = 4, 9, 11
    lseed = tpert.leaf_seed(seed, step, lid)
    got = tpert.theta_range(lseed, start, start + 12, 1e-2, torch.float32)
    want = jpert.rademacher_leaf((12,), jnp.float32, lid, step=step,
                                 seed=seed, dtheta=1e-2,
                                 offset=start % 2 ** 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_signs_at_a_deep_layer_of_the_llama4_bank_equal_the_reference():
    """Layer 47 of llama4-scout's [48, 16, 5120, 8192] gate bank starts at
    element 47·16·5120·8192 ≈ 3.2e10, past 2³²: the port's stream offset
    and its signs there equal the reference's."""
    per_layer = 16 * 5120 * 8192
    off = tlayers._stream_offset(47, per_layer)
    assert off == int(jlayers._stream_offset(47, per_layer))
    got = tpert.leaf_theta(torch.empty((4, 8)), tpert.shifted_leaf_seed(
        tpert.leaf_seed(0, 2, 7), off), 1e-2)
    want = jpert.rademacher_leaf((4, 8), jnp.float32, 7, step=2, seed=0,
                                 dtheta=1e-2, offset=off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lseed = tpert.leaf_seed(0, 2, 7)
    np.testing.assert_array_equal(
        tpert.theta_range(lseed, 47 * per_layer, 47 * per_layer + 32, 1e-2,
                          torch.float32).numpy(),
        np.asarray(want).reshape(-1))
