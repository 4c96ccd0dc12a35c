"""The port's dense GQA transformer against the JAX package's.

Parameters are the reference's (``repro.models.transformer.model_init``
on the qwen3-14b smoke config, f32), carried with ``repro_torch.convert``;
token arrays are made by the reference or by numpy and fed to both.

* Inside the port, bitwise: the fused probe (plain kernel versions on the
  CPU) equals ``model_loss`` on the materialized θ ± θ̃, and the fused
  trainer equals the materializing trainer, C̃ and parameters.
* Port against reference, to a stated tolerance: torch's and XLA's CPU
  matmul, einsum, exp, rsqrt, sin/cos round apart in the last ulp (the
  same cause as in ``test_torch_trainer.py``).  Single forwards differ by
  ≤ 4e-6 on logits of scale 4 and ≤ 2.4e-7 on RoPE and attention outputs
  of scale 1-3; the tests allow 2e-5 and 1e-6.
* The 12-step training runs use ``launch/train.py``'s Δθ = 1e-2 and
  η = 1e-2.  With that homodyne gain η/Δθ = 1 every parameter moves by
  |C̃| ≈ 0.1 a step, so a one-ulp cost difference (C̃ within 2.4e-7 at
  step 0) grows two- to threefold a step: measured over 12 steps, C̃ within
  3.6e-3 and parameters within 7.0e-3 at τ_θ = 1, 7.2e-6 and 1.7e-5 in
  replay (τ_θ = 4, three updates).  The tests hold the pre-update C̃ to
  the MLP trainer tests' 1e-6 and the whole run to 1e-2 (C̃) and 2e-2
  (parameters), the looser bound this measured growth forces (ROADMAP C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.core import perturbations as jpert
from repro.data.pipeline import lm_sampler as jlm_sampler
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro.models import transformer as jt
import repro_torch as rt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import mgd as tmgd
from repro_torch.core import perturbations as tpert
from repro_torch.core.utils import tree_add, tree_axpy, tree_leaves
from repro_torch.data import pipeline as tpipeline
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models import transformer as tt

LOGIT_ATOL = 2e-5
ELEM_ATOL = 1e-6
COST_ATOL = 5e-6
CT_PRE_ATOL = 1e-6
CT_RUN_ATOL = 1e-2
PARAM_RUN_ATOL = 2e-2


def _cfgs(**kw):
    return (jsmoke("qwen3-14b").replace(**kw),
            rt.get_smoke_config("qwen3-14b").replace(**kw))


def _ref_params(jcfg, seed=0):
    p = jt.model_init(jcfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# --- config registry ----------------------------------------------------------


def test_qwen3_config_matches_reference():
    ref = dataclasses.asdict(jget_config("qwen3-14b"))
    port = dataclasses.asdict(rt.get_config("qwen3-14b"))
    assert port == ref
    assert dataclasses.asdict(rt.get_smoke_config("qwen3-14b")) == \
        dataclasses.asdict(jsmoke("qwen3-14b"))
    cfg = rt.get_config("qwen3-14b")
    assert (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab) == (5120, 40, 8, 128, 17408, 151936)
    assert cfg.torch_dtype == torch.bfloat16
    assert set(tconfigs.SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                                    "long_500k"}


@pytest.mark.parametrize("arch", [a for a in tconfigs.ARCH_IDS
                                  if a != "qwen3-14b"])
def test_other_archs_raise_naming_a14(arch):
    """Every other id, the recurrent ones (rwkv6-7b, zamba2-7b) included,
    is ported and resolves to the reference's config; none raises."""
    assert arch in tconfigs.PORTED
    assert dataclasses.asdict(rt.get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


def test_unknown_arch_and_other_families_raise():
    """An unknown id raises; the recurrent families (ssm, hybrid) build,
    run and take a cache; fsdp/seq_parallel change no value."""
    with pytest.raises(ValueError):
        rt.get_config("gpt-5")
    for arch in ("rwkv6-7b", "zamba2-7b"):
        cfg = rt.get_smoke_config(arch)
        params = tt.model_init(cfg, 0, device="cpu")
        toks = torch.from_numpy(_tokens(cfg.vocab, 2, 16))
        assert torch.isfinite(tt.model_forward(params, cfg,
                                               {"tokens": toks})).all()
        cache = tt.init_cache(cfg, 2, 8, device="cpu")
        logits, cache = tt.model_decode(params, cfg, toks[:, 0], cache)
        assert tuple(logits.shape) == (2, cfg.vocab)
        assert int(cache["length"]) == 1
    _, tcfg = _cfgs()
    # fsdp/seq_parallel place tensors on a mesh: on one card, no value moves
    params = tt.model_init(tcfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, 16))
    base = tt.model_forward(params, tcfg, {"tokens": toks})
    for kw in ({"fsdp": True}, {"seq_parallel": True}):
        cfg = tcfg.replace(**kw)
        for a, b in zip(tree_leaves(tt.model_init(cfg, 0, device="cpu")),
                        tree_leaves(params)):
            assert torch.equal(a, b)
        assert torch.equal(tt.model_forward(params, cfg, {"tokens": toks}),
                           base)


# --- convert: bf16 carried bitwise ------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_round_trip_bitwise(dtype):
    jcfg, _ = _cfgs(dtype=dtype)
    ref = _ref_params(jcfg)
    back = convert.to_numpy(convert.to_torch(ref, device="cpu"))
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert all(t.dtype == want_dt
               for t in tree_leaves(convert.to_torch(ref, device="cpu")))
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_convert_bf16_values_exact():
    a = (jnp.arange(12, dtype=jnp.float32).reshape(3, 4) * 1.37 - 5
         ).astype(jnp.bfloat16)
    t = convert.to_torch({"a": a}, device="cpu")["a"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(),
                          np.asarray(a.astype(jnp.float32)))


# --- building blocks ---------------------------------------------------------


def test_rope_freqs_bitwise():
    assert np.array_equal(np.asarray(jrope.rope_freqs(128, 1e6)),
                          trope.rope_freqs(128, 1e6).numpy())


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32)[None], (2, 1))
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEM_ATOL)


def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 50, (2, 20, 3)).astype(np.int32)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4,
                             (2, 3, 3))
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                            1e4, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEM_ATOL)
    # text positions (t = h = w) reduce M-RoPE to RoPE
    flat = np.tile(np.arange(20, dtype=np.int32)[None, :, None], (2, 1, 3))
    torch.testing.assert_close(
        trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(flat), 1e4,
                          (2, 3, 3)),
        trope.apply_rope(torch.from_numpy(x), torch.from_numpy(flat[..., 0]),
                         1e4), rtol=0, atol=0)


@pytest.mark.parametrize("s,blk,impl", [
    (32, 16, "masked"), (32, 16, "balanced"), (64, 16, "balanced"),
    (20, 16, "masked"), (20, 16, "balanced")])
def test_attention_matches_reference(s, blk, impl):
    """Both impls, and the end-padding branch (s = 20 with 16-blocks)."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    want = jattn.chunked_causal_attention(
        *map(jnp.asarray, (q, k, v)), q_block=blk, kv_block=blk, impl=impl)
    got = tattn.chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), q_block=blk, kv_block=blk,
        impl=impl)
    assert got.shape == (2, s, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEM_ATOL)
    masked = tattn.chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), q_block=blk, kv_block=blk,
        impl="masked")
    assert torch.equal(got, masked)


def test_rmsnorm_and_glu_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEM_ATOL)
    mlp = {k: {"w": (rng.standard_normal(s) * 0.1).astype(np.float32)}
           for k, s in (("gate", (64, 128)), ("up", (64, 128)),
                        ("down", (128, 64)))}
    want = jlayers.glu_mlp(jax.tree_util.tree_map(jnp.asarray, mlp),
                           jnp.asarray(x))
    got = tlayers.glu_mlp(convert.to_torch(mlp, device="cpu"),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEM_ATOL)


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("impl,s,tied", [
    ("masked", 16, False), ("balanced", 32, False), ("masked", 20, False),
    ("balanced", 20, False), ("masked", 16, True)])
def test_model_forward_matches_reference(impl, s, tied):
    jcfg, tcfg = _cfgs(attn_impl=impl, tie_embeddings=tied)
    ref = _ref_params(jcfg)
    toks = _tokens(jcfg.vocab, 2, s)
    want = jt.model_forward(jax.tree_util.tree_map(jnp.asarray, ref), jcfg,
                            {"tokens": jnp.asarray(toks)})
    got = tt.model_forward(convert.to_torch(ref, device="cpu"), tcfg,
                           {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, s, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def test_model_loss_matches_reference():
    jcfg, tcfg = _cfgs()
    ref = _ref_params(jcfg)
    toks = _tokens(jcfg.vocab, 2, 17)
    labels = toks.copy()
    labels[0, :3] = -1          # masked positions
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    want = jt.model_loss(jax.tree_util.tree_map(jnp.asarray, ref), jcfg, jb)
    got = tt.model_loss(convert.to_torch(ref, device="cpu"), tcfg, tb)
    assert abs(got.item() - float(want)) <= COST_ATOL


def test_model_init_stacks_layers_and_is_seeded():
    _, tcfg = _cfgs()
    a = tt.model_init(tcfg, 3, device="cpu")
    b = tt.model_init(tcfg, 3, device="cpu")
    c = tt.model_init(tcfg, 4, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in
              zip(range(14), tree_leaves(a))}
    assert len(shapes) == 14
    assert tuple(a["layers"]["mlp"]["gate"]["w"].shape) == (2, 64, 128)
    assert tuple(a["layers"]["attn"]["wk"]["w"].shape) == (2, 64, 32)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"]["tok"]["table"],
                           c["embed"]["tok"]["table"])
    w = a["layers"]["attn"]["wq"]["w"]
    assert not torch.equal(w[0], w[1])
    assert torch.equal(a["layers"]["ln1"]["scale"], torch.ones(2, 64))


# --- fused probe path ----------------------------------------------------------


def _probe(signs, impl="ref", step=3, seed=7, dtheta=1e-3):
    return tpert.Probe(step, seed, tpert.ProbeCtx(signs=signs, dtheta=dtheta,
                                                  impl=impl))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("signs", [(1.0, -1.0), (1.0,)],
                         ids=["central", "forward"])
def test_transformer_fused_probe_bit_identical(signs, tied):
    """The port's fused probe (plain kernel versions) equals the port's
    ``model_loss`` on the materialized params ± θ̃, bit for bit (f32); the
    tied head reads the whole perturbed table."""
    jcfg, tcfg = _cfgs(tie_embeddings=tied)
    params = convert.to_torch(_ref_params(jcfg), device="cpu")
    toks = torch.from_numpy(_tokens(jcfg.vocab, 2, 16))
    batch = {"tokens": toks, "labels": toks}
    theta = tpert.generate(params, ptype="rademacher", step=3, seed=7,
                           dtheta=1e-3)
    want = [tt.model_loss(tree_add(params, theta) if s == 1.0 else
                          tree_axpy(s, theta, params), tcfg, batch)
            for s in signs]
    costs = tt.make_transformer_probe_fn(tcfg)(params, batch, _probe(signs))
    assert costs.shape == (len(signs),)
    for c, w in zip(costs, want):
        assert torch.equal(c, w)


def test_probe_costs_track_reference():
    """C± of the port's fused probe against the reference's fused probe
    (Pallas kernels in interpret mode) on the same params and tokens."""
    jcfg, tcfg = _cfgs()
    ref = _ref_params(jcfg)
    toks = _tokens(jcfg.vocab, 2, 16)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    jprobe = jpert.Probe(jnp.int32(3), jnp.uint32(7), jpert.ProbeCtx(
        signs=(1.0, -1.0), dtheta=1e-3, impl="interpret"))
    want = jt.model_probe_costs(jax.tree_util.tree_map(jnp.asarray, ref),
                                jcfg, jb, jprobe)
    got = tt.model_probe_costs(convert.to_torch(ref, device="cpu"), tcfg, tb,
                               _probe((1.0, -1.0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=COST_ATOL)


@pytest.mark.parametrize("signs", [(1.0, -1.0), (1.0,)],
                         ids=["central", "forward"])
def test_gathered_row_theta_bitwise_vs_reference(signs):
    """``take(table ± θ̃, tokens)`` with θ̃ for the gathered rows only
    equals the reference's ``pleaf`` over the whole table + ``take``."""
    rng = np.random.default_rng(5)
    table = (rng.standard_normal((300, 48)) * 0.02).astype(np.float32)
    toks = rng.integers(0, 300, (3, 11)).astype(np.int32)
    lid, step, seed = 2, 5, 9
    jprobe = jpert.Probe(jnp.int32(step), jnp.uint32(seed),
                         jpert.ProbeCtx(signs=signs, dtheta=1e-2))
    tables = jlayers.pleaf(jnp.asarray(table), lid, jprobe)
    want = [np.asarray(jnp.take(t, jnp.asarray(toks), axis=0))
            for t in tables]
    got = tlayers.pembed({"table": torch.from_numpy(table)},
                         torch.from_numpy(toks), {"table": lid},
                         _probe(signs, step=step, seed=seed, dtheta=1e-2))
    assert len(got) == len(signs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_gathered_row_theta_index_wraps_past_2_32():
    """A table of 2²³ rows × 1024 (8.6e9 elements, a stride-0 view) puts
    row indices past 2³²; the signs follow the reference hash on the
    uint32-wrapped index t·d + c."""
    d = 1024
    table = torch.zeros((1, d)).expand(2 ** 23, d)
    toks = torch.tensor([[0, 4194303, 4194304, 4194305, 8388607]])
    probe = _probe((1.0,), step=1, seed=2, dtheta=1.0)
    got = tlayers.pembed({"table": table}, toks, {"table": 0}, probe)[0]
    idx = ((toks.numpy().astype(np.uint64)[..., None] * d
            + np.arange(d, dtype=np.uint64)) % 2 ** 32).astype(np.uint32)
    lseed = jpert.leaf_seed(jnp.uint32(2), jnp.uint32(1), 0)
    want = np.asarray(jpert.rademacher_signs(lseed, jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    # row 2²² is row 0 again under the 32-bit index
    assert torch.equal(got[0, 2], got[0, 0])


# --- training ------------------------------------------------------------------

RUNS = [dict(mode="central"), dict(mode="forward"),
        dict(mode="central", replay=True, tau_theta=4)]
RUN_IDS = ["central", "forward", "replay4"]


def _batches(vocab, n=12):
    sample = jlm_sampler(2, 16, vocab, seed=0)
    return [jax.tree_util.tree_map(np.asarray, sample(i)) for i in range(n)]


def _run_port(tcfg, mcfg, params_np, batches):
    params = convert.to_torch(params_np, device="cpu")
    step = tmgd.build_mgd_step(
        lambda p, b: tt.model_loss(p, tcfg, b), mcfg,
        probe_fn=tt.make_transformer_probe_fn(tcfg) if mcfg.fused else None)
    state = tmgd.mgd_init(params, mcfg)
    cts = []
    for b in batches:
        params, state, m = step(params, state,
                                convert.to_torch(b, device="cpu"))
        cts.append(m["c_tilde"].item())
    return np.array(cts, np.float32), [t.numpy() for t in tree_leaves(params)]


def _run_jax(jcfg, mcfg, params_np, batches):
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    step = jax.jit(jcore.build_mgd_step(
        lambda p, b: jt.model_loss(p, jcfg, b), mcfg,
        probe_fn=jt.make_transformer_probe_fn(jcfg)))
    state = jcore.mgd_init(params, mcfg)
    cts = []
    for b in batches:
        params, state, m = step(params, state,
                                jax.tree_util.tree_map(jnp.asarray, b))
        cts.append(float(m["c_tilde"]))
    return (np.array(cts, np.float32),
            [np.asarray(a) for a in jax.tree_util.tree_leaves(params)])


@pytest.mark.parametrize("case", RUNS, ids=RUN_IDS)
def test_driver_run_tracks_reference(case):
    """12 fused steps at launch/train.py's Δθ = η = 1e-2: the port's fused
    and materializing runs are bitwise equal; the port tracks the
    reference (interpret kernels) at the module docstring's tolerances."""
    jcfg, tcfg = _cfgs()
    ref = _ref_params(jcfg)
    batches = _batches(jcfg.vocab)
    base = dict(dtheta=1e-2, eta=1e-2, seed=0, **case)
    c_fus, p_fus = _run_port(tcfg, tmgd.MGDConfig(fused=True, **base), ref,
                             batches)
    c_mat, p_mat = _run_port(tcfg, tmgd.MGDConfig(**base), ref, batches)
    np.testing.assert_array_equal(c_fus, c_mat)
    for a, b in zip(p_fus, p_mat):
        np.testing.assert_array_equal(a, b)
    c_j, p_j = _run_jax(jcfg, jcore.MGDConfig(
        fused=True, kernel_impl="interpret", **base), ref, batches)
    pre = case.get("tau_theta", 1)          # C̃ before any update lands
    np.testing.assert_allclose(c_fus[:pre], c_j[:pre], rtol=0,
                               atol=CT_PRE_ATOL)
    np.testing.assert_allclose(c_fus, c_j, rtol=0, atol=CT_RUN_ATOL)
    for a, b in zip(p_fus, p_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_RUN_ATOL)
    assert np.isfinite(c_fus).all()


def test_driver_entry_point_trains_on_cpu():
    """The public call of the slice, ``rt.driver`` + ``make_epoch`` fed by
    ``lm_sampler``, on the CPU."""
    _, tcfg = _cfgs()
    params = tt.model_init(tcfg, 0, device="cpu")
    drv = rt.driver("discrete", rt.DriverConfig(
        mode="central", fused=True, dtheta=1e-2, eta=1e-2),
        lambda p, b: tt.model_loss(p, tcfg, b),
        probe_fn=tt.make_transformer_probe_fn(tcfg), device="cpu")
    sample = tpipeline.lm_sampler(2, 16, tcfg.vocab, seed=0, device="cpu")
    params, state, aux = rt.make_epoch(drv, 3, sample)(params,
                                                       drv.init(params))
    assert state.step == 3 and aux["c_tilde"].shape == (3,)
    assert torch.isfinite(aux["cost"]).all()


# --- LM data -------------------------------------------------------------------


def test_lm_batch_law():
    """The reference's Zipf-Markov law: next-token labels, tokens in
    range, chain continuations t → (31·t + 7) mod V at ≈ 75 %, a Zipfian
    head, and a pure function of (seed, index)."""
    vocab = 1000
    sample = tpipeline.lm_sampler(64, 128, vocab, seed=3, device="cpu")
    b = sample(5)
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (64, 128)
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    chained = (labels == (toks * 31 + 7) % vocab).float().mean().item()
    assert 0.7 < chained < 0.8
    assert torch.equal(sample(5)["tokens"], toks)
    assert not torch.equal(sample(6)["tokens"], toks)
    # Zipf: token 0 (rank 1) is the most frequent reset value
    jb = jlm_sampler(64, 128, vocab, seed=3)(5)
    for t in (toks, torch.from_numpy(np.array(jb["tokens"]))):
        counts = torch.bincount(t.flatten().long(), minlength=vocab)
        assert int(counts.argmax()) == 0


def test_embed_matches_reference_gather():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))
    got = tlayers.embed({"table": torch.from_numpy(table)},
                        torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stacked_layer_slices_follow_host_generator():
    """A layer slice of a stacked leaf is perturbed with the signs the
    host generator gives that slice of the whole leaf: norm scales through
    ``pleaf``'s offset, weights through ``pdense``'s shifted kernel seed
    (identity input, so y = W_l + θ̃_l)."""
    jcfg, _ = _cfgs()
    params = convert.to_torch(_ref_params(jcfg), device="cpu")
    theta = tpert.generate(params, ptype="rademacher", step=3, seed=7,
                           dtheta=1e-3)
    probe = _probe((1.0,))
    ids = rt.core.utils.leaf_id_tree(params)["layers"]
    scale = params["layers"]["ln1"]["scale"]
    got = tlayers.pleaf(scale[1], ids["ln1"]["scale"], probe, layer=1)[0]
    assert torch.equal(got, scale[1] + theta["layers"]["ln1"]["scale"][1])
    w = params["layers"]["mlp"]["gate"]["w"]
    eye = (torch.eye(w.shape[1]),)
    got = tlayers.pdense({"w": w[1]}, eye, ids["mlp"]["gate"], probe,
                         layer=1)[0]
    assert torch.equal(got, w[1] + theta["layers"]["mlp"]["gate"]["w"][1])
