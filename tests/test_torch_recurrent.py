"""The recurrent families of the port against the JAX package's: RWKV-6
(rwkv6-7b, ``ssm``) and the Mamba-2 hybrid (zamba2-7b, ``hybrid``), with
the chunked linear attention both run on.

Inputs are made by numpy from a seed and fed to both packages;
parameters are the reference's (``repro.models.transformer.model_init``
on each smoke config, f32), carried with ``repro_torch.convert``.  The
block- and model-level tests first fill the leaves the reference
initializes to zero or one (``w0``, ``u``, ``ln_x``'s bias, ``a_log``,
``dt_bias``, ``d_skip``, ``conv_b``) with seeded nonzero values in that
shared tree, so the decay, bonus, bias and skip paths are compared, not
bypassed.

Tolerances, stated in each test:

* the chunked functions, the smoke forwards and losses: 1e-5 of max|·|.
  torch's and XLA's CPU cumsum, exp, softplus, silu and f32 matmuls
  round apart (a 32-long cumsum differs on 39 % of values), so nothing
  across frameworks is bitwise; a transcription lands at ≤ 1.4e-6 of
  max|y| at dk 64 (measured).
* single-token steps, groupnorm, the conv: 1e-6 of max|·| (a few ulps:
  no long sums).
* decode logits against the reference's: 2e-5 absolute, the
  transformer's ``LOGIT_ATOL``.
* the reference's own tests, twinned: chunked against the step
  recurrence within 2e-3, prefill + decode against the full forward
  below 5e-4.
* rwkv6 at 32 layers in f32 (ROADMAP C6): the port's decode-vs-forward
  error within ``DECODE_DEPTH_FACTOR`` (4×) of the reference's own, both
  in units of 2⁻¹⁶·max|logit|.
* θ̃ of the materializing probe and the first window update (B3): bitwise
  over both converted trees (28 and 21 leaves, in JAX's flatten order).
* 12 fused central MGD steps against the reference's driver: C̃ within
  1e-2 and parameters within 2e-2 (``tests/test_torch_transformer.py``'s
  run tolerances) over the first 7 (rwkv6) and 9 (zamba2): at Δθ = η =
  1e-2 a half-ulp cost gap grows ~3-10× a step in these models, and the
  reference one ulp from
  itself leaves those tolerances within the 12 as well (the test's
  control); the port's fused run bitwise its unfused materializing run.
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
from repro.core.utils import tree_add as jtree_add
from repro.core.utils import tree_axpy as jtree_axpy
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import linear_attention as jla
from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jt
from repro.serving import serve_batch as jserve_batch
import repro_torch as rt
from repro_torch import convert
from repro_torch.core import mgd as tmgd
from repro_torch.core import perturbations as tpert
from repro_torch.core.utils import tree_leaves
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers
from repro_torch.models import linear_attention as tla
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as tt
from repro_torch.serving import serve_batch

ARCHS = ["rwkv6-7b", "zamba2-7b"]
REL = 1e-5            # chunked functions, smoke forwards: of max|·|
STEP_REL = 1e-6       # single steps, groupnorm, conv: of max|·|
LOGIT_ATOL = 2e-5
SELF_ATOL = 5e-4
RECURRENCE_ATOL = 2e-3
CT_RUN_ATOL = 1e-2
PARAM_RUN_ATOL = 2e-2
TRACKED = {"rwkv6-7b": 7, "zamba2-7b": 9}    # steps those two hold (measured)
DECODE_DEPTH_LAYERS = 32        # rwkv6-7b's full depth
DECODE_DEPTH_FACTOR = 4.0       # port's error against the reference's own
B = 2
# leaves the reference initializes to a constant, and the seeded values
# both packages get instead: (mean, std)
FILLS = {"w0": (-0.5, 0.5), "u": (0.0, 0.5), "a_log": (0.0, 0.5),
         "dt_bias": (0.0, 0.5), "d_skip": (1.0, 0.3), "conv_b": (0.0, 0.1)}


def _cfgs(arch, **kw):
    return jsmoke(arch).replace(**kw), rt.get_smoke_config(arch).replace(**kw)


def _fill(tree, rng, parent=None):
    """The numpy tree with FILLS' leaves (and ln_x's bias) drawn from
    ``rng``, in the leaf's dtype."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, k) if isinstance(v, dict) else
                _fill_leaf(k, v, rng, parent) for k, v in sorted(tree.items())}
    return tree


def _fill_leaf(key, a, rng, parent):
    if parent == "ln_x" and key == "bias":
        mean, std = 0.0, 0.1
    elif key in FILLS:
        mean, std = FILLS[key]
    else:
        return a
    return (mean + std * rng.standard_normal(a.shape)).astype(a.dtype)


def _ref_params(jcfg, seed=0, fill=True):
    p = jax.tree_util.tree_map(
        np.asarray, jt.model_init(jcfg, jax.random.PRNGKey(seed)))
    return _fill(p, np.random.default_rng(100 + seed)) if fill else p


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return convert.to_torch(tree, device="cpu")


# --- configs ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for get, jget in ((rt.get_config, jget_config),
                      (rt.get_smoke_config, jsmoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
            jget(arch))
    assert arch in rt.configs.PORTED
    assert rt.configs.runnable_cells() == repro.configs.runnable_cells()


def test_hybrid_plan_of_zamba2():
    assert tt._hybrid_plan(rt.get_config("zamba2-7b")) == \
        jt._hybrid_plan(jget_config("zamba2-7b")) == (54, 27)
    assert tt._hybrid_plan(rt.get_smoke_config("zamba2-7b")) == (4, 2)


# --- the chunked linear attention -------------------------------------------


def _la_inputs(s, *, scalar, seed=0, b=2, h=2, dk=16, dv=12):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((b, s, h, dk)).astype(f)
    k = rng.standard_normal((b, s, h, dk)).astype(f)
    v = rng.standard_normal((b, s, h, dv)).astype(f)
    if scalar:
        lw = (-np.exp(rng.standard_normal((b, s, h))) * 0.5).astype(f)
    else:
        lw = (-np.exp(rng.standard_normal((b, s, h, dk)))).astype(f)
    u = rng.standard_normal((h, dk)).astype(f)
    s0 = rng.standard_normal((b, h, dk, dv)).astype(f)
    return q, k, v, lw, u, s0


@pytest.mark.parametrize("s", [64, 45])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_vector_decay_matches_reference(chunk, s):
    """With the u-bonus and an initial state, at s = 64 and at a ragged
    s = 45 (right-padded): y and the final state within 1e-5 of max|·|."""
    q, k, v, lw, u, s0 = _la_inputs(s, scalar=False)
    jy, js = jla.chunked_vector_decay(*map(jnp.asarray, (q, k, v, lw, u)),
                                      s0=jnp.asarray(s0), chunk=chunk)
    ty, ts = tla.chunked_vector_decay(*map(torch.from_numpy,
                                           (q, k, v, lw, u)),
                                      s0=torch.from_numpy(s0), chunk=chunk)
    assert tuple(ty.shape) == (2, s, 2, 12) and ts.dtype == torch.float32
    assert _rel(ty, jy) <= REL and _rel(ts, js) <= REL


@pytest.mark.parametrize("s", [64, 45])
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_scalar_decay_matches_reference(chunk, s):
    q, k, v, la, _, s0 = _la_inputs(s, scalar=True, seed=1)
    jy, js = jla.chunked_scalar_decay(*map(jnp.asarray, (q, k, v, la)),
                                      s0=jnp.asarray(s0), chunk=chunk)
    ty, ts = tla.chunked_scalar_decay(*map(torch.from_numpy, (q, k, v, la)),
                                      s0=torch.from_numpy(s0), chunk=chunk)
    assert tuple(ty.shape) == (2, s, 2, 12)
    assert _rel(ty, jy) <= REL and _rel(ts, js) <= REL


def test_chunked_bf16_inputs_return_bf16_and_an_f32_state():
    q, k, v, lw, u, s0 = _la_inputs(32, scalar=False, seed=2)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    y, st = tla.chunked_vector_decay(*bf, torch.from_numpy(lw),
                                     torch.from_numpy(u), chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32


def test_step_functions_match_reference():
    """One token of each recurrence from a nonzero state: y and the new
    state within 1e-6 of max|·|."""
    q, k, v, lw, u, s0 = _la_inputs(1, scalar=False, seed=3)
    jy, js = jla.step_vector_decay(*(jnp.asarray(a[:, 0])
                                     for a in (q, k, v, lw)),
                                   jnp.asarray(u), jnp.asarray(s0))
    ty, ts = tla.step_vector_decay(*(torch.from_numpy(a[:, 0])
                                     for a in (q, k, v, lw)),
                                   torch.from_numpy(u), torch.from_numpy(s0))
    assert _rel(ty, jy) <= STEP_REL and _rel(ts, js) <= STEP_REL
    q, k, v, la, _, s0 = _la_inputs(1, scalar=True, seed=4)
    jy, js = jla.step_scalar_decay(*(jnp.asarray(a[:, 0])
                                     for a in (q, k, v, la)),
                                   jnp.asarray(s0))
    ty, ts = tla.step_scalar_decay(*(torch.from_numpy(a[:, 0])
                                     for a in (q, k, v, la)),
                                   torch.from_numpy(s0))
    assert _rel(ty, jy) <= STEP_REL and _rel(ts, js) <= STEP_REL


# --- twins of the reference's own tests (tests/test_models.py) --------------


def _recurrence(step, q, k, v, lw, u, s0):
    st, ys = s0, []
    for t in range(q.shape[1]):
        args = (q[:, t], k[:, t], v[:, t], lw[:, t])
        y, st = step(*args, u, st) if u is not None else step(*args, st)
        ys.append(y)
    return torch.stack(ys, dim=1), st


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_vector_decay_vs_recurrence(chunk):
    q, k, v, lw, u, _ = map(torch.from_numpy,
                            _la_inputs(64, scalar=False, seed=5, dk=8))
    y, st = tla.chunked_vector_decay(q, k, v, lw, u, chunk=chunk)
    yr, sr = _recurrence(tla.step_vector_decay, q, k, v, lw, u,
                         torch.zeros(2, 2, 8, 12))
    assert (y - yr).abs().max().item() <= RECURRENCE_ATOL
    assert (st - sr).abs().max().item() <= RECURRENCE_ATOL


@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_scalar_decay_vs_recurrence(chunk):
    q, k, v, la, _, _ = map(torch.from_numpy,
                            _la_inputs(64, scalar=True, seed=6, dk=8))
    y, st = tla.chunked_scalar_decay(q, k, v, la, chunk=chunk)
    yr, sr = _recurrence(lambda *a: tla.step_scalar_decay(*a), q, k, v, la,
                         None, torch.zeros(2, 2, 8, 12))
    assert (y - yr).abs().max().item() <= RECURRENCE_ATOL
    assert (st - sr).abs().max().item() <= RECURRENCE_ATOL


def test_strong_decay_no_overflow():
    """Adversarial decay (w → e^-20): masked before exp, the chunked form
    stays finite (q·e^A / k·e^-A would overflow)."""
    ones = torch.ones((1, 64, 1, 4))
    y, st = tla.chunked_vector_decay(ones, ones, ones,
                                     torch.full((1, 64, 1, 4), -20.0), None,
                                     chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


# --- layers and blocks ------------------------------------------------------


def test_groupnorm_heads_matches_reference():
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((2, 5, 64)) + 1.0).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jlayers.groupnorm_heads(_j(p), jnp.asarray(x), 4)
    got = tlayers.groupnorm_heads(_t(p), torch.from_numpy(x), 4)
    assert _rel(got, want) <= STEP_REL
    got16 = tlayers.groupnorm_heads(_t(p), torch.from_numpy(x).bfloat16(), 4)
    assert got16.dtype == torch.bfloat16


def test_causal_conv_matches_reference():
    """The depthwise conv over (nonzero tail ++ x): y and the new tail."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (0.2 * rng.standard_normal((4, 24))).astype(np.float32)
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jy, jtail = jmamba._causal_conv(*map(jnp.asarray, (x, w, b, tail)))
    ty, ttail = tmamba._causal_conv(*map(torch.from_numpy, (x, w, b, tail)))
    assert _rel(ty, jy) <= STEP_REL
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))


def _block_params(arch):
    jcfg, tcfg = _cfgs(arch)
    ref = _ref_params(jcfg)
    one = jax.tree_util.tree_map(lambda a: a[1], ref["layers"])
    return jcfg, tcfg, one


def _rand_state(state, rng):
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in state.items()}


@pytest.mark.parametrize("s", [16, 13])
def test_rwkv6_block_and_step_match_reference(s):
    """One RWKV-6 block (nonzero w0, u, ln_x bias) from a nonzero state:
    the block's output and state within 1e-5 of max|·|, then one decode
    step from that state within 1e-5."""
    jcfg, tcfg, lp = _block_params("rwkv6-7b")
    rng = np.random.default_rng(9)
    st = _rand_state(jax.tree_util.tree_map(
        np.asarray, jrwkv.rwkv6_state_init(jcfg, B)), rng)
    x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
    jx, jst = jrwkv.rwkv6_block(_j(lp), jnp.asarray(x), _j(st), jcfg,
                                chunk=jcfg.la_chunk)
    tx, tst = trwkv.rwkv6_block(_t(lp), torch.from_numpy(x), _t(st), tcfg,
                                chunk=tcfg.la_chunk)
    assert _rel(tx, jx) <= REL
    for key in ("att_x", "ffn_x", "wkv"):
        assert _rel(tst[key], jst[key]) <= REL, key
    x1 = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
    jy, jst2 = jrwkv.rwkv6_block_step(_j(lp), jnp.asarray(x1), jst, jcfg)
    ty, tst2 = trwkv.rwkv6_block_step(_t(lp), torch.from_numpy(x1), tst,
                                      tcfg)
    assert _rel(ty, jy) <= REL
    for key in ("att_x", "ffn_x", "wkv"):
        assert _rel(tst2[key], jst2[key]) <= REL, key


@pytest.mark.parametrize("s", [16, 13])
def test_mamba2_block_and_step_match_reference(s):
    """One Mamba-2 block (nonzero a_log, dt_bias, conv_b, d_skip ≠ 1) from
    a nonzero conv tail and SSD state, then one decode step."""
    jcfg, tcfg, lp = _block_params("zamba2-7b")
    rng = np.random.default_rng(10)
    st = _rand_state(jax.tree_util.tree_map(
        np.asarray, jmamba.mamba2_state_init(jcfg, B)), rng)
    x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
    jx, jst = jmamba.mamba2_block(_j(lp), jnp.asarray(x), _j(st), jcfg,
                                  chunk=jcfg.la_chunk)
    tx, tst = tmamba.mamba2_block(_t(lp), torch.from_numpy(x), _t(st), tcfg,
                                  chunk=tcfg.la_chunk)
    assert _rel(tx, jx) <= REL
    for key in ("conv", "ssd"):
        assert _rel(tst[key], jst[key]) <= REL, key
    x1 = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
    jy, jst2 = jmamba.mamba2_block_step(_j(lp), jnp.asarray(x1), jst, jcfg)
    ty, tst2 = tmamba.mamba2_block_step(_t(lp), torch.from_numpy(x1), tst,
                                        tcfg)
    assert _rel(ty, jy) <= REL
    for key in ("conv", "ssd"):
        assert _rel(tst2[key], jst2[key]) <= REL, key


# --- the smoke models -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_model_init_matches_reference_layout(arch):
    """The port's own init: the reference's leaves (28 and 21), shapes
    and dtypes in JAX's flatten order, in bf16 and f32; seeded."""
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(arch, dtype=dtype)
        want = jax.eval_shape(lambda: jt.model_init(jcfg,
                                                    jax.random.PRNGKey(0)))
        got = tt.model_init(tcfg, 0, device="cpu")
        jl, tl = jax.tree_util.tree_leaves(want), tree_leaves(got)
        assert len(tl) == len(jl) == {"rwkv6-7b": 28, "zamba2-7b": 21}[arch]
        for a, b in zip(tl, jl):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert all(torch.equal(a, b) for a, b in zip(
            tl, tree_leaves(tt.model_init(tcfg, 0, device="cpu"))))


@pytest.mark.parametrize("s", [32, 45])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_cache_match_reference(arch, s):
    """Logits and loss within 1e-5 of max|·| (45 tokens pad rwkv6's and
    zamba2's chunk of 8); the returned state and the empty cache in the
    reference's layout (keys, shapes, dtypes)."""
    jcfg, tcfg = _cfgs(arch)
    ref = _ref_params(jcfg)
    params = _t(ref)
    toks = _tokens(jcfg.vocab, B, s)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want, jst = jt.model_forward(ref, jcfg, _j(batch), return_state=True)
    got, tst = tt.model_forward(params, tcfg, _t(batch), return_state=True)
    assert tuple(got.shape) == (B, s, jcfg.vocab)
    assert _rel(got, want) <= REL
    loss = float(tt.model_loss(params, tcfg, _t(batch)))
    assert abs(loss - float(jt.model_loss(ref, jcfg, _j(batch)))) <= \
        REL * loss
    for a, b in zip(tree_leaves(tst), jax.tree_util.tree_leaves(jst)):
        assert tuple(a.shape) == b.shape and _rel(a, b) <= REL
    jcache = jt.init_cache(jcfg, B, 64)
    cache = tt.init_cache(tcfg, B, 64, device="cpu")
    assert sorted(cache) == sorted(jcache)
    for a, b in zip(tree_leaves(cache), jax.tree_util.tree_leaves(jcache)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference_decode(arch):
    """Prefill 16 tokens, then 16 teacher-forced decode steps in both
    packages: each step's logits within 2e-5 of the reference's."""
    jcfg, tcfg = _cfgs(arch)
    ref = _ref_params(jcfg)
    params = _t(ref)
    toks = _tokens(jcfg.vocab, B, 32, seed=2)
    jl, jcache = jt.model_prefill(ref, jcfg, {"tokens": jnp.asarray(
        toks[:, :16])}, 48)
    tl, cache = tt.model_prefill(params, tcfg, {"tokens": torch.from_numpy(
        toks[:, :16])}, 48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    for t in range(16, 32):
        jl, jcache = jt.model_decode(ref, jcfg, jnp.asarray(toks[:, t]),
                                     jcache)
        tl, cache = tt.model_decode(params, tcfg, torch.from_numpy(
            toks[:, t]), cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
    assert int(cache["length"]) == int(jcache["length"]) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Twin of ``tests/test_models.py::test_prefill_decode_matches_full_
    forward``: teacher-forced decode from a 16-token prefill against the
    full forward below 5e-4, from the reference's init."""
    jcfg, tcfg = _cfgs(arch)
    params = _t(_ref_params(jcfg, fill=False))
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(3), (B, 32), 0, jcfg.vocab)))
    full = tt.model_forward(params, tcfg, {"tokens": toks})
    pf, cache = tt.model_prefill(params, tcfg, {"tokens": toks[:, :16]}, 64)
    errs = [(pf - full[:, :16]).abs().max().item()]
    for t in range(16, 32):
        lg, cache = tt.model_decode(params, tcfg, toks[:, t], cache)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < SELF_ATOL, max(errs)


def _decode_error_in_limits(fwd, prefill, decode, toks):
    """max |teacher-forced decode − full forward| over a 16-token prefill
    and 16 decode steps, in units of 2⁻¹⁶·max|logit| of the forward."""
    full = fwd(toks)
    pf, cache = prefill(toks[:, :16])
    errs = [np.abs(pf - full[:, :16]).max()]
    for t in range(16, 32):
        lg, cache = decode(toks[:, t], cache)
        errs.append(np.abs(lg - full[:, t]).max())
    return float(max(errs) / (2.0 ** -16 * np.abs(full).max()))


def test_rwkv6_full_depth_decode_error_is_the_references():
    """ROADMAP C6: rwkv6 at its 32 layers, f32, from the reference's
    params.  Decode against the full forward misses 2⁻¹⁶·max|logit| in
    both packages (the model amplifies rounding with depth); the port's
    error must stay within DECODE_DEPTH_FACTOR of the reference's own,
    which a port fault in the recurrent decode would exceed."""
    jcfg, tcfg = _cfgs("rwkv6-7b", n_layers=DECODE_DEPTH_LAYERS,
                       dtype="float32")
    ref = _ref_params(jcfg, fill=False)
    params = _t(ref)
    toks = _tokens(jcfg.vocab, B, 32, seed=3)

    def jfwd(t):
        return np.asarray(jt.model_forward(ref, jcfg,
                                           {"tokens": jnp.asarray(t)}))

    def jprefill(t):
        lg, cache = jt.model_prefill(ref, jcfg, {"tokens": jnp.asarray(t)},
                                     48)
        return np.asarray(lg), cache

    def jdecode(tok, cache):
        lg, cache = jt.model_decode(ref, jcfg, jnp.asarray(tok), cache)
        return np.asarray(lg), cache

    def tfwd(t):
        return tt.model_forward(params, tcfg, {
            "tokens": torch.from_numpy(np.ascontiguousarray(t))}).numpy()

    def tprefill(t):
        lg, cache = tt.model_prefill(params, tcfg, {
            "tokens": torch.from_numpy(np.ascontiguousarray(t))}, 48)
        return lg.numpy(), cache

    def tdecode(tok, cache):
        lg, cache = tt.model_decode(params, tcfg, torch.from_numpy(
            np.ascontiguousarray(tok)), cache)
        return lg.numpy(), cache

    want = _decode_error_in_limits(jfwd, jprefill, jdecode, toks)
    got = _decode_error_in_limits(tfwd, tprefill, tdecode, toks)
    print(f"rwkv6 {DECODE_DEPTH_LAYERS} layers, f32, decode vs forward in "
          f"2^-16 max|logit|: reference {want:.3f}, port {got:.3f}")
    assert want > 1.0          # the amplification the port inherits
    assert got <= DECODE_DEPTH_FACTOR * want, (got, want)


def test_serve_batch_ragged():
    """Twin of ``tests/test_data_serving.py::test_serve_batch_ragged`` on
    rwkv6's smoke config, and the same tokens as the reference's."""
    jcfg, tcfg = _cfgs("rwkv6-7b")
    ref = _ref_params(jcfg, fill=False)
    reqs = [np.arange(5, dtype=np.int32) % jcfg.vocab,
            np.arange(9, dtype=np.int32) % jcfg.vocab]
    out = serve_batch(_t(ref), tcfg, [torch.from_numpy(r) for r in reqs], 4)
    assert tuple(out.shape) == (2, 4)
    want = jserve_batch(_j(ref), jcfg, [jnp.asarray(r) for r in reqs], 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# --- the MGD path: materialized θ ± θ̃, the window update --------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_perturbed_tree_bitwise_reference_generate(arch):
    """θ ± θ̃ of the port's chunked ``perturbed_tree`` over the converted
    tree equals the reference's ``generate`` + ``tree_add``/``tree_axpy``
    bitwise, leaf by leaf in JAX's order (so each leaf id, and each sign,
    is the reference's); and the port's ``generate`` is its θ̃ bitwise."""
    jcfg, _ = _cfgs(arch)
    ref = _ref_params(jcfg)
    params = _t(ref)
    theta = jpert.generate(_j(ref), ptype="rademacher", step=3, seed=5,
                           dtheta=1e-2)
    for a, b in zip(tree_leaves(tpert.generate(
            params, ptype="rademacher", step=3, seed=5, dtheta=1e-2)),
            jax.tree_util.tree_leaves(theta)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for sign, want in ((1.0, jtree_add(_j(ref), theta)),
                       (-1.0, jtree_axpy(-1.0, theta, _j(ref)))):
        got = tpert.perturbed_tree(params, step=3, seed=5, dtheta=1e-2,
                                   sign=sign, chunk=100)
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_first_window_update_bitwise_reference(arch):
    """The first update's B3 over every ndim ≥ 2 leaf (rank-3 stacks and
    f32 leaves among them) from the same C̃: the port's window update
    (its plain version here) equals the reference's interpret-mode Pallas
    kernel bitwise."""
    jcfg, _ = _cfgs(arch)
    ref = _ref_params(jcfg)
    c_tilde = np.float32(0.0371)
    s = np.float32(c_tilde * np.float32(1.0 / (1e-2 * 1e-2)))
    n_mats = 0
    for lid, leaf in enumerate(jax.tree_util.tree_leaves(ref)):
        if leaf.ndim < 2:
            continue
        n_mats += 1
        lseed = tpert.leaf_seed(0, 0, lid)
        want = jops.mgd_update_window(
            jnp.asarray(leaf), jnp.asarray(np.array([lseed], np.uint32)),
            jnp.asarray(s.reshape(1)), alpha=-1e-2, dtheta=1e-2,
            impl="interpret")
        got = tops.mgd_update_window_group(
            [_t(leaf)], tops.seeds_tensor([[lseed]], "cpu"),
            torch.from_numpy(s.reshape(1)), alpha=-1e-2, dtheta=1e-2)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert n_mats == {"rwkv6-7b": 27, "zamba2-7b": 18}[arch]


def _lm_batches(vocab, n):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, 17)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _port_run(tcfg, mcfg, ref, batches):
    params = _t(ref)
    step = tmgd.build_mgd_step(
        lambda p, b: tt.model_loss(p, tcfg, b), mcfg,
        probe_fn=tt.make_transformer_probe_fn(tcfg) if mcfg.fused else None)
    state = tmgd.mgd_init(params, mcfg)
    cts = []
    for b in batches:
        params, state, m = step(params, state, _t(b))
        cts.append(m["c_tilde"].item())
    return np.array(cts, np.float32), [t.numpy() for t in tree_leaves(params)]


def _reference_run(jcfg, ref, batches, base):
    drv = repro.driver("discrete", repro.DriverConfig(
        fused=True, kernel_impl="interpret", **base),
        lambda p, b: jt.model_loss(p, jcfg, b),
        probe_fn=jt.make_transformer_probe_fn(jcfg))
    params = _j(ref)
    state = drv.init(params)
    step = jax.jit(drv.step)
    cts = []
    for b in batches:
        params, state, aux = step(params, state, _j(b))
        cts.append(float(aux["c_tilde"]))
    return (np.array(cts, np.float32),
            [np.asarray(a) for a in jax.tree_util.tree_leaves(params)])


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_run_tracks_reference_driver(arch):
    """12 fused central steps at Δθ = η = 1e-2: the port's fused
    (materializing) run equals its unfused run bitwise.  Against the
    reference's ``driver`` (fused, interpret kernels) from the same params
    and batches: C̃ within 1e-2 and parameters within 2e-2 over the first
    TRACKED steps, 7 for rwkv6 and 9 for zamba2.  The C̃ gap starts at half
    a cost ulp (2.4e-7) and grows ~3-10× a step, since η/Δθ = 1 moves
    every parameter by |C̃| a step (measured: rwkv6 1.9e-3 at step 6 and
    2.0e-2 at step 7; zamba2 3.8e-4 at step 8 and 1.0e-2 at step 9).  So
    the twelve steps are not held to those tolerances: the reference
    against itself, every element of its head one ulp up, leaves them too
    within the twelve (measured: C̃ 1.6e-2 at step 8 for rwkv6, 1.5e-2 at
    step 9 for zamba2; its eager run leaves its jitted run by 4.8e-2 and
    1.7e-2 at step 8; ROADMAP C5)."""
    jcfg, tcfg = _cfgs(arch)
    ref = _ref_params(jcfg)
    batches = _lm_batches(jcfg.vocab, 12)
    base = dict(dtheta=1e-2, eta=1e-2, seed=0, mode="central")
    c_fus, p_fus = _port_run(tcfg, tmgd.MGDConfig(fused=True, **base), ref,
                             batches)
    c_mat, p_mat = _port_run(tcfg, tmgd.MGDConfig(**base), ref, batches)
    np.testing.assert_array_equal(c_fus, c_mat)
    for a, b in zip(p_fus, p_mat):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(c_fus).all()
    assert not np.array_equal(p_fus[-1], jax.tree_util.tree_leaves(ref)[-1])
    c_j, _ = _reference_run(jcfg, ref, batches, base)
    n = TRACKED[arch]
    _, p_j = _reference_run(jcfg, ref, batches[:n], base)
    _, p_t = _port_run(tcfg, tmgd.MGDConfig(fused=True, **base), ref,
                       batches[:n])
    np.testing.assert_allclose(c_fus[:n], c_j[:n], rtol=0, atol=CT_RUN_ATOL)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_RUN_ATOL)
    # the control: one ulp in every element of the reference's head
    moved = jax.tree_util.tree_map(np.copy, ref)
    head = moved["embed"]["head"]
    head["w"] = np.nextafter(head["w"], np.float32(np.inf))
    c_ctl, _ = _reference_run(jcfg, moved, batches, base)
    assert np.abs(c_ctl - c_j).max() > CT_RUN_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_refuses_the_fused_forward(arch):
    """ssm and hybrid have no fused probe path: the probe materializes."""
    _, tcfg = _cfgs(arch)
    assert not tt.supports_fused_probe(tcfg)
    params = tt.model_init(tcfg, 0, device="cpu")
    probe = tpert.Probe(0, 0, tpert.ProbeCtx(signs=(1.0, -1.0)))
    with pytest.raises(ValueError, match="no fused probe path"):
        tt.model_forward_perturbed(
            params, tcfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
            probe)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_step_is_deterministic_and_fsdp_changes_nothing(arch):
    """``rt.driver`` + ``make_epoch`` from the port's own init: two runs
    of 2 fused central steps equal bitwise and move the parameters;
    ``fsdp``/``seq_parallel`` change no value (one card, no mesh)."""
    _, tcfg = _cfgs(arch)
    params = tt.model_init(tcfg, 0, device="cpu")
    sample = rt.lm_sampler(B, 16, tcfg.vocab, seed=0, device="cpu")

    def run(cfg):
        drv = rt.driver("discrete", rt.DriverConfig(
            dtheta=1e-2, eta=1e-2, mode="central", fused=True),
            lambda p, b: tt.model_loss(p, cfg, b),
            probe_fn=tt.make_transformer_probe_fn(cfg), device="cpu")
        return rt.make_epoch(drv, 2, sample)(params, drv.init(params))

    p_a, _, aux = run(tcfg)
    assert torch.isfinite(aux["cost"]).all()
    for cfg in (tcfg, tcfg.replace(fsdp=True, seq_parallel=True)):
        p_b, _, _ = run(cfg)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_a),
                                                     tree_leaves(p_b)))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(p_a),
                                                     tree_leaves(params)))


# --- the entry points -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_recurrent_ids(arch, capsys):
    """``launch/serve.py`` generates from the recurrent state (seeded:
    twice the same tokens) and ``launch/train.py`` takes MGD steps, both
    ``--smoke --device cpu``."""
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain

    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len",
            "8", "--max-new", "6"]
    out = lserve.main(argv)
    assert tuple(out.shape) == (4, 6) and out.dtype == torch.int32
    assert torch.equal(out, lserve.main(argv))
    res = ltrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--seq", "16", "--steps", "3",
                       "--chunk", "3"])
    assert res.steps_done == 3
    assert np.isfinite([h[1]["cost"] for h in res.history]).all()
    assert "[train] done" in capsys.readouterr().out


def test_online_service_trims_rwkv6():
    """The online service with its background MGD trimmer over rwkv6's
    smoke config (``launch/serve.py --online-trim``), and the example
    ``serve_lm --arch rwkv6-7b --trim``."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve as lserve

    stats, c0, c1 = lserve.main(
        ["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
         "--online-trim", "--batch", "2", "--prompt-len", "8",
         "--requests", "8", "--trim-steps", "6"])
    assert stats["served"] == 8 and stats["trim_global_step"] >= 6
    assert stats["version"] >= 1 and np.isfinite([c0, c1]).all()
    stats = serve_lm.main(["--arch", "rwkv6-7b", "--trim", "--requests",
                           "10", "--device", "cpu"])
    assert stats["trim_global_step"] >= 1


# one step from the reference's own state (ROADMAP C5): C̃ and cost within
# 1e-6 of the cost, the slice's step-0 gate (tests/test_torch_distributed.py
# SLICE_CT_REL): 8.4-16.8 f32 ulps of the cost
STEP_REL = 1e-6


def _reference_trace(jcfg, ref, batches, base):
    """The reference's ``driver`` run (as ``_reference_run``) step by
    step: each step's θ_n, C̃, cost and θ_{n+1}."""
    drv = repro.driver("discrete", repro.DriverConfig(
        fused=True, kernel_impl="interpret", **base),
        lambda p, b: jt.model_loss(p, jcfg, b),
        probe_fn=jt.make_transformer_probe_fn(jcfg))
    params = _j(ref)
    state = drv.init(params)
    step = jax.jit(drv.step)
    out = []
    for b in batches:
        nxt, state, aux = step(params, state, _j(b))
        out.append(dict(start=jax.tree_util.tree_map(np.asarray, params),
                        ct=float(aux["c_tilde"]), cost=float(aux["cost"]),
                        next=jax.tree_util.tree_map(np.asarray, nxt)))
        params = nxt
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_every_step_from_the_references_state(arch):
    """C5 from the same state: along the reference's 12-step run of
    ``test_fused_run_tracks_reference_driver``, at each step the port's
    fused central step from the reference's θ_n (step counter n, batch n)
    gives C̃ and the cost within 1e-6 of the cost of the reference's step
    n (the gate step 0 of the four-card slice is held to) and θ_{n+1}
    within that times η/Δθ plus 2⁻²¹; both controls (C̃ = 0, step n+1's
    signs) miss at every step that moves.  Measured on this CPU, C̃ in
    ulps of the cost: rwkv6 ≤ 2.5 (step 0: 0), zamba2 ≤ 8.5 (step 10,
    cost 9.29, after the cost has grown from 5.6; step 0: 0.5).  The
    trajectory leaves 1e-2 at step 7 (rwkv6) and 9 (zamba2); from the
    same state no step leaves step 0's gate, so that is the growth of a
    rounding gap under η/Δθ = 1, not a port fault at some state."""
    from test_torch_bench_windows import hold_same_state
    jcfg, tcfg = _cfgs(arch)
    ref = _ref_params(jcfg)
    batches = _lm_batches(jcfg.vocab, 12)
    base = dict(dtheta=1e-2, eta=1e-2, seed=0, mode="central")
    mcfg = tmgd.MGDConfig(fused=True, **base)
    step = tmgd.build_mgd_step(lambda p, b: tt.model_loss(p, tcfg, b), mcfg,
                               probe_fn=tt.make_transformer_probe_fn(tcfg))
    ulps, steps = [], []
    for n, (rec, b) in enumerate(zip(_reference_trace(jcfg, ref, batches,
                                                      base), batches)):
        params, batch = _t(rec["start"]), _t(b)

        def port(shift, params=params, batch=batch, n=n, rec=rec):
            q, _, m = step(params, tmgd.mgd_init(params, mcfg)._replace(
                step=n + shift), batch)
            if not shift:
                assert abs(m["cost"].item() - rec["cost"]) \
                    <= STEP_REL * rec["cost"], n
                ulps.append(abs(m["c_tilde"].item() - rec["ct"])
                            / np.spacing(np.float32(rec["cost"])))
            return m["c_tilde"].item(), q
        steps.append(dict(rec, port=port))
    gain = base["eta"] / base["dtheta"]
    hold_same_state(arch, steps, lambda s: (
        STEP_REL * abs(s["cost"]), gain * STEP_REL * abs(s["cost"])
        + 2.0 ** -21))
    print(f"{arch}: C̃ gaps in ulps of the cost "
          f"{np.round(ulps, 2).tolist()}")
