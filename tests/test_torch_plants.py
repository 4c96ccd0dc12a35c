"""The port's imperfect devices against the JAX package's.

* ``core.rng`` (threefry2x32 under jax 0.9.0's partitionable layout):
  keys, ``fold_in``, ``split``, bits and uniforms bitwise against
  ``jax.random`` over many (seed, tag, step) triples and odd shapes;
  normals within ``rng.NORMAL_ULPS`` ulps (torch's ``log1p`` and XLA's
  contracted polynomial round apart; measured: 4.7 % of draws differ, by
  at most 3 ulps).
* Each plant function (``write_params``, ``drift``, ``age``,
  ``_quantize_leaf``, ``_adc``) bitwise against the reference on the same
  f32 and bf16 inputs.  Where a function adds gaussian noise, the port is
  handed jax's own draws (``_jax_normals``), so the test holds the
  arithmetic bitwise; the same functions with the port's own draws are
  held to one ulp of the result.  The reference's ``age`` is a jitted
  ``fori_loop`` whose compiler contracts a·(y − rest) + rest into a fused
  multiply-add; it is compared under ``jax.disable_jit()``, the op-by-op
  definition its eager ``drift`` follows.
* Training through each plant: the fused path against the reference from
  the same state every step (C̃ to 1e-6 and params to 2e-4, or one LSB
  where a DAC/ADC grid can flip a rounding), and within the port the
  fused path against the materializing path, bitwise.  Measured over the
  12 steps: noisy and drifting devices C̃ ≤ 6e-8, params ≤ 3.1e-6; the
  8-bit DAC flips a rounding (params one LSB, 0.0157, apart) while C̃
  stays within 1.1e-8.
"""
import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.hardware import devices as jdev
from repro.hardware import plants as jplants
from repro.hardware.base import IdealPlant as JIdeal
from repro.models.simple import mlp_apply as jmlp_apply
from repro.models.simple import mlp_init as jmlp_init
import repro_torch as rt
from repro_torch import convert
from repro_torch.core import mgd as tmgd
from repro_torch.core import noise as tnoise
from repro_torch.core import rng
from repro_torch.core.utils import tree_leaves
from repro_torch.hardware import devices as tdev
from repro_torch.hardware import plants as tplants
from repro_torch.hardware.base import IdealPlant as TIdeal

CT_ATOL = 1e-6
PARAM_ATOL = 2e-4
XOR_X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], np.float32)


def _jkey(key):
    return jnp.array(key, dtype=jnp.uint32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _bits(tree):
    out = []
    for a in jax.tree_util.tree_leaves(tree):
        a = np.asarray(a)
        out.append(a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32))
    return out


def _assert_bitwise(jtree, ttree):
    jl = _bits(jtree)
    tl = _bits(convert.to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@contextlib.contextmanager
def _jax_normals(monkeypatch):
    """The port's gaussian draws replaced by jax's for the same key."""
    def normal_slice(key, start, stop, device=None):
        draws = np.asarray(jax.random.normal(_jkey(key), (stop,),
                                             jnp.float32))[start:]
        return torch.from_numpy(draws.copy()).to(device)

    with monkeypatch.context() as m:
        m.setattr(rng, "normal_slice", normal_slice)
        yield


# ---------------------------------------------------------------------------
# core.rng against jax.random
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 77, 131, 313, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 33 + 5, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(jk)) == rng.prng_key(seed)
    for data in (0, 1, 5, 77, 2 ** 31 + 3, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(jk, data))
        assert tuple(int(v) for v in want) == \
            rng.fold_in(rng.prng_key(seed), data)
    want = np.asarray(jax.random.split(jk, 5))
    assert [tuple(int(v) for v in r) for r in want] == \
        rng.split(rng.prng_key(seed), 5)


TRIPLES = [(s, tag, step) for s in (0, 3, 77, 9001)
           for tag in (0, 1, 7) for step in (0, 1, 12345)]


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (1001,),
                                   (64, 33, 3)])
def test_bits_and_uniform_bitwise(shape):
    for seed, tag, step in TRIPLES:
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), tag), step)
        tk = rng.fold_in(rng.fold_in(rng.prng_key(seed), tag), step)
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
            rng.random_bits(tk, shape, device="cpu").numpy().view(np.uint32))
        for lo, hi in ((0.0, 1.0), (-2.5, 3.0)):
            want = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                                 lo, hi))
            got = rng.uniform(tk, shape, lo, hi, device="cpu").numpy()
            np.testing.assert_array_equal(want.view(np.uint32),
                                          got.view(np.uint32))


def test_bits_chunked_past_chunk_size(monkeypatch):
    """Chunking changes no value (and the counter's carry into the high
    word is only reached past 2³² elements, out of reach of a test)."""
    key = rng.prng_key(5)
    whole = rng.random_bits(key, (5000,), device="cpu")
    monkeypatch.setattr(rng, "CHUNK", 777)
    np.testing.assert_array_equal(whole.numpy(),
                                  rng.random_bits(key, (5000,), device="cpu").numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jax.random.PRNGKey(5), (5000,),
                                   jnp.uint32)),
        whole.numpy().view(np.uint32))


def test_normal_within_stated_ulps():
    total = differ = 0
    for seed, tag, step in TRIPLES:
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), tag), step)
        tk = rng.fold_in(rng.fold_in(rng.prng_key(seed), tag), step)
        want = np.asarray(jax.random.normal(jk, (4097,), jnp.float32))
        got = rng.normal(tk, (4097,), device="cpu").numpy()
        ulps = _ulps(want, got)
        assert ulps.max() <= rng.NORMAL_ULPS
        total += ulps.size
        differ += int((ulps > 0).sum())
    assert differ / total < 0.1


def test_host_scalar_draws():
    """The plants' per-step scalar reads, made on the host: the uniform
    bitwise jax's, the normal within ``rng.NORMAL_ULPS``."""
    for seed, tag, step in TRIPLES:
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), tag), step)
        tk = rng.fold_in(rng.fold_in(rng.prng_key(seed), tag), step)
        for lo, hi in ((0.0, 1.0), (-2.5, 3.0)):
            want = np.asarray(jax.random.uniform(jk, (), jnp.float32, lo, hi))
            got = rng.uniform_scalar(tk, lo, hi)
            assert got.device.type == "cpu" and got.dtype == torch.float32
            assert want.view(np.uint32) == got.numpy().view(np.uint32)
        want = np.asarray(jax.random.normal(jk, (), jnp.float32))
        got = rng.normal_scalar(tk)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        assert _ulps(want, got.numpy()).max() <= rng.NORMAL_ULPS


def test_draws_default_to_the_card():
    """Every public draw and defect sampler runs on the CUDA card unless
    the caller passes ``device="cpu"``; without a card that request is
    required."""
    key = rng.prng_key(1)
    calls = [lambda: rng.random_bits(key, (3,)),
             lambda: rng.uniform(key, (3,)),
             lambda: rng.normal(key, (3,)),
             lambda: rng.bits_slice(key, 0, 3),
             lambda: rng.normal_slice(key, 0, 3),
             lambda: next(rng.normal_chunks(key, 3))[2],
             lambda: tnoise.sample_defects(0, 3, 0.1).alpha,
             lambda: tnoise.ideal_defects(3).alpha]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_normal_statistics_and_erf_inv_edges():
    z = rng.normal(rng.prng_key(11), (1 << 20,), device="cpu")
    assert abs(float(z.mean())) < 5e-3 and abs(float(z.std()) - 1) < 5e-3
    edge = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = rng.erf_inv(edge)
    assert out[0] == -float("inf") and out[1] == float("inf") and out[2] == 0


# ---------------------------------------------------------------------------
# Plant functions against the reference, same inputs
# ---------------------------------------------------------------------------


def _loss(p, b):
    return 0.0


def _params(dtype, seed=0):
    r = np.random.RandomState(seed)
    p = {"w": r.randn(33, 17).astype(np.float32) * 0.7,
         "b": r.randn(17).astype(np.float32),
         "c": [r.randn(5, 3, 2).astype(np.float32) * 3]}
    if dtype == "bf16":
        p = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16), p)
    return p


def _both(p_np):
    return (jax.tree_util.tree_map(jnp.asarray, p_np),
            convert.to_torch(p_np, device="cpu"))


DRIFTS = [dict(mode="walk", drift_rate=1e-3),
          dict(mode="decay", drift_tau=5.0, rest=0.1),
          dict(mode="walk", drift_rate=2e-2, drift_tau=3.0, rest=-0.2)]
DRIFT_IDS = ["walk", "decay", "ou"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_noisy_write_bitwise(dtype, monkeypatch):
    jp, tp = _both(_params(dtype))
    jn = jplants.NoisyPlant(_loss, write_noise=0.1, dtheta=1e-2, seed=3)
    tn = tplants.NoisyPlant(_loss, write_noise=0.1, dtheta=1e-2, seed=3)
    with _jax_normals(monkeypatch):
        for step in (0, 7, 40):
            _assert_bitwise(jn.write_params(jp, step=step),
                            tn.write_params(tp, step=step))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kw", DRIFTS, ids=DRIFT_IDS)
def test_drift_age_and_drifting_write_bitwise(dtype, kw, monkeypatch):
    jp, tp = _both(_params(dtype, 1))

    def plants():
        return (jplants.DriftingPlant(jplants.NoisyPlant(
                    _loss, write_noise=0.1, dtheta=1e-2), seed=5, **kw),
                tplants.DriftingPlant(tplants.NoisyPlant(
                    _loss, write_noise=0.1, dtheta=1e-2), seed=5, **kw))

    jd, td = plants()
    with _jax_normals(monkeypatch):
        _assert_bitwise(jd.drift(jp, 9), td.drift(tp, 9))
        _assert_bitwise(jd.write_params(jp, step=2),
                        td.write_params(tp, step=2))
        with jax.disable_jit():
            want = jd.age(jp, 4, 3)
        _assert_bitwise(want, td.age(tp, 4, 3))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_noisy_functions_with_port_draws_within_one_ulp(dtype):
    """The port's own normals: every element within one ulp of the
    reference's result (f32), bitwise for bf16 leaves here."""
    jp, tp = _both(_params(dtype, 2))
    jn = jplants.NoisyPlant(_loss, write_noise=0.1, dtheta=1e-2, seed=3)
    tn = tplants.NoisyPlant(_loss, write_noise=0.1, dtheta=1e-2, seed=3)
    jd = jplants.DriftingPlant(jn, mode="walk", drift_rate=2e-2, seed=5)
    td = tplants.DriftingPlant(tn, mode="walk", drift_rate=2e-2, seed=5)
    for want, got in ((jn.write_params(jp, step=4), tn.write_params(tp,
                                                                    step=4)),
                      (jd.drift(jp, 4), td.drift(tp, 4))):
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            b = convert.to_numpy(b)
            if dtype == "f32":
                assert _ulps(a, b).max() <= 1
            else:
                np.testing.assert_array_equal(
                    np.asarray(a).view(np.uint16), b.view(np.uint16))


def _half_lsb_values(w_clip, lsb, n):
    k = np.arange(n, dtype=np.float64)
    return (-w_clip + (k + 0.5) * lsb).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits,w_clip", [(8, 2.0), (6, 1.5), (2, 1.5),
                                         (3, 3.5)])
def test_quantize_and_slow_write_bitwise(dtype, bits, w_clip):
    """DAC rounding, including values exactly on half-LSB boundaries
    (bits=2, w_clip=1.5 and bits=3, w_clip=3.5 have an LSB of 1.0, so
    k + 0.5 codes are exact ties: half to even in both)."""
    p_np = _params(dtype, 3)
    jq = jplants.QuantizedPlant(_loss, bits=bits, w_clip=w_clip)
    tq = tplants.QuantizedPlant(_loss, bits=bits, w_clip=w_clip)
    ties = _half_lsb_values(w_clip, tq.lsb, 2 ** bits - 1)
    if dtype == "bf16":
        ties = ties.astype(ml_dtypes.bfloat16)
    p_np["ties"] = np.concatenate([ties, -ties, ties * 1.5])
    jp, tp = _both(p_np)
    _assert_bitwise(jq.quantize(jp), tq.quantize(tp))
    _assert_bitwise(jq.write_params(jp, step=0), tq.write_params(tp, step=0))
    jq = jplants.QuantizedPlant(_loss, bits=bits, w_clip=w_clip,
                                write_tau=3.0)
    tq = tplants.QuantizedPlant(_loss, bits=bits, w_clip=w_clip,
                                write_tau=3.0)
    jprev, tprev = _both(jax.tree_util.tree_map(
        lambda a: (a * 0.5).astype(a.dtype), p_np))
    _assert_bitwise(jq.write_params(jp, step=1, prev=jprev),
                    tq.write_params(tp, step=1, prev=tprev))


@pytest.mark.parametrize("mode", ["round", "stochastic"])
@pytest.mark.parametrize("adc_bits,adc_range", [(5, 1.0), (8, 1.0),
                                                (2, 3.0)])
def test_adc_bitwise(mode, adc_bits, adc_range):
    """ADC codes, including costs on half-LSB boundaries (2 bits over a
    range of 3 has an LSB of 1.0) and costs outside [0, range]."""
    r = np.random.RandomState(adc_bits)
    jq = jplants.QuantizedPlant(_loss, adc_bits=adc_bits, adc_mode=mode,
                                adc_range=adc_range, seed=2)
    tq = tplants.QuantizedPlant(_loss, adc_bits=adc_bits, adc_mode=mode,
                                adc_range=adc_range, seed=2)
    costs = np.concatenate([
        (r.rand(120) * 1.2 * adc_range - 0.1).astype(np.float32),
        _half_lsb_values(0.0, tq.adc_lsb, 2 ** adc_bits - 1)])
    for i, c in enumerate(costs):
        want = np.asarray(jq._adc(jnp.float32(c), i, i % 3))
        got = tq._adc(torch.tensor(c), i, i % 3).numpy()
        assert want.view(np.uint32) == got.view(np.uint32), (i, c)


def test_sample_defects_within_ulps(monkeypatch):
    from repro.core.noise import sample_defects as jsample
    for seed, n, sig in ((0, 4, 0.15), (3, 17, 0.3)):
        want = jsample(seed, n, sig)
        got = tnoise.sample_defects(seed, n, sig, device="cpu")
        for a, b in zip(want, got):
            assert _ulps(a, b.numpy()).max() <= rng.NORMAL_ULPS
        with _jax_normals(monkeypatch):
            got = tnoise.sample_defects(seed, n, sig, device="cpu")
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ideal = tnoise.ideal_defects(3, device="cpu")
    assert torch.equal(ideal.alpha, torch.ones(3))
    assert torch.equal(ideal.b0, torch.zeros(3))


def test_gauss_cost_noise_bitwise():
    for seed, step, tag in ((0, 0, 0), (4, 17, 1), (9, 3, 6)):
        want = np.asarray(jplants._gauss_noise(seed, step, tag))
        got = tplants._gauss_noise(seed, step, tag).numpy()
        assert _ulps(want, got).max() <= rng.NORMAL_ULPS


# ---------------------------------------------------------------------------
# Construction, metadata and validation
# ---------------------------------------------------------------------------


def test_plant_from_config_builds_noisy_plant():
    cfg = rt.MGDConfig(cost_noise=0.1, update_noise=0.2, dtheta=1e-2, seed=4)
    plant = tplants.plant_from_config(_loss, cfg)
    assert isinstance(plant, tplants.NoisyPlant)
    assert (plant.cost_noise, plant.write_noise, plant.dtheta, plant.seed) \
        == (0.1, 0.2, 1e-2, 4)
    assert isinstance(tplants.plant_from_config(_loss, rt.MGDConfig()),
                      TIdeal)
    drv = rt.driver("discrete", rt.DriverConfig(cost_noise=0.1), _loss,
                    device="cpu")
    assert drv.plant is None


@pytest.mark.parametrize("build", [
    lambda P, I: P.QuantizedPlant(_loss, bits=0),
    lambda P, I: P.QuantizedPlant(_loss, adc_bits=0),
    lambda P, I: P.QuantizedPlant(_loss, adc_mode="dither"),
    lambda P, I: P.DriftingPlant(I(_loss), mode="brownian", drift_rate=0.1),
    lambda P, I: P.DriftingPlant(I(_loss), mode="walk"),
    lambda P, I: P.DriftingPlant(I(_loss), mode="decay"),
    lambda P, I: P.DriftingPlant(_loss, mode="walk", drift_rate=0.1),
], ids=["bits", "adc_bits", "adc_mode", "drift_mode", "walk_rate",
        "decay_tau", "inner_type"])
def test_plant_validation_matches_reference(build):
    with pytest.raises((ValueError, TypeError)) as want:
        build(jplants, JIdeal)
    with pytest.raises(type(want.value)) as got:
        build(tplants, TIdeal)
    assert str(got.value).replace("repro_torch.", "repro.") \
        == str(want.value)


def test_meta_and_lsb_match_reference():
    jq = jplants.QuantizedPlant(_loss, bits=8, adc_bits=6)
    tq = tplants.QuantizedPlant(_loss, bits=8, adc_bits=6)
    assert (jq.lsb, jq.adc_lsb) == (tq.lsb, tq.adc_lsb)
    jd = jplants.DriftingPlant(jq, mode="walk", drift_rate=0.01,
                               drift_tau=30.0, rest=0.5)
    td = tplants.DriftingPlant(tq, mode="walk", drift_rate=0.01,
                               drift_tau=30.0, rest=0.5)
    assert td.meta.name == jd.meta.name == "drifting-dac8"
    assert (td.meta.drift_mode, td.meta.drift_rate, td.meta.drift_tau,
            td.meta.drift_rest) == ("walk", 0.01, 30.0, 0.5)
    with pytest.raises(ValueError, match="adc_bits=None"):
        tplants.QuantizedPlant(_loss).adc_lsb


def test_quantize_probes_has_no_fused_path():
    tq = tplants.QuantizedPlant(_loss, quantize_probes=True,
                                probe_fn=rt.make_mlp_probe_fn())
    with pytest.raises(NotImplementedError, match="quantize_probes"):
        tq.apply_perturbed(None, None, None, step=0, tags=(0,))


def test_drifting_plant_forwards_wrapper_probe_fn():
    """A probe_fn attached to the wrapper rides down to the inner device,
    so the inner device's readout noise still applies."""
    inner = tplants.NoisyPlant(_loss, cost_noise=0.5, seed=2)
    plant = tplants.DriftingPlant(inner, mode="walk", drift_rate=0.1)
    plant.probe_fn = lambda p, b, probe: torch.zeros(2)
    out = plant.apply_perturbed(None, None, None, step=3, tags=(0, 1))
    want = 0.5 * torch.stack([tplants._gauss_noise(2, 3, t) for t in (0, 1)])
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert inner.probe_fn is None


# ---------------------------------------------------------------------------
# Training through each plant
# ---------------------------------------------------------------------------

SIZES = (2, 2, 1)


def _mlp_np(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jmlp_init(jax.random.PRNGKey(seed), SIZES))


def _plants(name):
    """(reference plant, port plant, param tolerance, C̃ tolerance) for
    the XOR MLP with σ_a defects drawn from the device seed."""
    if name == "noisy":
        kw = dict(sigma_c=1e-4, sigma_theta=0.05, sigma_a=0.15,
                  dtheta=1e-2, device_seed=3)
        return (jdev.noisy_mlp_plant(SIZES, **kw),
                tdev.noisy_mlp_plant(SIZES, device="cpu", **kw),
                PARAM_ATOL, CT_ATOL)
    if name == "quantized":
        kw = dict(bits=8, adc_bits=8, adc_mode="stochastic", device_seed=1)
        jq = jdev.quantized_mlp_plant(SIZES, **kw)
        tq = tdev.quantized_mlp_plant(SIZES, device="cpu", **kw)
        # a one-ulp cost gap can move a parameter or a readout across
        # a rounding boundary: one DAC LSB, one ADC LSB
        return jq, tq, tq.lsb * 1.0001, tq.adc_lsb * 1.0001
    if name == "drifting":
        jn = jdev.noisy_mlp_plant(SIZES, sigma_c=1e-4, sigma_theta=0.05,
                                  dtheta=1e-2, device_seed=2)
        tn = tdev.noisy_mlp_plant(SIZES, sigma_c=1e-4, sigma_theta=0.05,
                                  dtheta=1e-2, device_seed=2, device="cpu")
        return (jplants.DriftingPlant(jn, mode="walk", drift_rate=1e-3,
                                      drift_tau=20.0, seed=6),
                tplants.DriftingPlant(tn, mode="walk", drift_rate=1e-3,
                                      drift_tau=20.0, seed=6),
                PARAM_ATOL, CT_ATOL)
    raise ValueError(name)


PLANTS = ["noisy", "quantized", "drifting"]


@pytest.mark.parametrize("name", PLANTS)
@pytest.mark.parametrize("mode", ["central", "forward"])
def test_fused_through_plant_tracks_reference(name, mode):
    """Each step starts both packages from the reference's state, so a
    grid flip in one step cannot compound: C̃ and the landed params of
    every step are held to the plant's tolerance."""
    jplant, tplant, p_tol, c_tol = _plants(name)
    kw = dict(mode=mode, dtheta=1e-2, eta=0.5, seed=4, fused=True)
    jstep = jax.jit(jcore.build_mgd_step(
        None, jcore.MGDConfig(kernel_impl="interpret", **kw), plant=jplant))
    tstep = tmgd.build_mgd_step(None, tmgd.MGDConfig(**kw), plant=tplant)
    jparams = jax.tree_util.tree_map(jnp.asarray, _mlp_np())
    jstate = jcore.mgd_init(jparams, jcore.MGDConfig(**kw))
    batch = {"x": XOR_X, "y": XOR_Y}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(12):
        tp = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
        ts = convert.state_to_torch(
            jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
        tp, ts, tm = tstep(tp, ts, tbatch)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        np.testing.assert_allclose(tm["c_tilde"].numpy(),
                                   np.asarray(jm["c_tilde"]),
                                   rtol=0, atol=c_tol)
        for a, b in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=p_tol)
        assert ts.step == int(jstate.step)


@pytest.mark.parametrize("name", PLANTS)
@pytest.mark.parametrize("window", ["tau1", "replay4"])
def test_fused_equals_materializing_through_plant(name, window):
    """Within the port, the fused path (plain kernel versions) and the
    materializing path land bitwise-equal C̃ and params through every
    plant, over 24 central steps."""
    extra = {} if window == "tau1" else dict(replay=True, tau_theta=4)
    kw = dict(mode="central", dtheta=1e-2, eta=0.5, seed=2, **extra)
    batch = {"x": torch.from_numpy(XOR_X), "y": torch.from_numpy(XOR_Y)}
    runs = []
    for fused in (False, True):
        _, tplant, _, _ = _plants(name)
        cfg = tmgd.MGDConfig(fused=fused, **kw)
        step = tmgd.build_mgd_step(None, cfg, plant=tplant)
        params = convert.to_torch(_mlp_np(1), device="cpu")
        state = tmgd.mgd_init(params, cfg)
        cts = []
        for _ in range(24):
            params, state, m = step(params, state, batch)
            cts.append(m["c_tilde"])
        runs.append((torch.stack(cts), tree_leaves(params)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_implicit_noisy_device_tracks_reference():
    """``MGDConfig(cost_noise, update_noise)`` (materializing, forward)
    builds the same implicit device in both packages."""
    kw = dict(dtheta=1e-2, eta=0.5, seed=6, cost_noise=1e-3,
              update_noise=0.1)

    def jloss(p, b):
        return jcore.mse(jmlp_apply(p, b["x"]), b["y"])

    def tloss(p, b):
        return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])

    jstep = jax.jit(jcore.build_mgd_step(jloss, jcore.MGDConfig(**kw)))
    tstep = tmgd.build_mgd_step(tloss, tmgd.MGDConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, _mlp_np(2))
    tp = convert.to_torch(_mlp_np(2), device="cpu")
    js, ts = jcore.mgd_init(jp, jcore.MGDConfig(**kw)), \
        tmgd.mgd_init(tp, tmgd.MGDConfig(**kw))
    batch = {"x": XOR_X, "y": XOR_Y}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(16):
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, tbatch)
        np.testing.assert_allclose(tm["c_tilde"].numpy(),
                                   np.asarray(jm["c_tilde"]), rtol=0,
                                   atol=CT_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)


def test_device_factories_match_reference():
    """``mlp_device_fns``: the defect draws and the loss of one device
    seed agree with the reference's."""
    jl, _, jd = jdev.mlp_device_fns((49, 4, 4), sigma_a=0.15, device_seed=7)
    tl, _, td = tdev.mlp_device_fns((49, 4, 4), sigma_a=0.15, device_seed=7,
                                    device="cpu")
    for jlayer, tlayer in zip(jd, td):
        for a, b in zip(jlayer, tlayer):
            assert _ulps(a, b.numpy()).max() <= rng.NORMAL_ULPS
    p = jax.tree_util.tree_map(np.asarray,
                               jmlp_init(jax.random.PRNGKey(1), (49, 4, 4)))
    r = np.random.RandomState(0)
    x = r.rand(8, 49).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.randint(0, 4, 8)]
    want = float(jl(jax.tree_util.tree_map(jnp.asarray, p),
                    {"x": jnp.asarray(x), "y": jnp.asarray(y)}))
    got = float(tl(convert.to_torch(p, device="cpu"),
                   {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}))
    assert abs(want - got) <= CT_ATOL
    ideal = tdev.noisy_mlp_plant(SIZES, sigma_a=0.1, device="cpu")
    assert isinstance(ideal, TIdeal) and ideal.meta.name == "mlp-ideal"
