"""The port's checkpoints, resume and scheduled recalibration.

* On-disk interop with the JAX package: the same files (manifest and
  ``.npy`` bytes, bf16 as the reference's ``'<V2'`` records) for the same
  tree; a checkpoint the reference's trainer writes (f32 and bf16)
  restores into the port, which then continues bit-exact against its own
  uninterrupted run from that state; a port f32 checkpoint restores into
  the reference.  The reference cannot load bf16 checkpoints, its own
  included (numpy has no cast from ``V2``; ROADMAP queue C), and that is
  asserted here so a fix shows.
* All three restore layouts of the loop (full state, buffers-only,
  params-only) restore the reference's values.
* Resume is bit-exact through drift and recalibration (discrete and
  analog), and the recalibration hook equals its hand computation
  bitwise (the logic of ``tests/test_drift.py::
  test_recal_hook_rewrites_from_shadow``, which is red in the reference
  by one ulp of XLA's fused scan against its eager hand computation).
* A run that ends on a recalibration boundary checkpoints parameters
  that were never recalibrated, so its resumed run skips that rewrite:
  the reference does the same (ROADMAP queue C), and the test pins it.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.hardware import DriftingPlant as JDrifting
from repro.hardware import IdealPlant as JIdeal
from repro.models.simple import mlp_apply as jmlp_apply
from repro.models.simple import mlp_init as jmlp_init
from repro.training import checkpoint as jckpt
from repro.training import train_loop as jloop
import repro_torch as rt
from repro_torch import convert
from repro_torch.core.utils import tree_leaves
from repro_torch.hardware import DriftingPlant, IdealPlant, NoisyPlant
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import train_loop as tloop

XOR_X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], np.float32)
TBATCH = {"x": torch.from_numpy(XOR_X), "y": torch.from_numpy(XOR_Y)}
JBATCH = {"x": XOR_X, "y": XOR_Y}


def _tloss(p, b):
    return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])


def _jloss(p, b):
    return jcore.mse(jmlp_apply(p, b["x"]), b["y"])


def _params_np(seed=0, dtype=np.float32):
    p = jmlp_init(jax.random.PRNGKey(seed), (2, 2, 1))
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(dtype), p)


def _tparams(seed=0, dtype=np.float32):
    return convert.to_torch(_params_np(seed, dtype), device="cpu")


def _loop(**kw):
    return rt.TrainLoopConfig(log=None, **kw)


def _train(params, cfg, steps, plant=None, **kw):
    return rt.train_mgd(_tloss if plant is None else None, params, cfg,
                        lambda i: TBATCH, steps,
                        loop=_loop(plant=plant, **kw), device="cpu")


def _assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert x == y


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


# ---------------------------------------------------------------------------
# The files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
def test_files_byte_equal_to_reference(tmp_path, dtype):
    p_np = _params_np(1, dtype)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jckpt.save(str(jdir), 7, jax.tree_util.tree_map(jnp.asarray, p_np),
               extra={"c0": 1.5})
    ckpt.save(str(tdir), 7, convert.to_torch(p_np, device="cpu"),
              extra={"c0": 1.5})
    jstep, tstep = jdir / "step_000000000007", tdir / "step_000000000007"
    names = sorted(os.listdir(jstep))
    assert names == sorted(os.listdir(tstep))
    for name in names:
        if name.endswith(".npy"):
            assert (jstep / name).read_bytes() == (tstep / name).read_bytes()
    jm = json.loads((jstep / "manifest.json").read_text())
    tm = json.loads((tstep / "manifest.json").read_text())
    jm.pop("treedef")
    tm.pop("treedef")
    assert jm == tm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_save_restore_roundtrip(tmp_path, dtype):
    params = tree_leaves(_tparams(2))
    tree = {"p": [x.to(dtype) for x in params], "n": 5, "flag": True,
            "none": None}
    ckpt.save(str(tmp_path), 3, tree, extra={"k": 1})
    like = {"p": [torch.zeros_like(x) for x in tree["p"]], "n": 0,
            "flag": False, "none": None}
    out, extra, step = ckpt.restore(str(tmp_path), like)
    assert step == 3 and extra == {"k": 1}
    assert out["n"] == 5 and out["flag"] is True and out["none"] is None
    for a, b in zip(tree["p"], out["p"]):
        assert b.dtype == dtype and torch.equal(a, b)


def test_retention_atomicity_and_structure_check(tmp_path):
    params = {"w": torch.ones(3)}
    for s in range(6):
        ckpt.save(str(tmp_path), s, params, keep=3)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    with pytest.raises(AssertionError):
        ckpt.restore(str(tmp_path), {"w": torch.ones(3), "v": torch.ones(2)})
    with pytest.raises(AssertionError):
        ckpt.restore(str(tmp_path), {"w": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), params)
    assert ckpt.latest_step(str(tmp_path / "empty")) is None


# ---------------------------------------------------------------------------
# Interop with the reference's trainer
# ---------------------------------------------------------------------------

CFG = dict(dtheta=1e-2, eta=0.5, mode="central", seed=3)
REPLAY = dict(dtheta=1e-2, eta=0.5, mode="forward", replay=True,
              tau_theta=4, seed=5)


@pytest.mark.parametrize("kw", [CFG, REPLAY], ids=["central", "replay4"])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
def test_reference_checkpoint_resumes_in_port(tmp_path, kw, dtype):
    """The reference trains 6 steps and checkpoints; the port resumes it
    to 12 and lands bitwise where the port's own uninterrupted run from
    the reference's step-6 state lands (the state carried in memory by
    ``convert``)."""
    p0 = jax.tree_util.tree_map(jnp.asarray, _params_np(4, dtype))
    # the batch in the params' dtype: the port's matmul does not promote
    jbatch = {k: v.astype(dtype) for k, v in JBATCH.items()}
    tbatch = convert.to_torch(jbatch, device="cpu")
    ref = jloop.train_mgd(_jloss, p0, jcore.MGDConfig(**kw),
                          lambda i: jbatch, 6, loop=jloop.TrainLoopConfig(
                              chunk=3, log=None,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=6))
    assert jckpt.latest_step(str(tmp_path)) == 6
    tparams = convert.to_torch(
        jax.tree_util.tree_map(np.asarray, ref.params), device="cpu")
    tstate = convert.state_to_torch(
        jax.tree_util.tree_map(np.asarray, ref.state), device="cpu")
    drv = rt.driver("discrete", rt.MGDConfig(**kw), _tloss, device="cpu")
    cont_p, cont_s = tparams, tstate
    for _ in range(6):
        cont_p, cont_s, _ = drv.step(cont_p, cont_s, tbatch)

    res = rt.train_mgd(_tloss, _tparams(4, dtype), rt.MGDConfig(**kw),
                       lambda i: tbatch, 12, loop=_loop(
                           chunk=3, checkpoint_dir=str(tmp_path)),
                       device="cpu")
    assert res.steps_done == 12 and res.state.step == 12
    assert tree_leaves(res.params)[0].dtype == tree_leaves(tparams)[0].dtype
    _assert_equal(res.params, cont_p)
    _assert_equal(res.state, cont_s)


def test_port_checkpoint_resumes_in_reference(tmp_path):
    """A port f32 checkpoint (full state) restores into the reference with
    the port's values, and the reference's trainer resumes from it."""
    kw = REPLAY
    res = _train(_tparams(2), rt.MGDConfig(**kw), 6, chunk=3,
                 checkpoint_dir=str(tmp_path), checkpoint_every=6)
    p0 = jax.tree_util.tree_map(jnp.asarray, _params_np(2))
    like = {"params": p0, "state": jcore.mgd_init(p0, jcore.MGDConfig(**kw))}
    tree, extra, step = jckpt.restore(str(tmp_path), like)
    assert step == 6 and extra["algo"] == "discrete" and extra["seed"] == 5
    assert int(tree["state"].step) == 6
    assert tree["state"].step.dtype == jnp.int32
    for name in ("c0", "replay_c", "metric_cost"):
        np.testing.assert_array_equal(np.asarray(getattr(tree["state"], name)),
                                      getattr(res.state, name).numpy())
    for a, b in zip(jax.tree_util.tree_leaves(tree["params"]),
                    tree_leaves(res.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    out = jloop.train_mgd(_jloss, p0, jcore.MGDConfig(**kw),
                          lambda i: JBATCH, 10, loop=jloop.TrainLoopConfig(
                              chunk=2, log=None,
                              checkpoint_dir=str(tmp_path)))
    assert out.steps_done == 10 and int(out.state.step) == 10


def test_bf16_checkpoints_unreadable_by_reference(tmp_path):
    """The reference cannot load a bf16 leaf (``'<V2'`` has no numpy cast
    to bfloat16), whether the reference or the port wrote it; the port
    reads both."""
    p_np = _params_np(1, ml_dtypes.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jckpt.save(str(tmp_path / "j"), 1, jp)
    ckpt.save(str(tmp_path / "t"), 1, convert.to_torch(p_np, device="cpu"))
    for d in ("j", "t"):
        with pytest.raises(ValueError, match="cast"):
            jckpt.restore(str(tmp_path / d), jp)
        out, _, _ = ckpt.restore(str(tmp_path / d),
                                 _tparams(0, ml_dtypes.bfloat16))
        for a, b in zip(jax.tree_util.tree_leaves(p_np), tree_leaves(out)):
            np.testing.assert_array_equal(_np_bits(a),
                                          _np_bits(convert.to_numpy(b)))


def _write_layout(path, layout, p0, kw):
    """A checkpoint in one of the reference loop's three layouts,
    written by the reference after 8 steps."""
    cfg = jcore.MGDConfig(**kw)
    step = jax.jit(jcore.build_mgd_step(_jloss, cfg))
    p, s = p0, jcore.mgd_init(p0, cfg)
    for _ in range(8):
        p, s, _ = step(p, s, JBATCH)
    extra = {"c0": float(s.c0), "metric_cost": float(s.metric_cost)}
    if layout == "full":
        jckpt.save(path, 8, {"params": p, "state": s})
    elif layout == "buffers":
        jckpt.save(path, 8, {"params": p, "opt": {
            "g": s.g, "replay_c": s.replay_c, "m": s.m}}, extra=extra)
    else:
        jckpt.save(path, 8, p, extra=extra)


@pytest.mark.parametrize("layout", ["full", "buffers", "params"])
def test_restore_layouts_match_reference(tmp_path, layout):
    kw = dict(dtheta=1e-2, eta=0.5, tau_theta=4, momentum=0.9, seed=2)
    p0 = jax.tree_util.tree_map(jnp.asarray, _params_np(3))
    _write_layout(str(tmp_path), layout, p0, kw)
    jlog, tlog = [], []
    jp, js, jstart = jloop._restore_any(
        str(tmp_path), p0, jcore.mgd_init(p0, jcore.MGDConfig(**kw)),
        jlog.append)
    tp0 = _tparams(3)
    tp, ts, tstart = tloop._restore_any(
        str(tmp_path), tp0, rt.mgd_init(tp0, rt.MGDConfig(**kw)),
        tlog.append)
    assert jstart == tstart == 8 and ts.step == 8
    assert len(jlog) == len(tlog)
    want = convert.state_to_torch(jax.tree_util.tree_map(np.asarray, js),
                                  device="cpu")
    _assert_equal(ts, want)
    _assert_equal(tp, convert.to_torch(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))


# ---------------------------------------------------------------------------
# Resume through drift and recalibration (port only, bitwise)
# ---------------------------------------------------------------------------


def _drift_plant(rate=0.01, seed=5, inner=None):
    return DriftingPlant(inner or IdealPlant(_tloss), mode="walk",
                         drift_rate=rate, seed=seed)


@pytest.mark.parametrize("fused", [False, True])
def test_discrete_resume_bit_exact_through_drift(tmp_path, fused):
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=1,
                          fused=fused)
    probe = rt.make_mlp_probe_fn() if fused else None

    def plant():
        inner = NoisyPlant(_tloss, cost_noise=1e-4, write_noise=0.1,
                           dtheta=1e-2, seed=4, probe_fn=probe)
        return _drift_plant(inner=inner)

    cont = _train(_tparams(2), cfg, 16, plant=plant(), chunk=4)
    _train(_tparams(2), cfg, 8, plant=plant(), chunk=4,
           checkpoint_dir=str(tmp_path), checkpoint_every=8)
    res = _train(_tparams(2), cfg, 16, plant=plant(), chunk=4,
                 checkpoint_dir=str(tmp_path))
    assert res.steps_done == 16
    _assert_equal(cont.params, res.params)
    _assert_equal(cont.state, res.state)


def test_analog_resume_bit_exact_through_drift(tmp_path):
    cfg = rt.AnalogMGDConfig(dtheta=1e-2, eta=1e-3, seed=2)
    cont = _train(_tparams(3), cfg, 16, plant=_drift_plant(rate=0.005),
                  chunk=4)
    _train(_tparams(3), cfg, 8, plant=_drift_plant(rate=0.005), chunk=4,
           checkpoint_dir=str(tmp_path), checkpoint_every=8)
    res = _train(_tparams(3), cfg, 16, plant=_drift_plant(rate=0.005),
                 chunk=4, checkpoint_dir=str(tmp_path))
    assert isinstance(res.state, rt.AnalogMGDState) and res.state.t == 16
    _assert_equal(cont.params, res.params)
    _assert_equal(cont.state, res.state)


def test_recal_hook_rewrites_from_shadow():
    """η = 0 + recal: the device after the run is the shadow pushed
    through the plant's write path at the step-4 boundary, then drifted
    by step 4's write: bitwise the hand computation."""
    plant = _drift_plant(rate=0.1, seed=8)
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.0, mode="central", seed=0)
    p0 = _tparams(0)
    res = _train(p0, cfg, 5, plant=plant, chunk=2, recal_every=4)
    expected = plant.write_params(p0, step=4)
    expected = plant.drift(expected, 4)
    _assert_equal(res.params, expected)


def test_recal_hook_matches_reference_stepwise():
    """The same run against the reference's stepwise driver and hand
    recalibration (its jitted scan is not used), at 1e-7."""
    jplant = JDrifting(JIdeal(_jloss), mode="walk", drift_rate=0.1, seed=8)
    drv = repro.driver("discrete", repro.DriverConfig(
        dtheta=1e-2, eta=0.0, mode="central", seed=0), plant=jplant)
    p0 = jax.tree_util.tree_map(jnp.asarray, _params_np(0))
    p, s = p0, drv.init(p0)
    for i in range(5):
        if i == 4:
            p = jplant.write_params(p0, step=jnp.int32(4), prev=p)
        p, s, _ = drv.step(p, s, JBATCH)
    res = _train(_tparams(0), rt.DriverConfig(dtheta=1e-2, eta=0.0,
                                              mode="central", seed=0), 5,
                 plant=_drift_plant(rate=0.1, seed=8), chunk=2,
                 recal_every=4)
    for a, b in zip(jax.tree_util.tree_leaves(p), tree_leaves(res.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7)


def test_recal_pulls_aged_device_back():
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.0, mode="central", seed=0)
    p0 = _tparams(0)

    def dist(params):
        return sum(float(((a - b) ** 2).sum())
                   for a, b in zip(tree_leaves(params), tree_leaves(p0)))

    free = _train(p0, cfg, 40, plant=_drift_plant(rate=0.05, seed=8),
                  chunk=10)
    recal = _train(p0, cfg, 40, plant=_drift_plant(rate=0.05, seed=8),
                   chunk=10, recal_every=5)
    assert dist(recal.params) < dist(free.params)


def test_recal_resume_bit_exact(tmp_path):
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.3, mode="central", seed=3)
    kw = dict(chunk=2, recal_every=4, recal_params=_tparams(9))
    cont = _train(_tparams(1), cfg, 12, plant=_drift_plant(rate=0.02), **kw)
    _train(_tparams(1), cfg, 6, plant=_drift_plant(rate=0.02),
           checkpoint_dir=str(tmp_path), checkpoint_every=6, **kw)
    res = _train(_tparams(1), cfg, 12, plant=_drift_plant(rate=0.02),
                 checkpoint_dir=str(tmp_path), **kw)
    _assert_equal(cont.params, res.params)
    _assert_equal(cont.state, res.state)


def test_resume_at_a_final_recal_boundary_skips_it(tmp_path):
    """A caveat the port shares with the reference (ROADMAP queue C):
    recalibration runs only while steps remain, so a run that ends on a
    boundary (step 8 of 8, ``recal_every`` 4) checkpoints parameters that
    were never recalibrated, and the run resumed from there skips the
    step-8 rewrite.  The port's resumed run is bitwise four plain steps
    from the checkpoint, matches the reference's resumed run (params to
    2e-4), and lies far from the uninterrupted run in both packages."""
    kw = dict(dtheta=1e-2, eta=0.3, mode="central", seed=3)
    loop = dict(chunk=2, recal_every=4, recal_params=_tparams(9))

    def port(steps, **extra):
        return _train(_tparams(1), rt.DriverConfig(**kw), steps,
                      plant=_drift_plant(rate=0.02), **loop, **extra)

    cont = port(12)
    first = port(8, checkpoint_dir=str(tmp_path / "t"), checkpoint_every=8)
    res = port(12, checkpoint_dir=str(tmp_path / "t"))
    assert len(first.checkpoint_s["save"]) == 1
    assert res.checkpoint_s["restore"] > 0 and "save" not in res.checkpoint_s
    drv = rt.driver("discrete", rt.DriverConfig(**kw), None,
                    plant=_drift_plant(rate=0.02), device="cpu")
    p, s = first.params, first.state
    for _ in range(4):
        p, s, _ = drv.step(p, s, TBATCH)
    _assert_equal(res.params, p)
    _assert_equal(res.state, s)

    def ref(steps, **extra):
        p0 = jax.tree_util.tree_map(jnp.asarray, _params_np(1))
        shadow = jax.tree_util.tree_map(jnp.asarray, _params_np(9))
        plant = JDrifting(JIdeal(_jloss), mode="walk", drift_rate=0.02,
                          seed=5)
        return jloop.train_mgd(None, p0, repro.DriverConfig(**kw),
                               lambda i: JBATCH, steps,
                               loop=jloop.TrainLoopConfig(
                                   chunk=2, log=None, plant=plant,
                                   recal_every=4, recal_params=shadow,
                                   **extra))

    jcont = ref(12)
    ref(8, checkpoint_dir=str(tmp_path / "j"), checkpoint_every=8)
    jres = ref(12, checkpoint_dir=str(tmp_path / "j"))
    for (a, b), (c, d) in zip(
            zip(jax.tree_util.tree_leaves(jres.params),
                tree_leaves(res.params)),
            zip(jax.tree_util.tree_leaves(jcont.params),
                tree_leaves(cont.params))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(d.numpy(), np.asarray(c), rtol=0,
                                   atol=2e-4)
    gap = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(res.params), tree_leaves(cont.params)))
    jgap = max(float(jnp.abs(a - b).max()) for a, b in
               zip(jax.tree_util.tree_leaves(jres.params),
                   jax.tree_util.tree_leaves(jcont.params)))
    assert gap > 1e-2 and jgap > 1e-2


def test_recal_chunks_stop_at_boundaries_and_validation():
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.3, mode="central", seed=3)
    res = _train(_tparams(1), cfg, 10, plant=_drift_plant(), chunk=3,
                 recal_every=4)
    assert [s for s, _ in res.history] == [3, 4, 7, 8, 10]
    with pytest.raises(ValueError, match="recal_every"):
        _train(_tparams(), cfg, 4, recal_every=-1)


def test_implicit_device_recal_is_the_shadow():
    """With the implicit device (no plant handed in) the rewrite is the
    shadow itself, as in the reference."""
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.0, mode="central", seed=0,
                          update_noise=0.5)
    shadow = _tparams(7)
    res = _train(_tparams(0), cfg, 4, chunk=4, recal_every=4,
                 recal_params=shadow)
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(res.params), tree_leaves(shadow)))
    res = _train(_tparams(0), cfg, 5, chunk=4, recal_every=4,
                 recal_params=shadow)
    drv = rt.driver("discrete", cfg, _tloss, device="cpu")
    p, s = shadow, drv.init(shadow)
    s = s._replace(step=4)
    p, s, _ = drv.step(p, s, TBATCH)
    _assert_equal(res.params, p)
