"""Algorithm 2, the forward-gradient oracle and the rest of A1 against the
JAX package.

* ``driver("analog", ...)``: the tick-by-tick trajectory from the same
  params, at 1e-6 on the costs and C̃ and 2e-5 on the params.  The
  default sinusoidal probes are ``Δθ·sin(2π·f·t)`` and torch's ``sin``
  rounds apart from XLA's in the last ulp (ROADMAP A1), so this is not
  bitwise; with rademacher probes the gap is the sigmoid/matmul ulps of
  the discrete trainer's tests.
* ``forward_gradient`` against ``jax.jvp``, ``true_gradient`` against
  ``jax.grad``, ``gradient_angle``; ``mae``, ``softmax_xent`` and
  ``orthogonality_check``.
* The configs' resolution and the registry's validation messages.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core import forward_grad as jfg
from repro.core import perturbations as jpert
from repro.hardware import DriftingPlant as JDrifting
from repro.hardware import NoisyPlant as JNoisy
from repro.models.simple import mlp_apply as jmlp_apply
from repro.models.simple import mlp_init as jmlp_init
import repro_torch as rt
from repro_torch import convert
from repro_torch.core import cost as tcost
from repro_torch.core import forward_grad as tfg
from repro_torch.core import perturbations as tpert
from repro_torch.core.utils import tree_leaves
from repro_torch.hardware import DriftingPlant, NoisyPlant

# the modules (``repro.api.driver`` is also the name of the function)
jdriver = importlib.import_module("repro.api.driver")
tdriver = importlib.import_module("repro_torch.api.driver")

XOR_X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], np.float32)


def _tloss(p, b):
    return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])


def _jloss(p, b):
    return jcore.mse(jmlp_apply(p, b["x"]), b["y"])


def _params_np(seed=0, sizes=(2, 2, 1)):
    return jax.tree_util.tree_map(
        np.asarray, jmlp_init(jax.random.PRNGKey(seed), sizes))


def _run(cfg_kw, ticks, plants=(None, None), seed=0):
    jd = repro.driver("analog", repro.DriverConfig(**cfg_kw),
                      None if plants[0] else _jloss, plant=plants[0])
    td = rt.driver("analog", rt.DriverConfig(**cfg_kw),
                   None if plants[1] else _tloss, plant=plants[1],
                   device="cpu")
    jstep = jax.jit(jd.step)
    jp = jax.tree_util.tree_map(jnp.asarray, _params_np(seed))
    tp = convert.to_torch(_params_np(seed), device="cpu")
    js, ts = jd.init(jp), td.init(tp)
    jb = {"x": XOR_X, "y": XOR_Y}
    tb = {k: torch.from_numpy(v) for k, v in jb.items()}
    jm, tm = [], []
    for _ in range(ticks):
        jp, js, a = jstep(jp, js, jb)
        tp, ts, b = td.step(tp, ts, tb)
        jm.append([float(a[k]) for k in ("cost", "c_tilde",
                                         "grad_norm_proxy")])
        tm.append([float(b[k]) for k in ("cost", "c_tilde",
                                         "grad_norm_proxy")])
    return (np.array(jm), jp, js), (np.array(tm), tp, ts)


@pytest.mark.parametrize("cfg_kw", [
    dict(eta=0.05),
    dict(eta=0.05, ptype="rademacher", dtheta=1e-2, tau_theta=4.0,
         tau_hp=20.0),
    dict(eta=0.02, ptype="sinusoidal", tau_p=2, dt=0.5, seed=3),
], ids=["sinusoidal", "rademacher", "tau_p2-dt0.5"])
def test_analog_driver_tracks_reference(cfg_kw):
    (jm, jp, js), (tm, tp, ts) = _run(cfg_kw, 120)
    np.testing.assert_allclose(tm[:, :2], jm[:, :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm[:, 2], jm[:, 2], rtol=1e-5, atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(js.g), tree_leaves(ts.g)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-3)
    assert ts.t == int(js.t) == 120 and ts.primed is True


def test_analog_through_noisy_drifting_plant_tracks_reference():
    jplant = JDrifting(JNoisy(_jloss, cost_noise=1e-4, write_noise=0.05,
                              dtheta=1e-2, seed=2),
                       mode="walk", drift_rate=1e-4, seed=3)
    tplant = DriftingPlant(NoisyPlant(_tloss, cost_noise=1e-4,
                                      write_noise=0.05, dtheta=1e-2, seed=2),
                           mode="walk", drift_rate=1e-4, seed=3)
    (jm, jp, _), (tm, tp, _) = _run(dict(eta=0.05), 60, (jplant, tplant))
    np.testing.assert_allclose(tm[:, :2], jm[:, :2], rtol=0, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-5)


def test_analog_implicit_cost_noise_and_state():
    """``DriverConfig(cost_noise)`` builds the implicit noisy device for
    Algorithm 2 too; the first tick only primes the filter."""
    (jm, _, _), (tm, _, ts) = _run(dict(eta=0.05, cost_noise=1e-3), 30)
    np.testing.assert_allclose(tm[:, :2], jm[:, :2], rtol=0, atol=1e-6)
    assert tm[0, 1] == 0.0
    assert isinstance(ts, rt.AnalogMGDState)
    assert isinstance(ts.t, int) and isinstance(ts.primed, bool)


def test_analog_config_resolution_and_validation():
    acfg = tdriver.as_analog_config(rt.DriverConfig())
    jcfg = jdriver.as_analog_config(repro.DriverConfig())
    assert acfg == rt.AnalogMGDConfig()
    assert [getattr(acfg, f) for f in ("ptype", "dtheta", "eta",
                                       "tau_theta", "tau_hp")] == \
        [getattr(jcfg, f) for f in ("ptype", "dtheta", "eta", "tau_theta",
                                    "tau_hp")]
    probe = {"probe_fn": lambda *a: None}
    cases = [   # (algorithm, config from (DriverConfig, Analog, MGDConfig))
        ("analog", lambda C, A, M: C(probes=2), {}, ValueError),
        ("analog", lambda C, A, M: C(fused=True), {}, ValueError),
        ("analog", lambda C, A, M: C(), probe, ValueError),
        ("discrete", lambda C, A, M: A(), {}, TypeError),
        ("analog", lambda C, A, M: M(), {}, TypeError),
        ("discrete", lambda C, A, M: C(dt=0.5), {}, ValueError),
    ]
    for algorithm, cfg, kw, exc in cases:
        with pytest.raises(exc) as want:
            repro.driver(algorithm, cfg(repro.DriverConfig,
                                        jcore.AnalogMGDConfig,
                                        jcore.MGDConfig), _loss_any, **kw)
        with pytest.raises(exc) as got:
            rt.driver(algorithm, cfg(rt.DriverConfig, rt.AnalogMGDConfig,
                                     rt.MGDConfig), _loss_any,
                      device="cpu", **kw)
        assert str(got.value).replace("repro_torch", "repro") == \
            str(want.value)


def _loss_any(p, b):
    return 0.0


def test_replace_step_and_state_step():
    s = rt.mgd_init(convert.to_torch(_params_np(), device="cpu"),
                    rt.MGDConfig())
    assert rt.state_step(tdriver.replace_step(s, 9)) == 9
    a = rt.driver("analog", None, _tloss, device="cpu").init(
        convert.to_torch(_params_np(), device="cpu"))
    assert rt.state_step(tdriver.replace_step(a, 4)) == 4
    with pytest.raises(TypeError):
        tdriver.replace_step(object(), 1)


def test_train_mgd_picks_analog_for_analog_config():
    res = rt.train_mgd(_tloss, convert.to_torch(_params_np(), device="cpu"),
                       rt.AnalogMGDConfig(eta=0.05), lambda i: {
                           "x": torch.from_numpy(XOR_X),
                           "y": torch.from_numpy(XOR_Y)}, 20,
                       loop=rt.TrainLoopConfig(chunk=10, log=None),
                       device="cpu")
    assert isinstance(res.state, rt.AnalogMGDState) and res.state.t == 20


# ---------------------------------------------------------------------------
# forward_grad, costs, orthogonality
# ---------------------------------------------------------------------------


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return (r.rand(8, 49).astype(np.float32),
            np.eye(4, dtype=np.float32)[r.randint(0, 4, 8)])


@pytest.mark.parametrize("step,seed", [(0, 0), (5, 3), (17, 9)])
def test_forward_and_true_gradient_track_reference(step, seed):
    p_np = _params_np(1, (49, 4, 4))
    x, y = _batch(step)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tp = convert.to_torch(p_np, device="cpu")
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jfw = jfg.forward_gradient(_jloss, jp, jb, step=step, seed=seed)
    tfw = tfg.forward_gradient(_tloss, tp, tb, step=step, seed=seed)
    jtr = jfg.true_gradient(_jloss, jp, jb)
    ttr = tfg.true_gradient(_tloss, tp, tb)
    for want, got in ((jfw, tfw), (jtr, ttr)):
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-7)
    np.testing.assert_allclose(
        float(tfg.gradient_angle(tfw, ttr)),
        float(jfg.gradient_angle(jfw, jtr)), rtol=0, atol=1e-5)
    assert float(tfg.gradient_angle(ttr, ttr)) < 1e-3


def test_mae_and_softmax_xent_track_reference():
    r = np.random.RandomState(0)
    a, b = r.randn(7, 5).astype(np.float32), r.randn(7, 5).astype(np.float32)
    np.testing.assert_allclose(
        float(tcost.mae(torch.from_numpy(a), torch.from_numpy(b))),
        float(jcore.cost.mae(jnp.asarray(a), jnp.asarray(b))), rtol=3e-7)
    logits = r.randn(3, 6, 11).astype(np.float32) * 3
    labels = r.randint(-1, 11, (3, 6)).astype(np.int32)
    for ignore in (-1, 4):
        np.testing.assert_allclose(
            float(tcost.softmax_xent(torch.from_numpy(logits),
                                     torch.from_numpy(labels), ignore)),
            float(jcore.cost.softmax_xent(jnp.asarray(logits),
                                          jnp.asarray(labels), ignore)),
            rtol=1e-6)
    assert set(tcost.COSTS) == set(jcore.cost.COSTS)


@pytest.mark.parametrize("ptype", ["rademacher", "walsh", "sequential",
                                   "sinusoidal"])
def test_orthogonality_check_tracks_reference(ptype):
    want = np.asarray(jpert.orthogonality_check(ptype, 6, 64, seed=2,
                                                dtheta=0.5))
    got = tpert.orthogonality_check(ptype, 6, 64, seed=2, dtheta=0.5,
                                    device="cpu").numpy()
    atol = 1e-6 if ptype == "sinusoidal" else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
