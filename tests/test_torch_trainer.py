"""The port's MGD trainer.

* Fused path against the port's own materializing path: bitwise C̃ and
  parameters over the grid of ``tests/test_fused_probe.py::
  test_fused_bit_identical_mlp`` (forward/central × τ_θ = 1 / replay
  τ_θ = 4 × η ∈ {0.5, 1}, 36 steps, XOR 2-2-1), with the same params.
* Port against the JAX package (Pallas kernels in interpret mode), params
  carried by ``repro_torch.convert``, on that grid and on NIST7x7 49-4-4.
  Not bitwise: torch's CPU ``sigmoid`` and ``matmul`` round differently
  from XLA's in the last ulp (382 of 100k sigmoid values; an [8,49]@[49,4]
  product), and XLA's own rounding of these ops depends on how it fuses
  the step, so the costs differ by an ulp from the first step on and the
  1/Δθ² homodyne gain carries that into the parameters.  Measured over
  these runs: |ΔC̃| ≤ 9e-8 and |Δθ| ≤ 3.2e-5 after 36 steps; the test
  holds C̃ to 1e-6 and the parameters to 2e-4 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.data import tasks as jtasks
from repro.models.simple import make_mlp_probe_fn as jprobe_fn
from repro.models.simple import mlp_apply as jmlp_apply
from repro.models.simple import mlp_init as jmlp_init
import repro_torch as rt
from repro_torch import convert
from repro_torch.core import mgd as tmgd
from repro_torch.core.utils import tree_leaves

XOR_X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
XOR_Y = np.array([[0.], [1.], [1.], [0.]], np.float32)
CT_ATOL = 1e-6
PARAM_ATOL = 2e-4

GRID = [dict(mode=mode, eta=eta, **window)
        for mode in ("forward", "central")
        for window in ({}, {"replay": True, "tau_theta": 4})
        for eta in (0.5, 1.0)]
GRID_IDS = [f"{g['mode']}-{'replay4' if g.get('replay') else 'tau1'}"
            f"-eta{g['eta']}" for g in GRID]


def _tloss(p, b):
    return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])


def _jloss(p, b):
    return jcore.mse(jmlp_apply(p, b["x"]), b["y"])


def _xor_params():
    p = jmlp_init(jax.random.PRNGKey(0), (2, 2, 1))
    return jax.tree_util.tree_map(np.asarray, p)


def _run_port(cfg, params_np, batches):
    params = convert.to_torch(params_np, device="cpu")
    step = tmgd.build_mgd_step(
        _tloss, cfg, probe_fn=rt.make_mlp_probe_fn() if cfg.fused else None)
    state = tmgd.mgd_init(params, cfg)
    cts = []
    for x, y in batches:
        params, state, m = step(params, state, {"x": torch.from_numpy(x),
                                                "y": torch.from_numpy(y)})
        cts.append(m["c_tilde"].item())
    return np.array(cts, np.float32), [t.numpy() for t in tree_leaves(params)]


def _run_jax(cfg, params_np, batches):
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    step = jax.jit(jcore.build_mgd_step(
        _jloss, cfg, probe_fn=jprobe_fn() if cfg.fused else None))
    state = jcore.mgd_init(params, cfg)
    cts = []
    for x, y in batches:
        params, state, m = step(params, state, {"x": jnp.asarray(x),
                                                "y": jnp.asarray(y)})
        cts.append(np.asarray(m["c_tilde"]))
    return (np.array(cts, np.float32),
            [np.asarray(a) for a in jax.tree_util.tree_leaves(params)])


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_fused_bit_identical_mlp(case):
    """≥ 32 steps: C̃ and parameters bitwise equal between the fused path
    (plain kernel versions on the CPU) and the materializing path."""
    batches = [(XOR_X, XOR_Y)] * 36
    base = dict(dtheta=1e-2, seed=3, **case)
    c_mat, p_mat = _run_port(tmgd.MGDConfig(**base), _xor_params(), batches)
    c_fus, p_fus = _run_port(tmgd.MGDConfig(fused=True, **base),
                             _xor_params(), batches)
    np.testing.assert_array_equal(c_mat, c_fus)
    for a, b in zip(p_mat, p_fus):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_port_tracks_reference_mlp(case):
    """The port's fused trainer against the JAX package's fused trainer
    (interpret kernels) from the same params, at the module docstring's
    cross-framework tolerance."""
    batches = [(XOR_X, XOR_Y)] * 36
    base = dict(dtheta=1e-2, seed=3, **case)
    c_t, p_t = _run_port(tmgd.MGDConfig(fused=True, **base), _xor_params(),
                         batches)
    c_j, p_j = _run_jax(jcore.MGDConfig(fused=True, kernel_impl="interpret",
                                        **base), _xor_params(), batches)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=CT_ATOL)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("mode", ["central", "forward"])
def test_port_tracks_reference_nist7x7(mode):
    """NIST7x7 49-4-4, batch 8, 32 steps of the paper's Δθ = 1e-2,
    η = 0.1, with batches drawn by the JAX package and fed to both."""
    p = jmlp_init(jax.random.PRNGKey(2), (49, 4, 4))
    params_np = jax.tree_util.tree_map(np.asarray, p)
    batches = [tuple(np.array(a) for a in jtasks.nist7x7_batch(
        jax.random.fold_in(jax.random.PRNGKey(7), i), 8)) for i in range(32)]
    base = dict(mode=mode, dtheta=1e-2, eta=0.1, seed=1)
    c_t, p_t = _run_port(tmgd.MGDConfig(fused=True, **base), params_np,
                         batches)
    c_j, p_j = _run_jax(jcore.MGDConfig(fused=True, kernel_impl="interpret",
                                        **base), params_np, batches)
    assert np.isfinite(c_t).all()
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=CT_ATOL)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


MATERIALIZING = [
    dict(dtheta=1e-2, eta=0.25, tau_theta=3, momentum=0.9, probes=2, seed=2),
    dict(dtheta=1e-2, eta=0.5, tau_theta=2, seed=5),
    dict(dtheta=1e-2, eta=0.5, tau_theta=4, replay=True, staleness=1, seed=1),
    dict(dtheta=1e-2, eta=0.5, ptype="walsh", mode="central", seed=0),
    dict(dtheta=1e-2, eta=0.5, ptype="sequential", seed=0),
]


@pytest.mark.parametrize("kw", MATERIALIZING,
                         ids=["momentum-probes2", "accumulator", "staleness",
                              "walsh", "sequential"])
def test_materializing_paths_track_reference(kw):
    """The unfused optimizer's other branches (probe averaging, momentum,
    the G accumulator, stale replay, non-Rademacher codes) against the
    JAX package, at the same cross-framework tolerance."""
    batches = [(XOR_X, XOR_Y)] * 24
    c_t, p_t = _run_port(tmgd.MGDConfig(**kw), _xor_params(), batches)
    c_j, p_j = _run_jax(jcore.MGDConfig(**kw), _xor_params(), batches)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=CT_ATOL)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_fused_requires_probe_fn_and_valid_config():
    with pytest.raises(ValueError):
        tmgd.build_mgd_step(_tloss, tmgd.MGDConfig(fused=True))
    with pytest.raises(ValueError):
        tmgd.MGDConfig(fused=True, ptype="walsh")
    with pytest.raises(ValueError):
        tmgd.MGDConfig(fused=True, tau_theta=4)          # needs replay
    with pytest.raises(ValueError):
        tmgd.MGDConfig(fused=True, momentum=0.9)
    with pytest.raises(ValueError):
        tmgd.MGDConfig(staleness=1)                      # needs replay
    with pytest.raises(ValueError):
        tmgd.MGDConfig(mode="backward")


def test_fused_step_reads_no_device_value_on_host():
    """The step counter, the C₀ refresh and the update decision are host
    ints/bools; C̃, C₀ and the replay window stay tensors."""
    cfg = tmgd.MGDConfig(fused=True, mode="forward", replay=True,
                         tau_theta=4, dtheta=1e-2, eta=0.5)
    params = convert.to_torch(_xor_params(), device="cpu")
    step = tmgd.build_mgd_step(_tloss, cfg, probe_fn=rt.make_mlp_probe_fn())
    state = tmgd.mgd_init(params, cfg)
    batch = {"x": torch.from_numpy(XOR_X), "y": torch.from_numpy(XOR_Y)}
    for _ in range(5):
        params, state, m = step(params, state, batch)
    assert isinstance(state.step, int) and state.step == 5
    assert isinstance(state.replay_c, torch.Tensor)
    assert state.replay_c.shape == (4,)
    assert all(isinstance(v, torch.Tensor) for v in m.values())


def test_defective_mlp_probe_tracks_reference():
    """Per-neuron activation defects (paper §3.5) on the fused probe and on
    ``mlp_apply``, against the JAX package with the same defect arrays,
    at the cross-framework tolerance (the sigmoid's last ulp)."""
    from repro.core import perturbations as jpert
    from repro.core.noise import ActivationDefects as JDefects
    from repro_torch.core import perturbations as tpert
    from repro_torch.core.noise import ActivationDefects as TDefects

    rng = np.random.default_rng(4)
    params_np = jax.tree_util.tree_map(
        np.asarray, jmlp_init(jax.random.PRNGKey(2), (49, 4, 4)))
    defects_np = [[(1.0 + 0.2 * rng.standard_normal(4)).astype(np.float32),
                   (1.0 + 0.2 * rng.standard_normal(4)).astype(np.float32),
                   (0.2 * rng.standard_normal(4)).astype(np.float32),
                   (0.2 * rng.standard_normal(4)).astype(np.float32)]
                  for _ in range(2)]
    x, y = (np.array(a) for a in jtasks.nist7x7_batch(
        jax.random.PRNGKey(5), 8))
    jd = [JDefects(*map(jnp.asarray, d)) for d in defects_np]
    td = [TDefects(*map(torch.from_numpy, d)) for d in defects_np]
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    tparams = convert.to_torch(params_np, device="cpu")
    jctx = jpert.ProbeCtx(signs=(1.0, -1.0), dtheta=1e-2, impl="interpret")
    tctx = tpert.ProbeCtx(signs=(1.0, -1.0), dtheta=1e-2)
    want = jprobe_fn(jd)(jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         jpert.Probe(jnp.int32(3), jnp.uint32(1), jctx))
    got = rt.make_mlp_probe_fn(td)(
        tparams, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        tpert.Probe(3, 1, tctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CT_ATOL)
    np.testing.assert_allclose(
        rt.mlp_apply(tparams, torch.from_numpy(x), td).numpy(),
        np.asarray(jmlp_apply(jparams, jnp.asarray(x), jd)), rtol=0,
        atol=CT_ATOL)
