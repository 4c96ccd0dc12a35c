"""The port's probe parallelism: k pods, one after another on one device.

Twins of ``tests/test_probe_parallel_multi.py``.  The reference's mesh
tests need ≥ 4 devices and skip in a one-device run, so its trajectories
are computed ONCE per module in a subprocess with 8 virtual CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` does), written to a temporary ``.npz`` and
compared here.  The reference's params reach the port through
``repro_torch.convert``.

Tolerances:

* within the port, fused ≡ materializing, run ≡ rerun, resume ≡
  uninterrupted and the k-pod step ≡ the k-chip farm are BITWISE (f32);
* port against reference: C̃ 1e-6 and params 2e-4 absolute, the MLP's
  cross-framework tolerances (ROADMAP queue C: torch's and XLA's CPU
  ``sigmoid``/``matmul`` round apart in the last ulp, and the 1/Δθ²
  homodyne gain carries that into the params); pod 0's cost 1e-5 (a
  cost gap follows the params' gap times |∂C/∂θ|);
* the dyadic ``LinearLaneChip`` law is exact arithmetic, so the port's
  k-pod step and k-chip farm equal the reference's mesh BITWISE;
* ``data_axis`` against the pod-only step: rtol 1e-3, as the reference.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.models.simple import mlp_init as jmlp_init
import repro_torch as rt
from repro_torch import convert
from repro_torch.api import replace_step
from repro_torch.core import mae
from repro_torch.core import perturbations as pert
from repro_torch.core.probe_parallel import LocalMesh, pod_seed
from repro_torch.core.utils import tree_add, tree_axpy, tree_leaves
from repro_torch.hardware import ChipFarm, LinearLaneChip, simulated_chip_farm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CT_ATOL = 1e-6
PARAM_ATOL = 2e-4
COST_ATOL = 1e-5

X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
Y = np.array([[0.], [1.], [1.], [0.]], np.float32)

# The reference's runs, one subprocess for the module.  Each record holds
# the initial params, and per step C̃ (aux "c_tilde"), aux "cost" and the
# flattened params (plus the full-batch XOR loss for "drops").
REFERENCE = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro
from repro.core import mae, mse
from repro.data import tasks
from repro.models.simple import (linear_apply, make_mlp_probe_fn, mlp_apply,
                                 mlp_init)

X, Y = tasks.xor_dataset()
out = {}


def loss(p, b):
    return mse(mlp_apply(p, b["x"]), b["y"])


def mesh(shape, names):
    devs = jax.devices()[:int(np.prod(shape))]
    return Mesh(np.array(devs).reshape(shape), names)


def leaves(p):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


def record(name, cfg, lossf, p, batch, steps, m, full=None, **kw):
    drv = repro.driver("probe_parallel", cfg, lossf, mesh=m, **kw)
    s = drv.init(p)
    for i, x in enumerate(leaves(p)):
        out[f"{name}/p0/{i}"] = x
    cts, costs, fulls, ps = [], [], [], []
    for _ in range(steps):
        p, s, aux = drv.step(p, s, batch)
        cts.append(float(aux["c_tilde"]))
        costs.append(float(aux["cost"]))
        if full is not None:
            fulls.append(float(full(p)))
        ps.append(np.concatenate([x.ravel() for x in leaves(p)]))
    out[f"{name}/c_tilde"] = np.array(cts, np.float32)
    out[f"{name}/cost"] = np.array(costs, np.float32)
    out[f"{name}/params"] = np.stack(ps)
    if full is not None:
        out[f"{name}/full_loss"] = np.array(fulls, np.float32)


sharded = {"x": X.reshape(4, 1, 2), "y": Y.reshape(4, 1, 1)}
m4 = mesh((4,), ("pod",))
p_xor = mlp_init(jax.random.PRNGKey(0), (2, 2, 1))
cfg = repro.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3)
record("xor", cfg, loss, p_xor, sharded, 36, m4)
record("xor_fused", cfg.replace(fused=True), loss, p_xor, sharded, 4, m4,
       probe_fn=make_mlp_probe_fn())
full = jax.jit(lambda p: loss(p, {"x": X, "y": Y}))
record("drops", repro.DriverConfig(dtheta=1e-2, eta=2.0, mode="central",
                                   seed=0), loss, p_xor, sharded, 300, m4,
       full=full)
dy = [{"w": jnp.array([[0.5], [-0.25]], jnp.float32),
       "b": jnp.array([0.25], jnp.float32)}]
x = np.tile(np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32), (2, 1))
y = np.tile(np.array([[0], [1], [1], [0]], np.float32), (2, 1))
record("dyadic", repro.DriverConfig(dtheta=0.5, eta=0.5, mode="central",
                                    seed=5),
       lambda p, b: mae(b["y"], linear_apply(p, b["x"])), dy,
       {"x": jnp.asarray(x), "y": jnp.asarray(y)}, 5, m4)
tiled = {"x": jnp.tile(X, (2, 1)), "y": jnp.tile(Y, (2, 1))}
record("data2d", repro.DriverConfig(dtheta=1e-2, eta=0.5, mode="central",
                                    seed=4), loss, p_xor, tiled, 20,
       mesh((4, 2), ("pod", "data")), data_axis="data")
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("pp_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", ""))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(path)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


def _ref_params(ref, name):
    n = len([k for k in ref if k.startswith(f"{name}/p0/")])
    ls = [ref[f"{name}/p0/{i}"] for i in range(n)]
    layers = [{"b": ls[i], "w": ls[i + 1]} for i in range(0, n, 2)]
    return convert.to_torch(layers, device="cpu")


def _loss(p, b):
    return rt.mse(rt.mlp_apply(p, b["x"]), b["y"])


def _l1_loss(p, b):
    return mae(b["y"], rt.linear_apply(p, b["x"]))


def _mesh4():
    return LocalMesh(pod=4)


def _sharded_batch():
    # 4 pods, each with its own single-example block of the xor table
    return {"x": torch.from_numpy(X.reshape(4, 1, 2)),
            "y": torch.from_numpy(Y.reshape(4, 1, 1))}


def _xor_params(seed=0):
    p = jmlp_init(jax.random.PRNGKey(seed), (2, 2, 1))
    return convert.to_torch(jax.tree_util.tree_map(np.asarray, p),
                            device="cpu")


def _pp(cfg, loss=_loss, mesh=None, **kw):
    return rt.driver("probe_parallel", cfg, loss, mesh=mesh or _mesh4(),
                     device="cpu", **kw)


def _flat(p):
    return np.concatenate([x.numpy().ravel() for x in tree_leaves(p)])


def _assert_trees_equal(a, b, msg=""):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), msg


def _trajectory(drv, p, batch, steps):
    s = drv.init(p)
    cts, costs, ps = [], [], []
    for _ in range(steps):
        p, s, aux = drv.step(p, s, batch)
        cts.append(aux["c_tilde"].item())
        costs.append(aux["cost"].item())
        ps.append(_flat(p))
    return (np.array(cts, np.float32), np.array(costs, np.float32),
            np.stack(ps), p)


# ---------------------------------------------------------------------------
# The reference's mesh tests, on the port
# ---------------------------------------------------------------------------


def test_k4_matches_manual_probe_average():
    """One 4-pod step == the hand-computed k-probe averaged update:
    per-pod central difference on the pod's block, then the sequential
    −η/(kΔθ²)·C̃_k·θ̃_k axpy chain, k = 0..3 in order."""
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3)
    drv = _pp(cfg)
    p0 = _xor_params()
    batch = _sharded_batch()
    p1, _, aux = drv.step(p0, drv.init(p0), batch)

    mcfg = drv.config
    inv_d2 = 1.0 / (mcfg.dtheta * mcfg.dtheta)
    all_c, p_ref = [], p0
    for k in range(4):
        theta = pert.generate(p0, ptype=mcfg.ptype, step=0,
                              seed=pod_seed(mcfg.seed, k),
                              dtheta=mcfg.dtheta)
        shard = {"x": batch["x"][k], "y": batch["y"][k]}
        c_plus = _loss(tree_add(p0, theta), shard)
        c_minus = _loss(tree_axpy(-1.0, theta, p0), shard)
        all_c.append(0.5 * (c_plus - c_minus).item())
    for k in range(4):
        theta = pert.generate(p_ref, ptype=mcfg.ptype, step=0,
                              seed=pod_seed(mcfg.seed, k),
                              dtheta=mcfg.dtheta)
        coef = -mcfg.eta * inv_d2 * all_c[k] / 4
        p_ref = tree_axpy(coef, theta, p_ref)

    np.testing.assert_allclose(aux["c_tilde"].item(),
                               float(np.mean(np.abs(all_c))), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p_ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_k4_deterministic_across_runs():
    """pod_seed-keyed probe streams: two fresh 4-pod drivers walk a bit
    identical trajectory."""
    def run():
        cfg = rt.DriverConfig(dtheta=1e-2, eta=1.0, mode="central", seed=7)
        cts, _, _, p = _trajectory(_pp(cfg), _xor_params(1),
                                   _sharded_batch(), 5)
        return p, cts

    p_a, ct_a = run()
    p_b, ct_b = run()
    np.testing.assert_array_equal(ct_a, ct_b)
    _assert_trees_equal(p_a, p_b)


def test_k4_cost_drops_on_xor(ref):
    """The 4-pod probe average trains: over the reference's 300 steps the
    full-batch XOR loss (the objective, all 4 examples) falls, as it does
    in the reference's own run.  ``aux["cost"]`` is pod 0's one-example
    cost, not this objective — which is why the reference's own
    ``test_k4_cost_drops_on_xor`` (reading ``aux["cost"]``) is red."""
    cfg = rt.DriverConfig(dtheta=1e-2, eta=2.0, mode="central", seed=0)
    drv = _pp(cfg)
    p = _ref_params(ref, "drops")
    s = drv.init(p)
    full = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
    losses = []
    for _ in range(300):
        p, s, _ = drv.step(p, s, _sharded_batch())
        losses.append(_loss(p, full).item())
    assert np.mean(losses[-30:]) < np.mean(losses[:30])
    ref_full = ref["drops/full_loss"]
    assert ref_full[-30:].mean() < ref_full[:30].mean()
    np.testing.assert_allclose(losses, ref_full, atol=COST_ATOL)


def test_aux_cost_is_pod0_cost(ref):
    """``aux["cost"]`` is ½(C₊ + C₋) of POD 0 (what the reference's
    ``out_specs=P()`` hands back), not a mean over the pods: equal to the
    hand-computed pod-0 pair bitwise, and to the reference's aux cost
    over its 36-step run within ``COST_ATOL``."""
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3)
    drv = _pp(cfg)
    p0 = _ref_params(ref, "xor")
    batch = _sharded_batch()
    _, _, aux = drv.step(p0, drv.init(p0), batch)
    theta = pert.generate(p0, ptype="rademacher", step=0,
                          seed=pod_seed(3, 0), dtheta=1e-2)
    shard = {"x": batch["x"][0:1], "y": batch["y"][0:1]}
    c_plus = _loss(tree_add(p0, theta), shard)
    c_minus = _loss(tree_axpy(-1.0, theta, p0), shard)
    assert torch.equal(aux["cost"], (0.5 * (c_plus + c_minus)).float())
    _, costs, _, _ = _trajectory(drv, p0, batch, 36)
    np.testing.assert_allclose(costs, ref["xor/cost"], atol=COST_ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["materializing",
                                                      "fused"])
def test_k4_tracks_reference_trajectory(ref, fused):
    """Port against the reference's 4-pod XOR mesh run (8-device
    subprocess) from the same converted params: C̃ within 1e-6 and params
    within 2e-4 at every step (36 steps materializing; the reference's
    interpret-mode fused run, 4 steps)."""
    name = "xor_fused" if fused else "xor"
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3,
                          fused=fused)
    kw = {"probe_fn": rt.make_mlp_probe_fn()} if fused else {}
    steps = len(ref[f"{name}/c_tilde"])
    cts, _, ps, _ = _trajectory(_pp(cfg, **kw), _ref_params(ref, name),
                                _sharded_batch(), steps)
    np.testing.assert_allclose(cts, ref[f"{name}/c_tilde"], atol=CT_ATOL)
    np.testing.assert_allclose(ps, ref[f"{name}/params"], atol=PARAM_ATOL)


@pytest.mark.parametrize("sizes,n", [((2, 2, 1), 4), ((49, 4, 4), 8)],
                         ids=["xor-2-2-1", "nist-49-4-4"])
def test_fused_mesh_bit_matches_materializing(sizes, n):
    """DriverConfig(fused=True) sends every pod through the perturbed
    matmul pair and the update through one grouped window update with
    J = 4; the shared coefficient vector keeps it bit-identical (f32) to
    the materializing pod chain."""
    if sizes[0] == 2:
        batch = _sharded_batch()
    else:
        x, y = rt.tasks.nist7x7_batch(rt.core.rng.prng_key(5), n,
                                      device="cpu")
        batch = {"x": x, "y": y}

    def run(fused):
        cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3,
                              fused=fused)
        kw = {"probe_fn": rt.make_mlp_probe_fn()} if fused else {}
        p = convert.to_torch(jax.tree_util.tree_map(
            np.asarray, jmlp_init(jax.random.PRNGKey(0), sizes)),
            device="cpu")
        cts, _, _, p = _trajectory(_pp(cfg, **kw), p, batch, 4)
        return p, cts

    p_mat, ct_mat = run(False)
    p_fus, ct_fus = run(True)
    np.testing.assert_array_equal(ct_mat, ct_fus)
    _assert_trees_equal(p_mat, p_fus)


# ---------------------------------------------------------------------------
# Batch sharding: k-pod step ≡ k-chip farm, bit for bit
# ---------------------------------------------------------------------------


def _dyadic_params():
    # multiples of 1/4: with dtheta/eta = 1/2 and k = 4 every value the
    # trajectory produces stays exactly representable in f32 for the
    # horizon below
    return [{"w": torch.tensor([[0.5], [-0.25]]),
             "b": torch.tensor([0.25])}]


def _dyadic_batch():
    # 8 rows = 4 contiguous 2-row blocks; {0,1} inputs keep every product
    # exact.  Pod blocks ≡ the farm's shard_chip_batch slices.
    x = np.tile(np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32),
                (2, 1))
    y = np.tile(np.array([[0], [1], [1], [0]], np.float32), (2, 1))
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _dyadic_cfg():
    return rt.DriverConfig(dtheta=0.5, eta=0.5, mode="central", seed=5)


def _farm_driver(farm):
    return rt.driver("probe_parallel_external", _dyadic_cfg(), plant=farm,
                     device="cpu")


def test_sharded_mesh_bit_matches_sharded_farm(ref):
    """THE bit-equality law under batch sharding: 4 pods on their default
    batch blocks walk the identical f32 trajectory to a 4-chip
    LinearLaneChip farm fed the same contiguous per-chip shards — and
    both equal the reference's 4-device mesh bitwise (dyadic data and
    params make every intermediate exact, in numpy, torch and XLA)."""
    batch = _dyadic_batch()
    drv = _pp(_dyadic_cfg(), loss=_l1_loss)
    p_m = _dyadic_params()
    s_m = drv.init(p_m)
    with ChipFarm([LinearLaneChip() for _ in range(4)],
                  shard_batch=True) as farm:
        ext = _farm_driver(farm)
        p_f = _dyadic_params()
        s_f = ext.init(p_f)
        for step in range(5):
            p_m, s_m, aux_m = drv.step(p_m, s_m, batch)
            p_f, s_f, aux_f = ext.step(p_f, s_f, batch)
            assert torch.equal(aux_m["c_tilde"], aux_f["c_tilde"]), step
            _assert_trees_equal(p_m, p_f, f"params diverged at step {step}")
            assert aux_m["c_tilde"].item() == ref["dyadic/c_tilde"][step]
            np.testing.assert_array_equal(_flat(p_m),
                                          ref["dyadic/params"][step])


def test_sharded_resume_bit_exact():
    """Stopping a batch-sharded run at step 3 and resuming through a
    FRESH driver (and a FRESH farm, its chips re-written from the
    checkpointed params on the next probe) lands bit-identical to the
    straight run, on both sides of the law."""
    batch = _dyadic_batch()

    def mesh_run(n, carry=None):
        drv = _pp(_dyadic_cfg(), loss=_l1_loss)
        p, s = carry if carry else (_dyadic_params(), None)
        s = drv.init(p) if s is None else s
        for _ in range(n):
            p, s, _ = drv.step(p, s, batch)
        return p, s

    def farm_run(n, carry=None):
        with ChipFarm([LinearLaneChip() for _ in range(4)],
                      shard_batch=True) as farm:
            ext = _farm_driver(farm)
            p, s = carry if carry else (_dyadic_params(), None)
            s = ext.init(p) if s is None else s
            for _ in range(n):
                p, s, _ = ext.step(p, s, batch)
        return p, s

    p_straight, _ = mesh_run(5)
    p_resumed, _ = mesh_run(2, carry=mesh_run(3))
    _assert_trees_equal(p_straight, p_resumed)
    f_straight, _ = farm_run(5)
    f_resumed, _ = farm_run(2, carry=farm_run(3))
    _assert_trees_equal(f_straight, f_resumed)
    _assert_trees_equal(p_resumed, f_resumed)


# ---------------------------------------------------------------------------
# A data axis inside each pod
# ---------------------------------------------------------------------------


def test_data_axis_pmean_agrees_with_pod_only(ref):
    """(pod=4, data=2) with data_axis="data": each pod's cost pair is the
    mean of its two data sub-blocks.  Equal sub-block sizes make that
    the same mean up to association, so the trajectory tracks the
    pod-only run closely (rtol 1e-3, as the reference); and it tracks the
    reference's own (pod=4, data=2) mesh at the MLP tolerances."""
    batch = {"x": torch.from_numpy(np.tile(X, (2, 1))),
             "y": torch.from_numpy(np.tile(Y, (2, 1)))}
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=4)
    cts2, costs2, ps2, p_2d = _trajectory(
        _pp(cfg, mesh=LocalMesh(pod=4, data=2), data_axis="data"),
        _ref_params(ref, "data2d"), batch, 20)
    _, costs1, _, p_1d = _trajectory(_pp(cfg), _ref_params(ref, "data2d"),
                                     batch, 20)
    assert np.isfinite(costs2[-1])
    np.testing.assert_allclose(costs2[-1], costs1[-1], rtol=1e-3)
    for a, b in zip(tree_leaves(p_2d), tree_leaves(p_1d)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)
    np.testing.assert_allclose(cts2, ref["data2d/c_tilde"], atol=CT_ATOL)
    np.testing.assert_allclose(ps2, ref["data2d/params"], atol=PARAM_ATOL)


def test_data_axis_blocks_are_pod_major():
    """Pod p's data sub-blocks are blocks p·d … p·d + d − 1 of the k·d
    split (the reference's P(("pod", "data")) order): a batch whose rows
    differ only inside pod 0's block moves only pod 0's C̃."""
    cfg = rt.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=4)
    drv = _pp(cfg, mesh=LocalMesh(pod=4, data=2), data_axis="data")
    base = {"x": torch.zeros(8, 2), "y": torch.zeros(8, 1)}
    p = _xor_params()
    _, _, a0 = drv.step(p, drv.init(p), base)
    moved = {"x": base["x"].clone(), "y": base["y"].clone()}
    moved["y"][1] = 1.0          # row 1: pod 0, data block 1
    _, _, a1 = drv.step(p, drv.init(p), moved)
    assert a1["cost"].item() != a0["cost"].item()   # pod 0 saw it
    moved = {"x": base["x"].clone(), "y": base["y"].clone()}
    moved["y"][2] = 1.0          # row 2: pod 1's first block
    _, _, a2 = drv.step(p, drv.init(p), moved)
    assert a2["cost"].item() == a0["cost"].item()   # pod 0 did not


def test_ghat_variance_falls_with_k():
    """The scaling-laws acceptance axis: at frozen params with a
    replicated batch (batch_specs=()), the k-averaged estimator's
    across-step variance falls ≈ 1/k — var(k=1)/var(k=4) lands near 4."""
    batch = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
    params = _xor_params()

    def variance(k, rounds=48):
        cfg = rt.DriverConfig(dtheta=1e-2, eta=1.0, mode="central", seed=0)
        drv = _pp(cfg, mesh=LocalMesh(pod=k), batch_specs=())
        state = drv.init(params)
        w0 = tree_leaves(params)[1][0, 0].item()
        samples = []
        for t in range(rounds):
            p1, _, _ = drv.step(params, replace_step(state, t), batch)
            samples.append(tree_leaves(p1)[1][0, 0].item() - w0)
        return float(np.var(samples))

    ratio = variance(1) / variance(4)
    assert 2.0 < ratio < 8.0, f"var(k=1)/var(k=4) = {ratio}"


# ---------------------------------------------------------------------------
# Validation: the reference's refusals, and the port's own
# ---------------------------------------------------------------------------


def _central(**kw):
    return rt.DriverConfig(mode="central", **kw)


@pytest.mark.parametrize("build,exc,match", [
    (lambda: rt.driver("probe_parallel", _central(), _loss, device="cpu"),
     ValueError, "mesh="),
    (lambda: _pp(rt.DriverConfig()), ValueError, "central"),
    (lambda: _pp(_central(), probe_fn=rt.make_mlp_probe_fn()),
     ValueError, "fused=True"),
    (lambda: _pp(_central(probes=4)), ValueError, "probes=1"),
    (lambda: _pp(_central(tau_theta=4)), ValueError, "tau_theta=1"),
    (lambda: _pp(_central(replay=True, tau_theta=1)), ValueError,
     "tau_theta=1"),
    (lambda: _pp(_central(), mesh=LocalMesh(chip=4)), ValueError,
     "no probe axis"),
    (lambda: _pp(_central(), data_axis="pod"), ValueError,
     "IS the probe axis"),
    (lambda: _pp(_central(), data_axis="data"), ValueError,
     "no data axis"),
    (lambda: _pp(_central(fused=True)), ValueError, "probe_fn"),
    (lambda: _pp(_central(), batch_specs=("data",)), ValueError,
     "batch_specs"),
    (lambda: rt.driver("probe_parallel", _central(), None,
                       mesh=_mesh4(), device="cpu",
                       plant=simulated_chip_farm(2, (2, 2, 1))),
     ValueError, "probe_parallel_external"),
])
def test_probe_parallel_validation(build, exc, match):
    with pytest.raises(exc, match=match):
        build()


def test_fused_probe_parallel_takes_param_specs():
    """``param_specs=`` with ``cfg.fused=True`` builds and steps (it once
    raised naming ROADMAP A15b); on a LocalMesh nothing is placed, so its
    steps are the fused k-pod steps without it, bit for bit (the sharded
    run is held on the (pod 2, model 2) gloo world of
    ``tests/test_torch_distributed.py``)."""
    runs = []
    for specs in ([("w", ["model"])], None):
        drv = _pp(_central(fused=True), probe_fn=rt.make_mlp_probe_fn(),
                  param_specs=specs)
        p = _xor_params()
        s = drv.init(p)
        for _ in range(4):
            p, s, _ = drv.step(p, s, _sharded_batch())
        runs.append(p)
    _assert_trees_equal(runs[0], runs[1])


def test_local_mesh_reads_like_a_mesh():
    m = LocalMesh(axis_names=("pod", "data"), shape={"pod": 4, "data": 2})
    assert m.shape["pod"] == 4 and m.axis_names == ("pod", "data")
    assert LocalMesh(pod=3).shape == {"pod": 3}
    assert repr(LocalMesh(pod=2, data=3)) == "LocalMesh(pod=2, data=3)"
    with pytest.raises(ValueError, match="do not match"):
        LocalMesh(axis_names=("pod",), shape={"data": 2})
    with pytest.raises(ValueError, match="size 0"):
        LocalMesh(pod=0)


def test_pod_seed_is_the_probe_seed():
    """One definition: pod k's seed is seed + k·0x9E3779B9 mod 2³², the
    single-program driver's probe seeds and the reference's pod_seed."""
    from repro.core.probe_parallel import pod_seed as jpod_seed
    from repro_torch.core.mgd import MGDConfig, _probe_seed
    for seed, k in [(0, 0), (3, 1), (7, 5), (2 ** 32 - 1, 3)]:
        assert pod_seed(seed, k) == int(jpod_seed(seed, k))
        assert _probe_seed(MGDConfig(seed=seed % 2 ** 31), k) == \
            pod_seed(seed % 2 ** 31, k)
