"""The port's chip farm and ExternalPlant read path.

Twins of ``tests/test_farm.py``, plus the port-vs-reference contracts of
the host boundary:

* the numpy chips (``SimulatedAnalogChip``, ``DriftingAnalogChip``,
  ``LinearLaneChip``) are the reference's, draw for draw: on the same
  params their readouts equal the reference chips' BITWISE;
* a ``SimulatedAnalogChip`` farm walks the reference's farm trajectory
  BITWISE when the reference's step runs eagerly (``jax.disable_jit``);
  against its jitted step the params sit a few f32 ulps apart (XLA
  contracts ``p + coef·θ̃`` into an FMA there; the port's two torch ops
  never contract), so that comparison holds C̃ to 1e-6 and params to
  2e-4, the MLP's cross-framework tolerances (ROADMAP queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.hardware import SimulatedAnalogChip as JSimChip
from repro.hardware import simulated_chip_farm as jsimulated_chip_farm
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.api import DriverConfig, driver, replace_step
from repro_torch.core import MGDConfig, build_mgd_step, mgd_init
from repro_torch.core.utils import tree_leaves, tree_map
from repro_torch.hardware import (ChipFarm, DriftingAnalogChip,
                                  ExternalPlant, LinearLaneChip,
                                  SimulatedAnalogChip, simulated_chip_farm)
from repro_torch.training import TrainLoopConfig, train_mgd

X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
Y = np.array([[0.], [1.], [1.], [0.]], np.float32)
BATCH = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
NP_BATCH = {"x": X, "y": Y}
CT_ATOL = 1e-6
PARAM_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _close_plants(monkeypatch):
    """Close every farm/plant a test builds (their backends own worker
    threads and processes; ``close()`` is idempotent)."""
    created = []
    for cls in (ChipFarm, ExternalPlant):
        orig = cls.__init__

        def tracked(self, *a, _orig=orig, **kw):
            _orig(self, *a, **kw)
            created.append(self)

        monkeypatch.setattr(cls, "__init__", tracked)
    yield
    for plant in created:
        plant.close()


def _np_params(seed=0, sizes=(2, 2, 1)):
    return jax.tree_util.tree_map(
        np.asarray, jmlp_init(jax.random.PRNGKey(seed), sizes))


def _params(seed=0, sizes=(2, 2, 1)):
    return convert.to_torch(_np_params(seed, sizes), device="cpu")


def _assert_trees_equal(a, b):
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(la, torch.Tensor):
            assert torch.equal(la, lb)
        else:
            assert la == lb


def _flat(p):
    return np.concatenate([np.asarray(x).ravel() for x in
                           (t.numpy() if isinstance(t, torch.Tensor) else t
                            for t in tree_leaves(p))])


# ---------------------------------------------------------------------------
# Instrumented fake devices
# ---------------------------------------------------------------------------


class RecordingDevice:
    """Counter-capable 2-method device: records every (step, tag) its
    readout sees and counts persistent writes.  Cost is a deterministic
    function of the stored parameters so the driver math runs."""

    def __init__(self):
        self.writes = 0
        self.calls = []          # (step, tag) per measure_cost
        self._params = None

    def set_params(self, params):
        self.writes += 1
        self._params = tree_map(lambda w: np.asarray(w, np.float32), params)

    def _cost(self, params):
        return float(sum(np.sum(leaf * leaf) for leaf in tree_leaves(params)))

    def measure_cost(self, batch, *, step=None, tag=None):
        self.calls.append((step, tag))
        return self._cost(self._params)


class PairDevice(RecordingDevice):
    """RecordingDevice + differential probe line."""

    def __init__(self):
        super().__init__()
        self.pair_calls = []     # (step, tag) per measure_pair

    def measure_pair(self, theta, batch, *, step=None, tag=None):
        self.pair_calls.append((step, tag))
        plus = tree_map(lambda w, t: w + np.asarray(t, np.float32),
                        self._params, theta)
        minus = tree_map(lambda w, t: w - np.asarray(t, np.float32),
                         self._params, theta)
        return self._cost(plus), self._cost(minus)


class LegacyDevice:
    """The historical 1-arg instrument surface — must keep working."""

    def __init__(self):
        self.writes = 0
        self._params = None

    def set_params(self, params):
        self.writes += 1
        self._params = tree_map(lambda w: np.asarray(w, np.float32), params)

    def measure_cost(self, batch):
        return float(sum(np.sum(np.abs(leaf)) for leaf in
                         tree_leaves(self._params)))


def _central_cfg(**kw):
    return MGDConfig(dtheta=1e-2, eta=0.1, mode="central", seed=0, **kw)


# ---------------------------------------------------------------------------
# ExternalPlant read path
# ---------------------------------------------------------------------------


def test_read_cost_forwards_step_and_tag():
    device = RecordingDevice()
    plant = ExternalPlant(device)
    c = plant.read_cost(_params(), BATCH, step=7, tag=5)
    assert c.dtype == torch.float32 and c.dim() == 0
    assert np.isfinite(c.item())
    assert device.calls == [(7, 5)]


def test_pair_reads_get_distinct_tags_and_step():
    """Default (no measure_pair) central pair: the two reads arrive with
    consecutive tags and the true optimizer step — a counter-keyed
    device can tell the +θ̃ read from the −θ̃ read."""
    device = RecordingDevice()
    plant = ExternalPlant(device)
    step = build_mgd_step(None, _central_cfg(), plant=plant)
    p, s = _params(), mgd_init(_params(), _central_cfg())
    for _ in range(3):
        p, s, _ = step(p, s, BATCH)
    assert device.calls == [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
    # two perturbed probe writes + one update write per step
    assert device.writes == 3 * 3


def test_pair_capable_device_single_write_per_pair():
    """measure_pair drops the probe writes per central pair from 2 full
    perturbed trees to 1 base-θ write (plus the unchanged update
    write): 3 writes/step → 2 writes/step."""
    device = PairDevice()
    plant = ExternalPlant(device)
    step = build_mgd_step(None, _central_cfg(), plant=plant)
    p, s = _params(), mgd_init(_params(), _central_cfg())
    n = 4
    for _ in range(n):
        p, s, _ = step(p, s, BATCH)
    assert device.writes == 2 * n
    assert device.pair_calls == [(t, 0) for t in range(n)]
    assert device.calls == []          # never fell back to single reads


def test_legacy_two_arg_device_still_works():
    device = LegacyDevice()
    plant = ExternalPlant(device)
    step = build_mgd_step(None, _central_cfg(), plant=plant)
    p, s = _params(), mgd_init(_params(), _central_cfg())
    p, s, m = step(p, s, BATCH)
    assert np.isfinite(m["cost"].item())
    assert device.writes == 3


@pytest.mark.parametrize("kw", [dict(mode="forward"),
                                dict(tau_theta=4),
                                dict(replay=True, tau_theta=4)],
                         ids=["forward", "tau4", "replay"])
def test_external_plant_keeps_the_reference_refusal(kw):
    """The reference's one cond-free step, kept as it is: external plants
    run central τ_θ = 1 without replay."""
    base = dict(dtheta=1e-2, eta=0.1, seed=0, mode="central")
    base.update(kw)
    with pytest.raises(ValueError, match="external plants need"):
        build_mgd_step(None, MGDConfig(**base),
                       plant=ExternalPlant(PairDevice()))


def test_sim_chip_readout_noise_counter_keyed():
    """Same (step, tag) → the same readout draw (replay-deterministic);
    different tag or step → a different draw; no counters → live RNG."""
    chip = SimulatedAnalogChip((2, 2, 1), seed=3, sigma_a=0.0,
                               sigma_theta=0.0, sigma_c=1.0)
    chip.set_params(_np_params())
    a = chip.measure_cost(NP_BATCH, step=5, tag=0)
    b = chip.measure_cost(NP_BATCH, step=5, tag=0)
    assert a == b
    assert chip.measure_cost(NP_BATCH, step=5, tag=1) != a
    assert chip.measure_cost(NP_BATCH, step=6, tag=0) != a
    assert chip.measure_cost(NP_BATCH) != chip.measure_cost(NP_BATCH)


def test_sim_chip_measure_pair_rides_probe_line():
    """measure_pair perturbs transiently: no extra persistent write, and
    the ± halves differ."""
    chip = SimulatedAnalogChip((2, 2, 1), seed=0, sigma_a=0.0,
                               sigma_theta=0.0, sigma_c=0.0)
    p = _np_params()
    chip.set_params(p)
    writes = chip.writes
    theta = tree_map(lambda x: 0.01 * np.ones_like(x), p)
    c_plus, c_minus = chip.measure_pair(theta, NP_BATCH, step=0, tag=0)
    assert chip.writes == writes          # no persistent write happened
    assert c_plus != c_minus
    assert np.isfinite([c_plus, c_minus]).all()


# ---------------------------------------------------------------------------
# The numpy chips against the reference's
# ---------------------------------------------------------------------------


def _reference_chip(kind, seed):
    from repro.hardware import DriftingAnalogChip as JDrift
    from repro.hardware import LinearLaneChip as JLane
    if kind == "sim":
        return (SimulatedAnalogChip((2, 2, 1), seed=seed, sigma_a=0.15,
                                    sigma_theta=0.01, sigma_c=1e-3),
                JSimChip((2, 2, 1), seed=seed, sigma_a=0.15,
                         sigma_theta=0.01, sigma_c=1e-3))
    if kind == "drift":
        kw = dict(seed=seed, sigma_a=0.15, sigma_theta=0.01, sigma_c=1e-3,
                  drift_rate=1e-2, drift_tau=50.0)
        return (DriftingAnalogChip((2, 2, 1), **kw),
                JDrift((2, 2, 1), **kw))
    return LinearLaneChip(seed=seed), JLane(seed=seed)


@pytest.mark.parametrize("kind", ["sim", "drift", "lane"])
@pytest.mark.parametrize("seed", [0, 7])
def test_chips_match_reference_bitwise(kind, seed):
    """Same params, same counters → the port's chip reads exactly what
    the reference's reads: defects, live write noise, counter-keyed
    readout noise and drift, draw for draw."""
    port, jref = _reference_chip(kind, seed)
    p = _np_params(seed)
    theta = tree_map(lambda x: 0.01 * np.ones_like(x), p)
    for step in range(3):
        if kind == "drift":
            port.set_params(p, step=step)
            jref.set_params(p, step=step)
        else:
            port.set_params(p)
            jref.set_params(p)
        assert port.measure_cost(NP_BATCH, step=step + 2, tag=1) == \
            jref.measure_cost(NP_BATCH, step=step + 2, tag=1)
        assert port.measure_pair(theta, NP_BATCH, step=step + 2, tag=4) == \
            jref.measure_pair(theta, NP_BATCH, step=step + 2, tag=4)
        assert port.measure_accuracy(NP_BATCH, step=step + 2) == \
            jref.measure_accuracy(NP_BATCH, step=step + 2)
    assert port.writes == jref.writes


def _reference_farm_run(steps, eager, **kw):
    farm = jsimulated_chip_farm(3, (2, 2, 1), base_seed=5, **kw)
    cfg = repro.DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=2)
    mgd = repro.driver("probe_parallel_external", cfg, plant=farm)
    p = jax.tree_util.tree_map(jnp.asarray, _np_params(1))
    s = mgd.init(p)
    cts, ps = [], []
    batch = {"x": jnp.asarray(X), "y": jnp.asarray(Y)}

    def go():
        nonlocal p, s
        for _ in range(steps):
            p, s, m = mgd.step(p, s, batch)
            cts.append(float(m["c_tilde"]))
            ps.append(np.concatenate([np.asarray(x).ravel() for x in
                                      jax.tree_util.tree_leaves(p)]))
    if eager:
        with jax.disable_jit():
            go()
    else:
        go()
    farm.close()
    return np.array(cts, np.float32), np.stack(ps)


def _port_farm_run(steps, **kw):
    with simulated_chip_farm(3, (2, 2, 1), base_seed=5, **kw) as farm:
        cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=2)
        mgd = driver("probe_parallel_external", cfg, plant=farm,
                     device="cpu")
        p = _params(1)
        s = mgd.init(p)
        cts, ps = [], []
        for _ in range(steps):
            p, s, m = mgd.step(p, s, BATCH)
            cts.append(m["c_tilde"].item())
            ps.append(_flat(p))
    return np.array(cts, np.float32), np.stack(ps)


@pytest.mark.parametrize("sigma_theta", [0.0, 0.01])
def test_sim_farm_trajectory_matches_reference(sigma_theta):
    """The 3-chip SimulatedAnalogChip farm of ``test_farm.py``'s
    determinism test, port against reference from the same converted
    params: bitwise against the reference's eager step; within the MLP
    tolerances against its jitted step, whose FMA-contracted update
    lands a few ulps away."""
    kw = dict(sigma_a=0.1, sigma_theta=sigma_theta, sigma_c=1e-3)
    ct, ps = _port_farm_run(10, **kw)
    ct_e, ps_e = _reference_farm_run(10, eager=True, **kw)
    np.testing.assert_array_equal(ct, ct_e)
    np.testing.assert_array_equal(ps, ps_e)
    ct_j, ps_j = _reference_farm_run(10, eager=False, **kw)
    assert ct[0] == ct_j[0]                    # before any update
    np.testing.assert_allclose(ct, ct_j, atol=CT_ATOL)
    np.testing.assert_allclose(ps, ps_j, atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# ChipFarm + the probe_parallel_external driver
# ---------------------------------------------------------------------------


def test_farm_driver_trains_and_counts_writes():
    farm = simulated_chip_farm(4, (2, 2, 1), base_seed=0, sigma_a=0.1,
                               sigma_theta=0.005, sigma_c=1e-4)
    cfg = DriverConfig(dtheta=2e-2, eta=0.5, mode="central", seed=0)
    mgd = driver("probe_parallel_external", cfg, plant=farm, device="cpu")
    p, s = _params(), mgd.init(_params())
    costs = []
    n = 60
    for _ in range(n):
        p, s, m = mgd.step(p, s, BATCH)
        costs.append(m["cost"].item())
    assert np.isfinite(costs).all()
    assert s.step == n
    # per step: 1 pair write + 1 update write, on each of the 4 chips
    assert farm.total_writes == 2 * n * 4
    assert np.mean(costs[-10:]) < np.mean(costs[:10])


def test_farm_trajectories_bit_identical_across_runs():
    """pod_seed-keyed probes + counter-keyed readout noise: two fresh,
    identically-seeded farm runs walk the same f32 trajectory bit for
    bit — the thread schedule cannot perturb it."""
    kw = dict(sigma_a=0.1, sigma_theta=0.01, sigma_c=1e-3)
    ct_a, p_a = _port_farm_run(10, **kw)
    ct_b, p_b = _port_farm_run(10, **kw)
    np.testing.assert_array_equal(ct_a, ct_b)
    np.testing.assert_array_equal(p_a, p_b)


def test_farm_variance_decreases_with_k():
    """The averaged error signal is k independent probe estimates: its
    variance at frozen params drops ≈1/k (k=4 ≤ 0.55× the k=1 var)."""
    p = _params(3)
    cfg = DriverConfig(dtheta=1e-2, eta=1.0, mode="central", seed=0)

    def ghat_var(k, rounds=48):
        # matched chips (no defects/write noise): the averaged estimator
        # is k iid probe estimates, so the 1/k law is clean
        farm = simulated_chip_farm(k, (2, 2, 1), base_seed=0, sigma_a=0.0,
                                   sigma_theta=0.0, sigma_c=1e-3)
        mgd = driver("probe_parallel_external", cfg, plant=farm,
                     device="cpu")
        s0 = mgd.init(p)
        w0 = tree_leaves(p)[1][0, 0].item()
        samples = []
        for t in range(rounds):
            p1, _, _ = mgd.step(p, replace_step(s0, t), BATCH)
            samples.append(tree_leaves(p1)[1][0, 0].item() - w0)
        return float(np.var(samples))

    v1, v4 = ghat_var(1), ghat_var(4)
    assert v4 < 0.55 * v1, (v1, v4)


def test_train_mgd_farm_checkpoint_resume(tmp_path):
    """Resume == uninterrupted through the step-by-step loop: the farm
    state (the ProbeParallelState counter) checkpoints generically and
    counter-keyed chip noise replays (σ_θ = 0 chips: the only live-RNG
    stream is silent)."""
    def loop(**kw):
        farm = simulated_chip_farm(2, (2, 2, 1), base_seed=1, sigma_a=0.1,
                                   sigma_theta=0.0, sigma_c=1e-3)
        return TrainLoopConfig(algorithm="probe_parallel_external",
                               plant=farm, chunk=4, log=None, **kw)

    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=4)
    p0 = _params(2)
    sample_fn = lambda i: BATCH                       # noqa: E731

    cont = train_mgd(None, p0, cfg, sample_fn, 16, loop=loop(),
                     device="cpu")
    assert cont.state.step == 16
    train_mgd(None, p0, cfg, sample_fn, 8,
              loop=loop(checkpoint_dir=str(tmp_path), checkpoint_every=8),
              device="cpu")
    res = train_mgd(None, p0, cfg, sample_fn, 16,
                    loop=loop(checkpoint_dir=str(tmp_path)), device="cpu")
    assert res.steps_done == 16
    _assert_trees_equal(cont.params, res.params)
    _assert_trees_equal(cont.state, res.state)


def test_train_mgd_logs_fault_summary():
    """A fault-tolerant farm that survived faults says so once, at the
    end of ``train_mgd``."""
    from repro_torch.hardware import FaultPolicy, FaultSpec
    farm = simulated_chip_farm(
        2, (2, 2, 1), base_seed=1, sigma_theta=0.0, sigma_c=1e-3,
        faults=FaultSpec(fail_attempts=1),
        fault_policy=FaultPolicy(timeout_s=10.0, retries=2,
                                 backoff_s=0.001, backoff_max_s=0.001))
    lines = []
    train_mgd(None, _params(), DriverConfig(dtheta=1e-2, eta=0.5,
                                            mode="central", seed=0),
              lambda i: BATCH, 4,
              loop=TrainLoopConfig(algorithm="probe_parallel_external",
                                   plant=farm, chunk=2, log=lines.append),
              device="cpu")
    summary = [ln for ln in lines if "fault-tolerance summary" in ln]
    assert len(summary) == 1 and "inject-transient" in summary[0]


def test_farm_runs_on_the_params_device_with_numpy_chips():
    """The costs come back as tensors on the params' device; the chips
    saw host numpy (float32) params and batches."""
    seen = []

    class Probe(PairDevice):
        def set_params(self, params):
            seen.append(type(tree_leaves(params)[0]))
            super().set_params(params)

    farm = ChipFarm([Probe(), Probe()])
    p = _params()
    thetas = [tree_map(lambda x: 0.01 * torch.ones_like(x), p)
              for _ in range(2)]
    costs, valid = farm.read_cost_pairs(p, thetas, BATCH, step=0)
    assert costs.shape == (2, 2) and costs.dtype == torch.float32
    assert valid.dtype == torch.bool and bool(valid.all())
    assert seen == [np.ndarray, np.ndarray]
    assert farm.pipeline_stats()["copy_s"] > 0


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def test_farm_has_no_single_chip_read():
    farm = simulated_chip_farm(2, (2, 2, 1))
    with pytest.raises(NotImplementedError, match="probe_parallel_external"):
        farm.read_cost(_params(), BATCH, step=0)


def test_farm_rejects_empty_and_bad_devices():
    with pytest.raises(ValueError, match="at least one"):
        ChipFarm([])
    with pytest.raises(TypeError, match="set_params"):
        ChipFarm([object()])
    with pytest.raises(ValueError, match="at least one chip"):
        simulated_chip_farm(0)


@pytest.mark.parametrize("build,match", [
    (lambda farm: driver("probe_parallel_external",
                         DriverConfig(mode="central"), device="cpu"),
     "ChipFarm"),
    (lambda farm: driver("probe_parallel_external",
                         DriverConfig(mode="central"), plant=farm,
                         mesh="mesh", device="cpu"),
     "host-side"),
    (lambda farm: driver("probe_parallel_external",
                         DriverConfig(mode="central"), lambda p, b: 0.0,
                         plant=farm, device="cpu"),
     "cost oracle"),
    (lambda farm: driver("probe_parallel_external", DriverConfig(),
                         plant=farm, device="cpu"),
     "central"),
    (lambda farm: driver("probe_parallel_external",
                         DriverConfig(mode="central", probes=4), plant=farm,
                         device="cpu"),
     "farm size"),
    (lambda farm: driver("probe_parallel_external",
                         DriverConfig(mode="central", tau_theta=4),
                         plant=farm, device="cpu"),
     "tau_theta=1"),
    (lambda farm: driver("probe_parallel_external",
                         DriverConfig(mode="central"), plant=farm,
                         probe_fn=lambda *a: None, device="cpu"),
     "fused"),
])
def test_farm_driver_validation(build, match):
    farm = simulated_chip_farm(2, (2, 2, 1))
    with pytest.raises((ValueError, TypeError), match=match):
        build(farm)
