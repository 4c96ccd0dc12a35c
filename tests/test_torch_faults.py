"""The port's fault-tolerant host boundary: injection, retries, masking,
quarantine — twins of ``tests/test_faults.py``.

Load-bearing, as in the reference:
* ``FaultyChip`` injects counter-keyed, bit-reproducible faults and
  mirrors the wrapped device's capability surface;
* retries under a ``FaultPolicy`` never reorder or duplicate the
  (step, tag) counter stream the inner device sees, so a transient
  fault healed by a retry leaves the trajectory BIT-IDENTICAL to the
  fault-free run;
* a chip that exhausts its retries is masked (``valid[k]=False``, NaN
  costs) instead of failing the step, and the masked average applies
  the η-rescaling rule exactly;
* quarantine gates the probe path only; readmission leaves the chip's
  counter-keyed noise stream untouched;
* a hung chip stalls a step by at most the configured timeout, and
  farm checkpoint/resume stays bit-exact through injected faults.

The fault engine is the reference's own code (numpy), so the fault
schedule of a seed is the reference's too (checked below).
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.hardware import FaultSpec as JFaultSpec
from repro.hardware import FaultyChip as JFaultyChip
from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.api import DriverConfig, driver
from repro_torch.core import perturbations as pert
from repro_torch.core import probe_parallel as pp
from repro_torch.core.utils import tree_leaves, tree_map
from repro_torch.hardware import (ChipFaultError, ChipFarm, ExternalPlant,
                                  FaultLog, FaultPolicy, FaultSpec,
                                  FaultyChip, SimulatedAnalogChip,
                                  simulated_chip_farm)
from repro_torch.training import TrainLoopConfig, train_mgd

X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
Y = np.array([[0.], [1.], [1.], [0.]], np.float32)
BATCH = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
NP_BATCH = {"x": X, "y": Y}


def _params(seed=0, sizes=(2, 2, 1)):
    p = jmlp_init(jax.random.PRNGKey(seed), sizes)
    return convert.to_torch(jax.tree_util.tree_map(np.asarray, p),
                            device="cpu")


def _assert_trees_equal(a, b):
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(la, torch.Tensor):
            assert torch.equal(la, lb)
        else:
            assert la == lb


def _thetas(p, k):
    return [tree_map(lambda x: 0.01 * torch.ones_like(x), p)
            for _ in range(k)]


@pytest.fixture(autouse=True)
def _close_plants(monkeypatch):
    """Close every farm/plant a test builds.  Their backends own worker
    threads and processes, which the conftest leak sentinel fails the
    suite for; ``close()`` is idempotent."""
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


#: Fast-failing policy for tests — real backoffs would slow the suite.
def _policy(**kw):
    base = dict(timeout_s=10.0, retries=2, backoff_s=0.001,
                backoff_factor=1.0, backoff_max_s=0.001)
    base.update(kw)
    return FaultPolicy(**base)


class PairDevice:
    """Counter-capable device with a differential probe line; cost is a
    deterministic function of the stored parameters."""

    def __init__(self):
        self.writes = 0
        self.calls = []          # (step, tag) per measure_cost
        self.pair_calls = []     # (step, tag) per measure_pair
        self._params = None

    def set_params(self, params):
        self.writes += 1
        self._params = tree_map(lambda w: np.asarray(w, np.float32), params)

    def _cost(self, params):
        return float(sum(np.sum(leaf * leaf) for leaf in
                         tree_leaves(params)))

    def measure_cost(self, batch, *, step=None, tag=None):
        self.calls.append((step, tag))
        return self._cost(self._params)

    def measure_pair(self, theta, batch, *, step=None, tag=None):
        self.pair_calls.append((step, tag))
        plus = tree_map(lambda w, t: w + np.asarray(t, np.float32),
                        self._params, theta)
        minus = tree_map(lambda w, t: w - np.asarray(t, np.float32),
                         self._params, theta)
        return self._cost(plus), self._cost(minus)


class CrashingDevice(PairDevice):
    """Raises from every counter-carrying readout."""

    def measure_cost(self, batch, *, step=None, tag=None):
        raise ValueError("instrument driver crashed")

    def measure_pair(self, theta, batch, *, step=None, tag=None):
        raise ValueError("instrument driver crashed")


def _theta_and_c(device, params, cfg, k):
    """Chip k's perturbation tree and deterministic C̃_k, host-side."""
    theta = convert.to_numpy(pert.generate(
        params, ptype=cfg.ptype, step=0, seed=pp.pod_seed(cfg.seed, k),
        dtheta=cfg.dtheta, tau_p=cfg.tau_p))
    c_plus, c_minus = device.measure_pair(theta, NP_BATCH)
    device.pair_calls.pop()      # undo the bookkeeping of this probe
    return theta, 0.5 * (c_plus - c_minus)


# ---------------------------------------------------------------------------
# Validation + injection determinism
# ---------------------------------------------------------------------------


def test_faultspec_validation():
    with pytest.raises(ValueError, match="sum"):
        FaultSpec(transient=0.7, nan=0.6)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        FaultSpec(hang=1.5)
    with pytest.raises(ValueError, match="fail_attempts"):
        FaultSpec(fail_attempts=-1)


def test_faultpolicy_validation():
    with pytest.raises(ValueError, match="timeout_s"):
        FaultPolicy(timeout_s=0.0)
    with pytest.raises(ValueError, match="retries"):
        FaultPolicy(retries=-1)
    with pytest.raises(ValueError, match="aggregate"):
        FaultPolicy(aggregate="median")
    with pytest.raises(ValueError, match="trim_frac"):
        FaultPolicy(trim_frac=0.5)


def test_faulty_chip_requires_device_surface():
    with pytest.raises(TypeError, match="set_params"):
        FaultyChip(object())


def test_faulty_chip_zero_spec_passthrough_and_mirroring():
    """An empty FaultSpec is a transparent wrapper: identical readouts,
    identical capability surface (pair line, counters, accuracy)."""
    inner = SimulatedAnalogChip((2, 2, 1), seed=7, sigma_a=0.1,
                                sigma_theta=0.0, sigma_c=1e-3)
    twin = SimulatedAnalogChip((2, 2, 1), seed=7, sigma_a=0.1,
                               sigma_theta=0.0, sigma_c=1e-3)
    chip = FaultyChip(inner, FaultSpec(), seed=1)
    p = convert.to_numpy(_params())
    chip.set_params(p, step=0)
    twin.set_params(p)
    assert chip.measure_cost(NP_BATCH, step=3, tag=1) == \
        twin.measure_cost(NP_BATCH, step=3, tag=1)
    assert callable(getattr(chip, "measure_pair", None))
    assert callable(getattr(chip, "measure_accuracy", None))
    theta = tree_map(lambda x: 0.01 * np.ones_like(x), p)
    assert chip.measure_pair(theta, NP_BATCH, step=0, tag=0) == \
        twin.measure_pair(theta, NP_BATCH, step=0, tag=0)
    # a bare 2-method device must NOT grow a pair line through the wrapper
    class TwoMethod:
        def set_params(self, p):
            pass

        def measure_cost(self, b):
            return 0.0
    assert not callable(getattr(FaultyChip(TwoMethod()), "measure_pair",
                                None))


def test_fault_schedule_matches_reference():
    """The same fault seed injects the reference's fault schedule: the
    fault engine's draws are numpy's, keyed (seed, step, tag, attempt)."""
    def schedule(cls, spec_cls):
        chip = cls(PairDevice(), spec_cls(transient=0.2, nan=0.1, inf=0.1,
                                          stuck=0.1, outlier=0.1),
                   seed=11)
        p = convert.to_numpy(_params())
        theta = tree_map(lambda x: 0.01 * np.ones_like(x), p)
        chip.set_params(p)
        out = []
        for step in range(60):
            for _ in range(2):          # a retry draws afresh
                try:
                    out.append(repr(chip.measure_pair(theta, NP_BATCH,
                                                      step=step, tag=2)))
                except Exception as e:          # noqa: BLE001
                    out.append(type(e).__name__)
        return out

    assert schedule(FaultyChip, FaultSpec) == \
        schedule(JFaultyChip, JFaultSpec)


def test_fault_injection_counter_keyed():
    """Two identically-seeded FaultyChips inject the identical fault
    schedule; a different fault seed draws a different one."""
    def schedule(fault_seed):
        log = FaultLog()
        chip = FaultyChip(PairDevice(), FaultSpec(transient=0.3, nan=0.2),
                          seed=fault_seed, log=log)
        chip.set_params(_params())
        out = []
        for step in range(40):
            try:
                c = chip.measure_cost(BATCH, step=step, tag=0)
                out.append("nan" if np.isnan(c) else "ok")
            except Exception:
                out.append("raise")
        return out

    a, b = schedule(11), schedule(11)
    assert a == b
    assert "raise" in a and "nan" in a
    assert schedule(12) != a


# ---------------------------------------------------------------------------
# Retries: counter-stream and trajectory invariance
# ---------------------------------------------------------------------------


def test_retry_preserves_counter_stream_and_trajectory():
    """fail_attempts=1 fails every first attempt; the retry succeeds.
    The inner device must see EXACTLY the clean run's (step, tag)
    stream — no reorders, no duplicates — and the trajectory must be
    bit-identical to the fault-free farm's."""
    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=2)

    def run(faulty):
        inner = [PairDevice(), PairDevice()]
        devices = list(inner)
        if faulty:
            devices[1] = FaultyChip(inner[1], FaultSpec(fail_attempts=1),
                                    seed=0)
        farm = ChipFarm(devices, fault_policy=_policy())
        mgd = driver("probe_parallel_external", cfg, plant=farm,
                     device="cpu")
        p, s = _params(1), mgd.init(_params(1))
        for _ in range(6):
            p, s, m = mgd.step(p, s, BATCH)
            assert int(m["n_valid"]) == 2
        return p, inner

    p_clean, inner_clean = run(faulty=False)
    p_fault, inner_fault = run(faulty=True)
    _assert_trees_equal(p_clean, p_fault)
    assert inner_fault[1].pair_calls == inner_clean[1].pair_calls
    assert inner_fault[0].pair_calls == inner_clean[0].pair_calls


def test_exhausted_chip_masked_not_raised():
    """A chip that fails every attempt is masked: fixed-shape NaN costs
    + valid=False, no exception through the callback."""
    devices = [PairDevice(), CrashingDevice(), PairDevice()]
    farm = ChipFarm(devices, fault_policy=_policy(retries=1))
    p = _params()
    thetas = _thetas(p, 3)
    costs, valid = farm.read_cost_pairs(p, thetas, BATCH, step=0)
    assert list(np.asarray(valid)) == [True, False, True]
    assert np.isnan(np.asarray(costs)[1]).all()
    assert np.isfinite(np.asarray(costs)[[0, 2]]).all()
    assert farm.fault_summary()["events"] > 0
    assert farm.health.chips[1].failures == 1
    assert farm.health.chips[1].attempts_failed == 2


def test_masked_average_is_eta_rescale():
    """With chip 1 dead, the update must be exactly the surviving chip's
    term at the UNCHANGED per-chip coefficient −η/(k·Δθ²) — i.e. the
    η·k_live/k-rescaled masked average."""
    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=3)
    healthy = PairDevice()
    farm = ChipFarm([healthy, CrashingDevice()],
                    fault_policy=_policy(retries=0))
    mgd = driver("probe_parallel_external", cfg, plant=farm,
                 device="cpu")
    p0 = _params(4)
    # expected: θ̃_0 and C̃_0 computed host-side from the deterministic
    # device, applied with coef = −η/(k·Δθ²)·C̃_0
    probe = PairDevice()
    probe.set_params(p0)
    theta0, c0 = _theta_and_c(probe, p0, mgd.config, 0)
    coef = -cfg.eta / (cfg.dtheta ** 2) * c0 / 2
    expected = tree_map(
        lambda w, t: w.numpy() + np.float32(coef) * np.asarray(t,
                                                               np.float32),
        p0, theta0)
    p1, _, m = mgd.step(p0, mgd.init(p0), BATCH)
    assert int(m["n_valid"]) == 1 and int(m["n_used"]) == 1
    for got, want in zip(tree_leaves(p1), tree_leaves(expected)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Quarantine / readmission
# ---------------------------------------------------------------------------


def test_quarantine_skips_io_then_readmits_with_noise_stream_intact():
    """Chip 1 fails hard for steps 0–5: three exhausted rounds quarantine
    it (steps 3–5 cost NO device I/O), the step-6 re-probe readmits it,
    and its counter-keyed readouts after readmission are identical to a
    never-quarantined twin's."""
    def chips():
        return [SimulatedAnalogChip((2, 2, 1), seed=s, sigma_a=0.1,
                                    sigma_theta=0.0, sigma_c=1e-2)
                for s in (0, 1)]

    inner = chips()
    sick = FaultyChip(inner[1], FaultSpec(transient=1.0, only_steps=(0, 6)),
                      seed=0)
    farm = ChipFarm([inner[0], sick],
                    fault_policy=_policy(retries=0, quarantine_after=3,
                                         reprobe_every=4))
    twin = ChipFarm(chips())
    p = _params()
    thetas = _thetas(p, 2)

    h = farm.health.chips[1]
    valid_log = []
    for step in range(8):
        _, valid = farm.read_cost_pairs(p, thetas, BATCH, step=step)
        valid_log.append(bool(np.asarray(valid)[1]))
        if step == 2:
            assert h.quarantined and h.next_reprobe == 6
            readouts_at_quarantine = sick.readouts
        if step in (3, 4, 5):    # fast path: no I/O on the sick chip
            assert sick.readouts == readouts_at_quarantine
    assert valid_log == [False] * 6 + [True, True]
    assert not h.quarantined and h.readmissions == 1
    assert farm.fault_summary()["by_kind"]["quarantine"] == 1
    assert farm.fault_summary()["by_kind"]["readmit"] == 1
    # the noise stream is (step, tag)-keyed, not read-count-keyed: the
    # readmitted chip reads exactly what the never-quarantined twin reads
    costs_a, _ = farm.read_cost_pairs(p, thetas, BATCH, step=9)
    costs_b, _ = twin.read_cost_pairs(p, thetas, BATCH, step=9)
    np.testing.assert_array_equal(np.asarray(costs_a)[1],
                                  np.asarray(costs_b)[1])


# ---------------------------------------------------------------------------
# Hangs + default-timeout error context
# ---------------------------------------------------------------------------


def test_hung_chip_stalls_at_most_timeout():
    """A hang at step 1 costs ≤ timeout_s (plus slack), not hang_s, and
    the hung chip is masked while the others answer."""
    inner = [PairDevice(), PairDevice(), PairDevice()]
    hung = FaultyChip(inner[0], FaultSpec(hang=1.0, hang_s=0.6,
                                          only_steps=(1, 2)), seed=0)
    farm = ChipFarm([hung, inner[1], inner[2]],
                    fault_policy=_policy(timeout_s=0.1, retries=0))
    p = _params()
    thetas = _thetas(p, 3)
    farm.read_cost_pairs(p, thetas, BATCH, step=0)
    t0 = time.monotonic()
    _, valid = farm.read_cost_pairs(p, thetas, BATCH, step=1)
    stall = time.monotonic() - t0
    assert stall < 0.5, f"hung chip stalled the step {stall:.2f}s"
    assert list(np.asarray(valid)) == [False, True, True]
    assert farm.health.chips[0].timeouts == 1


def test_no_policy_gather_names_the_failing_chip():
    farm = ChipFarm([PairDevice(), CrashingDevice()])
    p = _params()
    thetas = _thetas(p, 2)
    with pytest.raises(Exception, match="chip 1.*CrashingDevice"):
        farm.read_cost_pairs(p, thetas, BATCH, step=0)


def test_no_policy_write_names_the_failing_chip():
    class BadWriter(PairDevice):
        def set_params(self, params):
            raise OSError("bus error")
    farm = ChipFarm([PairDevice(), BadWriter()])
    with pytest.raises(Exception, match="chip 1.*BadWriter"):
        farm.write_params(_params(), step=0)


# ---------------------------------------------------------------------------
# Robust aggregation
# ---------------------------------------------------------------------------


def test_mad_rejects_silent_outlier():
    """A stuck-at chip raises no exception — only the MAD gate over the
    gathered scalars can reject it (n_valid=4, n_used=3)."""
    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=0)
    inner = [PairDevice() for _ in range(4)]
    devices = list(inner)
    devices[2] = FaultyChip(inner[2],
                            FaultSpec(stuck=1.0, stuck_value=1000.0), seed=0)
    farm = ChipFarm(devices, fault_policy=_policy(aggregate="mad",
                                                  mad_threshold=6.0))
    mgd = driver("probe_parallel_external", cfg, plant=farm,
                 device="cpu")
    p, s = _params(), mgd.init(_params())
    p, s, m = mgd.step(p, s, BATCH)
    assert int(m["n_valid"]) == 4
    assert int(m["n_used"]) == 3


def test_trimmed_chip_mask_unit():
    c = torch.tensor([0.0, 1.0, 2.0, 3.0, 100.0])
    valid = torch.ones(5, dtype=torch.bool)
    mask = pp._trimmed_chip_mask(c, valid, 0.2)
    assert mask.tolist() == [False, True, True, True, False]
    # an invalid chip counts as neither kept nor trimmed
    valid[1] = False
    mask = pp._trimmed_chip_mask(c, valid, 0.26)  # ⌊0.26·4⌋ = 1 a side
    assert mask.tolist() == [False, False, True, True, False]


# ---------------------------------------------------------------------------
# ExternalPlant (single chip)
# ---------------------------------------------------------------------------


def test_external_plant_retries_transparent():
    """fail_attempts under a retry policy: the read succeeds and equals
    the clean device's counter-keyed readout exactly."""
    inner = SimulatedAnalogChip((2, 2, 1), seed=5, sigma_a=0.1,
                                sigma_theta=0.0, sigma_c=1e-2)
    twin = SimulatedAnalogChip((2, 2, 1), seed=5, sigma_a=0.1,
                               sigma_theta=0.0, sigma_c=1e-2)
    plant = ExternalPlant(FaultyChip(inner, FaultSpec(fail_attempts=1)),
                          fault_policy=_policy())
    clean = ExternalPlant(twin)
    p = _params()
    a = plant.read_cost(p, BATCH, step=4, tag=1)
    b = clean.read_cost(p, BATCH, step=4, tag=1)
    assert float(a) == float(b)
    assert plant.fault_summary()["events"] > 0
    assert plant.meta.fault_tolerant


def test_external_plant_exhaustion_and_no_policy_context():
    sick = FaultyChip(PairDevice(), FaultSpec(transient=1.0), seed=0,
                      name="flaky-dut")
    sick_plant = ExternalPlant(sick, fault_policy=_policy(retries=1))
    p = _params()
    with pytest.raises(Exception, match="flaky-dut.*2 attempts"):
        sick_plant.read_cost(p, BATCH, step=0, tag=0)
    bare = ExternalPlant(CrashingDevice())
    with pytest.raises(Exception, match="CrashingDevice"):
        bare.read_cost(p, BATCH, step=0, tag=0)


def test_bad_fault_policy_type_rejected():
    with pytest.raises(TypeError, match="FaultPolicy"):
        ExternalPlant(PairDevice(), fault_policy="retry")
    with pytest.raises(TypeError, match="FaultPolicy"):
        ChipFarm([PairDevice()], fault_policy=3)


# ---------------------------------------------------------------------------
# measure_accuracy step forwarding (eval writes on drifting chips)
# ---------------------------------------------------------------------------


def test_measure_accuracy_forwards_step():
    class EvalDevice(PairDevice):
        def __init__(self):
            super().__init__()
            self.write_steps = []
            self.acc_steps = []

        def set_params(self, params, *, step=None):
            self.write_steps.append(step)
            super().set_params(params)

        def measure_accuracy(self, batch, *, step=None):
            self.acc_steps.append(step)
            return 0.5

    devices = [EvalDevice(), EvalDevice()]
    farm = ChipFarm(devices)
    acc = farm.measure_accuracy(_params(), BATCH, step=17)
    assert acc == 0.5
    for d in devices:
        assert d.write_steps[-1] == 17
        assert d.acc_steps == [17]
    # default step=None keeps the historical behaviour (no timestamp)
    farm.measure_accuracy(_params(), BATCH)
    for d in devices:
        assert d.write_steps[-1] is None
        assert d.acc_steps[-1] is None


def test_measure_accuracy_skips_quarantined_chips():
    inner = [SimulatedAnalogChip((2, 2, 1), seed=s, sigma_a=0.1,
                                 sigma_theta=0.0, sigma_c=1e-3)
             for s in (0, 1)]
    sick = FaultyChip(inner[1], FaultSpec(transient=1.0), seed=0)
    farm = ChipFarm([inner[0], sick],
                    fault_policy=_policy(retries=0, quarantine_after=1))
    solo = ChipFarm([SimulatedAnalogChip((2, 2, 1), seed=0, sigma_a=0.1,
                                         sigma_theta=0.0, sigma_c=1e-3)])
    p = _params()
    thetas = _thetas(p, 2)
    farm.read_cost_pairs(p, thetas, BATCH, step=0)
    assert farm.health.chips[1].quarantined
    assert farm.measure_accuracy(p, BATCH) == solo.measure_accuracy(p, BATCH)


# ---------------------------------------------------------------------------
# Checkpoint/resume bit-exactness through faults
# ---------------------------------------------------------------------------


def test_farm_resume_bitexact_through_faults(tmp_path):
    """Resume == uninterrupted with transient faults injected at the
    same counter-keyed steps and healed by retries (σ_θ = 0: the only
    live-RNG stream is silent)."""
    def farm():
        return simulated_chip_farm(
            2, (2, 2, 1), base_seed=1, sigma_a=0.1, sigma_theta=0.0,
            sigma_c=1e-3, faults=FaultSpec(transient=0.15), fault_seed=42,
            fault_policy=_policy(retries=3))

    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=4)
    p0 = _params(2)
    sample_fn = lambda i: BATCH                       # noqa: E731

    def loop(**kw):
        return TrainLoopConfig(algorithm="probe_parallel_external",
                               plant=farm(), chunk=4, log=None, **kw)

    cont = train_mgd(None, p0, cfg, sample_fn, 16, loop=loop(),
                     device="cpu")
    train_mgd(None, p0, cfg, sample_fn, 8,
              loop=loop(checkpoint_dir=str(tmp_path), checkpoint_every=8),
              device="cpu")
    res = train_mgd(None, p0, cfg, sample_fn, 16,
                    loop=loop(checkpoint_dir=str(tmp_path)), device="cpu")
    assert res.steps_done == 16
    _assert_trees_equal(cont.params, res.params)
    _assert_trees_equal(cont.state, res.state)


def test_clean_path_bit_identical_with_and_without_policy():
    """Arming a policy over healthy chips must not move the trajectory:
    where(True, C̃, 0) ≡ C̃ bitwise and the fori body is unchanged."""
    cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=2)

    def run(policy):
        farm = simulated_chip_farm(3, (2, 2, 1), base_seed=5, sigma_a=0.1,
                                   sigma_theta=0.01, sigma_c=1e-3,
                                   fault_policy=policy)
        mgd = driver("probe_parallel_external", cfg, plant=farm,
                     device="cpu")
        p, s = _params(1), mgd.init(_params(1))
        for _ in range(8):
            p, s, _ = mgd.step(p, s, BATCH)
        return p

    _assert_trees_equal(run(None), run(_policy()))
