"""The port's farm execution backends: parity, pipelining, lifecycle,
faults — twins of ``tests/test_backends.py``.

A backend only moves WHERE a chip transaction runs, never what it
computes:

* serial / thread / process / cluster-loopback farms walk the
  bit-identical trajectory (σ_θ = 0 so the only RNG streams are
  counter-keyed), pipelined or not;
* checkpoint/resume stays bit-exact through a double-buffered boundary;
* the fault suite holds under the process backend: retry-healed runs
  are bit-exact against fault-free ones, quarantine/readmission works
  with worker-local fault events shipped back host-side, and a hung
  worker is KILLED and respawned within the policy timeout;
* farms are context managers with idempotent ``close()`` and leak
  neither threads nor worker processes across many builds;
* ``DeviceSpec`` / the cluster wire protocol round-trip devices
  faithfully.

The process backend forks: the workers run the numpy chips only and
never touch a tensor.
"""
import multiprocessing
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.models.simple import mlp_init as jmlp_init
from repro_torch import convert
from repro_torch.api import DriverConfig, driver
from repro_torch.core.utils import tree_leaves, tree_map
from repro_torch.hardware import (ChipFarm, DeviceSpec, FaultPolicy,
                                  FaultSpec, SimulatedAnalogChip,
                                  simulated_chip_farm)
from repro_torch.hardware.backend import (ClusterStubBackend,
                                          ProcessBackend, SerialBackend,
                                          loopback_transport, make_backend)
from repro_torch.training import TrainLoopConfig, train_mgd

X = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]], np.float32)
Y = np.array([[0.], [1.], [1.], [0.]], np.float32)
BATCH = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
NP_BATCH = {"x": X, "y": Y}
SIZES = (2, 2, 1)


def _params(seed=1):
    p = jmlp_init(jax.random.PRNGKey(seed), SIZES)
    return convert.to_torch(jax.tree_util.tree_map(np.asarray, p),
                            device="cpu")


def _policy(**kw):
    base = dict(timeout_s=10.0, retries=2, backoff_s=0.001,
                backoff_factor=1.0, backoff_max_s=0.001)
    base.update(kw)
    return FaultPolicy(**base)


def _assert_trees_equal(a, b, msg=""):
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(la, torch.Tensor):
            assert torch.equal(la, lb), msg
        else:
            assert la == lb, msg


def _thetas(p, k):
    return [tree_map(lambda x: 0.01 * torch.ones_like(x), p)
            for _ in range(k)]


def _loopback(**kw):
    """A cluster-stub backend over the loopback transport, for the 3-chip
    farm ``_trajectory`` builds (the node-side devices are built from the
    same specs ``simulated_chip_farm`` hands the farm)."""
    specs = [DeviceSpec(SimulatedAnalogChip, (SIZES,),
                        dict(seed=5 + i, sigma_a=0.1, sigma_theta=0.0,
                             sigma_c=1e-3, py_busy_ms=0.0))
             for i in range(3)]
    return ClusterStubBackend(transport=loopback_transport(specs))


def _trajectory(backend, pipeline=False, n=6, **farm_kw):
    kw = dict(base_seed=5, sigma_a=0.1, sigma_theta=0.0, sigma_c=1e-3)
    kw.update(farm_kw)
    with simulated_chip_farm(3, SIZES, backend=backend,
                             pipeline=pipeline, **kw) as farm:
        cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=2)
        mgd = driver("probe_parallel_external", cfg, plant=farm,
                     device="cpu")
        p, s = _params(), mgd.init(_params())
        cts = []
        for _ in range(n):
            p, s, m = mgd.step(p, s, BATCH)
            cts.append(m["c_tilde"].item())
        farm.fence()
        writes = farm.total_writes
    return p, np.array(cts), writes


# ---------------------------------------------------------------------------
# Cross-backend bit-exactness
# ---------------------------------------------------------------------------


def test_backends_bit_exact_parity():
    """serial, thread and process farms (pipelined or not) produce the
    bit-identical cost stream, trajectory AND device write counts — a
    backend moves execution, nothing else."""
    ref_p, ref_ct, ref_w = _trajectory("serial")
    for backend in ("thread", "process"):
        for pipeline in (False, True):
            p, ct, w = _trajectory(backend, pipeline)
            tag = f"{backend} pipeline={pipeline}"
            np.testing.assert_array_equal(ref_ct, ct, err_msg=tag)
            _assert_trees_equal(ref_p, p, tag)
            assert w == ref_w, tag


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["plain", "pipelined"])
def test_cluster_loopback_trajectory_bit_exact(pipeline):
    """The cluster stub over the loopback wire (pickle request → node
    dispatch → pickle reply) walks the serial farm's trajectory bit for
    bit, write counts included."""
    ref_p, ref_ct, ref_w = _trajectory("serial")
    p, ct, w = _trajectory(_loopback(), pipeline)
    np.testing.assert_array_equal(ref_ct, ct)
    _assert_trees_equal(ref_p, p)
    assert w == ref_w


def test_backend_instance_passthrough_and_unknown_name():
    be = SerialBackend()
    assert make_backend(be) is be
    with pytest.raises(ValueError, match="unknown farm backend"):
        make_backend("quantum")
    with pytest.raises(TypeError, match="name or FarmBackend"):
        make_backend(42)


# ---------------------------------------------------------------------------
# Double-buffered pipeline: fence + resume
# ---------------------------------------------------------------------------


def test_pipeline_resume_bitexact(tmp_path):
    """Checkpoint/resume through a double-buffered farm == the
    uninterrupted non-pipelined run: the fence drains in-flight writes
    at the boundary, and counter-keyed noise makes the overlap schedule
    value-invisible."""
    def run(steps, pipeline, ckpt_dir=None, ckpt_every=0):
        farm = simulated_chip_farm(2, SIZES, base_seed=1, sigma_a=0.1,
                                   sigma_theta=0.0, sigma_c=1e-3,
                                   backend="thread", pipeline=pipeline)
        cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=4)
        res = train_mgd(None, _params(2), cfg, lambda i: BATCH, steps,
                        loop=TrainLoopConfig(
                            algorithm="probe_parallel_external", plant=farm,
                            chunk=4, log=None, checkpoint_dir=ckpt_dir,
                            checkpoint_every=ckpt_every), device="cpu")
        farm.close()
        return res

    cont = run(16, pipeline=False)
    run(8, pipeline=True, ckpt_dir=str(tmp_path), ckpt_every=8)
    res = run(16, pipeline=True, ckpt_dir=str(tmp_path))
    assert res.steps_done == 16
    _assert_trees_equal(cont.params, res.params)
    _assert_trees_equal(cont.state, res.state)


def test_pipeline_stats_reports_utilization():
    with simulated_chip_farm(2, SIZES, base_seed=0, py_busy_ms=2.0,
                             backend="thread", pipeline=True) as farm:
        cfg = DriverConfig(dtheta=1e-2, eta=0.5, mode="central", seed=0)
        mgd = driver("probe_parallel_external", cfg, plant=farm,
                     device="cpu")
        p, s = _params(), mgd.init(_params())
        for _ in range(4):
            p, s, _ = mgd.step(p, s, BATCH)
        farm.fence()
        stats = farm.pipeline_stats()
    assert stats["pipeline"] is True and stats["chips"] == 2
    assert stats["busy_s"] > 0 and stats["wall_s"] > 0
    assert 0.0 < stats["utilization"] <= 1.2   # clock-skew slack


# ---------------------------------------------------------------------------
# The fault suite under the process backend
# ---------------------------------------------------------------------------


def test_process_retry_heal_bitexact():
    """fail_attempts=1 fails every first attempt in the WORKER process;
    the host retry re-runs the transaction against the respawn-free
    worker and the trajectory stays bit-identical to the fault-free
    farm's (the fault-tolerance gate's abs=0.0, across a process
    boundary)."""
    def run(faults):
        p, ct, _ = _trajectory("process", faults=faults, fault_seed=42,
                               fault_policy=_policy())
        return p, ct

    p_clean, ct_clean = run(None)
    p_fault, ct_fault = run(FaultSpec(fail_attempts=1))
    np.testing.assert_array_equal(ct_clean, ct_fault)
    _assert_trees_equal(p_clean, p_fault)


def test_process_quarantine_readmits_and_ships_events():
    """Chip 1 fails hard for steps 0–5 inside its worker process: the
    host-side health registry quarantines it after 3 exhausted rounds,
    the step-6 re-probe readmits it, and the injected-fault events
    recorded worker-side arrive in the host FaultLog."""
    farm = simulated_chip_farm(
        2, SIZES, base_seed=0, sigma_theta=0.0, sigma_c=1e-2,
        faults=[None, FaultSpec(transient=1.0, only_steps=(0, 6))],
        fault_seed=7, backend="process",
        fault_policy=_policy(retries=0, quarantine_after=3,
                             reprobe_every=4))
    twin = simulated_chip_farm(2, SIZES, base_seed=0, sigma_theta=0.0,
                               sigma_c=1e-2, backend="serial")
    p = _params()
    h = farm.health.chips[1]
    valid_log = []
    for step in range(8):
        _, valid = farm.read_cost_pairs(p, _thetas(p, 2), BATCH, step=step)
        valid_log.append(bool(np.asarray(valid)[1]))
        if step == 2:
            assert h.quarantined and h.next_reprobe == 6
    assert valid_log == [False] * 6 + [True, True]
    assert not h.quarantined and h.readmissions == 1
    by_kind = farm.fault_summary()["by_kind"]
    assert by_kind["quarantine"] == 1 and by_kind["readmit"] == 1
    # worker-local injected-fault events shipped back with the replies:
    # steps 0-2 probe and fail; 3-5 are quarantine-skipped (no I/O)
    assert by_kind.get("inject-transient", 0) == 3
    # the readmitted chip's counter-keyed stream is untouched: it reads
    # exactly what a never-faulted serial twin reads
    costs_a, _ = farm.read_cost_pairs(p, _thetas(p, 2), BATCH, step=9)
    costs_b, _ = twin.read_cost_pairs(p, _thetas(p, 2), BATCH, step=9)
    np.testing.assert_array_equal(np.asarray(costs_a)[1],
                                  np.asarray(costs_b)[1])
    farm.close()
    twin.close()


def test_process_hang_is_killed_and_respawned():
    """A hang inside a worker process stalls the step by ~timeout_s, not
    hang_s: the worker is KILLED (not parked like the thread backend's
    zombie), and the next round runs against a respawned worker."""
    farm = simulated_chip_farm(
        2, SIZES, base_seed=0, sigma_theta=0.0, sigma_c=1e-3,
        faults=[FaultSpec(hang=1.0, hang_s=30.0, only_steps=(1, 2)), None],
        fault_seed=3, backend="process",
        fault_policy=_policy(timeout_s=0.3, retries=0))
    p = _params()
    _, valid = farm.read_cost_pairs(p, _thetas(p, 2), BATCH, step=0)
    assert list(np.asarray(valid)) == [True, True]
    t0 = time.monotonic()
    _, valid = farm.read_cost_pairs(p, _thetas(p, 2), BATCH, step=1)
    stall = time.monotonic() - t0
    assert stall < 5.0, f"hung worker stalled the step {stall:.2f}s"
    assert list(np.asarray(valid)) == [False, True]
    assert farm.health.chips[0].timeouts == 1
    # step 3 is outside the hang window: the respawned worker answers
    _, valid = farm.read_cost_pairs(p, _thetas(p, 2), BATCH, step=3)
    assert list(np.asarray(valid)) == [True, True]
    farm.close()


# ---------------------------------------------------------------------------
# DeviceSpec + spec-only backends
# ---------------------------------------------------------------------------


def test_device_spec_builds_and_validates():
    spec = DeviceSpec(SimulatedAnalogChip, (SIZES,), dict(seed=3))
    device = spec.build()
    assert isinstance(device, SimulatedAnalogChip)
    assert spec.display_name == "SimulatedAnalogChip"
    faulty = DeviceSpec(SimulatedAnalogChip, (SIZES,), dict(seed=3),
                        fault=FaultSpec(transient=0.5), fault_seed=9)
    assert faulty.display_name == "faulty:SimulatedAnalogChip:9"
    assert faulty.build().name == faulty.display_name
    with pytest.raises(TypeError, match="set_params"):
        DeviceSpec(dict)
    with pytest.raises(TypeError, match="FaultSpec"):
        DeviceSpec(SimulatedAnalogChip, (SIZES,), fault="flaky")


def test_process_backend_rejects_live_instances():
    device = SimulatedAnalogChip(SIZES, seed=0)
    with pytest.raises(TypeError, match="backend='thread'"):
        ChipFarm([device], backend="process")


# ---------------------------------------------------------------------------
# Cluster stub: wire protocol
# ---------------------------------------------------------------------------


def test_cluster_stub_refuses_to_start_without_transport():
    specs = [DeviceSpec(SimulatedAnalogChip, (SIZES,), dict(seed=0))]
    with pytest.raises(NotImplementedError, match="transport"):
        ChipFarm(specs, backend="cluster")


def test_cluster_loopback_matches_serial():
    """The full wire round trip (pickle request → node dispatch → pickle
    reply) reproduces the serial farm's costs bit-for-bit."""
    def specs():
        return [DeviceSpec(SimulatedAnalogChip, (SIZES,),
                           dict(seed=s, sigma_theta=0.0, sigma_c=1e-3))
                for s in (0, 1)]

    be = ClusterStubBackend(transport=loopback_transport(specs()))
    remote = ChipFarm(specs(), backend=be)
    local = ChipFarm(specs(), backend="serial")
    p = _params()
    for step in range(3):
        ca, _ = remote.read_cost_pairs(p, _thetas(p, 2), BATCH, step=step)
        cb, _ = local.read_cost_pairs(p, _thetas(p, 2), BATCH, step=step)
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
    remote.close()
    local.close()


def test_cluster_backend_rejects_live_instances():
    be = ClusterStubBackend(transport=lambda i, req: req)
    with pytest.raises(TypeError, match="DeviceSpec"):
        ChipFarm([SimulatedAnalogChip(SIZES, seed=0)], backend=be)


# ---------------------------------------------------------------------------
# Lifecycle hygiene: context manager, idempotent close, no leaks
# ---------------------------------------------------------------------------


def test_farm_context_manager_and_idempotent_close():
    with simulated_chip_farm(2, SIZES, base_seed=0,
                             backend="thread") as farm:
        p = _params()
        farm.read_cost_pairs(p, _thetas(p, 2), BATCH, step=0)
        assert not farm.closed
    assert farm.closed
    farm.close()                                     # second close: no-op
    with pytest.raises(Exception, match="shut down"):
        farm.read_cost_pairs(p, _thetas(p, 2), BATCH, step=1)


def _settled(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def test_many_farms_leak_no_threads_or_processes():
    """Sweeps build many farms per process; every close() must reclaim
    the backend's runner threads and worker processes."""
    # settle anything a previous test left draining
    assert _settled(lambda: not multiprocessing.active_children())
    before = threading.active_count()
    p = _params()
    for backend in ("thread", "process", "thread"):
        for _ in range(3):
            with simulated_chip_farm(2, SIZES, base_seed=0,
                                     backend=backend) as farm:
                farm.read_cost_pairs(
                    p, _thetas(p, 2), BATCH, step=0)
    assert _settled(lambda: not multiprocessing.active_children()), \
        f"leaked worker processes: {multiprocessing.active_children()}"
    assert _settled(lambda: threading.active_count() <= before + 1), \
        f"leaked threads: {threading.active_count()} vs {before} before"


# ---------------------------------------------------------------------------
# py_busy_ms: the GIL-holding demonstration device
# ---------------------------------------------------------------------------


def test_py_busy_ms_holds_for_at_least_the_budget():
    chip = SimulatedAnalogChip(SIZES, seed=0, py_busy_ms=20.0)
    chip.set_params(convert.to_numpy(_params()))
    t0 = time.perf_counter()
    chip.measure_cost(NP_BATCH)
    elapsed = time.perf_counter() - t0
    assert elapsed >= 0.015, f"busy-loop returned in {elapsed * 1e3:.1f}ms"
