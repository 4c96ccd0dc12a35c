"""Chip farm: k external chips evaluating k probes concurrently (§6).

The port's twin of ``repro.hardware.farm``: the same host-side machinery
(backends, pipeline, fault policy, health), driven by an eager step
instead of ordered ``io_callback``s.

The paper's deployment endgame is a *farm of imperfect chips*: k devices,
each with its own fabrication defects and noise, each evaluating its own
perturbation probe, with the trainer averaging the k scalar error signals

    θ ← θ − η · (1/k) Σ_k C̃_k · θ̃_k / Δθ²

— k× probe-variance reduction at zero extra per-chip work (Oripov et al.
2025 show this axis is what makes perturbative training scale).  The
in-process version of that picture is ``core.probe_parallel`` (k pods
run one after another on the card); ``ChipFarm`` is the same math across
a *process / instrument* boundary:

* ``read_cost_pairs(params, thetas, batch, step)`` copies the params,
  the k perturbations and the batch to host numpy ONCE, fans the k
  central-difference pairs out to the k devices and gathers all 2k cost
  scalars plus a per-chip validity mask — the only values that cross
  back, as tensors on the params' device.  On the card the copy waits
  for the step's queued work: one device→host sync a read, one a write
  (``pipeline_stats()["copy_s"]`` totals their seconds).
* Each chip sees the optimizer's (step, tag=2k/2k+1) counters when its
  readout accepts them, so counter-keyed device noise distinguishes
  every read and two identically-seeded runs are bit-identical.
* Devices with a differential probe line (``measure_pair``) pay one
  persistent base-θ write per pair; plain 2-method devices fall back to
  two perturbed-tree writes (see ``external.py``).
* ``shard_batch=True`` feeds chip i the i-th contiguous leading-dim
  slice of each probe batch instead of the whole batch — the farm twin
  of the k-pod step's default batch placement, closing the
  every-chip-sees-the-same-data gap.  Probe I/O shrinks k× and the
  averaged C̃ estimates ∇(mean of the per-shard costs), the same target
  the batch-sharded k-pod step trains; ``measure_accuracy`` still
  evaluates every chip on the FULL bench batch.

**Execution backends** (``backend="thread" | "process" | "serial" |
"cluster"`` or a ``FarmBackend`` instance — see ``hardware/backend/``):
the farm owns only the MGD math and this host-boundary contract; WHERE a
chip's transactions run is the backend's job.  ``thread`` (default)
keeps live device instances in-process, one runner thread per chip;
``process`` runs one worker process per chip built from picklable
``DeviceSpec`` entries — GIL-bound instrument drivers scale to k and a
hung worker is actually KILLED rather than abandoned; ``serial`` is the
inline parity oracle; ``cluster`` is the wire-protocol stub.  Backends
only move execution: device noise is counter-keyed, so every backend
produces the bit-identical cost stream.

**Double-buffered pipeline** (``pipeline=True``): ``write_params``
enqueues the k per-chip writes and returns without waiting, so step
N+1's writes overlap the host's work toward the next step, and the next probe round
submits its pairs BEHIND the writes (per-chip FIFO — the device is
always written-then-probed in program order) before resolving either.
The schedule cannot perturb values — readout noise is (seed, step,
tag)-keyed — but state-dependent boundaries must not run with writes in
flight: ``fence()`` drains them, and the farm self-fences before
``measure_accuracy`` / ``total_writes``; ``train_mgd`` fences before
checkpoints, evals and recalibration so resume stays bit-exact.

**Fault tolerance** (``fault_policy=hardware.FaultPolicy(...)``): real
instruments hang, crash and return garbage, and k chips multiply that
fault surface by k.  Under a policy every chip's probe transaction runs
bounded by ``timeout_s`` with retry-and-exponential-backoff; a chip that
exhausts its retries (or returns non-finite costs) is MASKED for that
step rather than unwinding the training step: ``read_cost_pairs`` always
returns the fixed-shape pair ``(f32[k, 2] costs, bool[k] valid)``.  Invalid chips carry NaN costs and
``valid[k]=False``.  Persistently failing chips (``quarantine_after``
consecutive exhausted rounds) are quarantined — skipped with NO I/O on
the probe path, still receiving parameter writes — and re-probed every
``reprobe_every`` steps for readmission; a readmitted chip's
counter-keyed noise stream is untouched (noise is a function of
(step, tag), not of how many reads happened in between).  A timed-out
attempt ABANDONS the chip's worker through the backend: the thread
backend parks the zombie and replaces the runner, the process backend
kills the worker process and respawns it from the spec.  Health,
quarantine and the ``FaultLog`` all live HOST-side; process workers
ship their injected-fault events back with each reply.

**Mask semantics / η-rescaling rule** (``core.probe_parallel``): the
step zeroes invalid chips' C̃_k and keeps the per-chip coefficient
``−η/(k·Δθ²)`` unchanged.  Because η is tuned ∝ k (the farm's k× probe
averaging supports a k× larger step), dropping a chip's term at fixed
η/k IS the "rescale η by the live chip count" rule applied per chip:
the surviving chips' update is exactly the (η·k_live/k)-scaled masked
average.  With all chips valid the masked path is bit-identical to the
unmasked one (``where(True, x, 0) == x`` bitwise).

Even WITHOUT a policy, gathers at the host boundary pass a generous
default timeout (``faults.DEFAULT_TIMEOUT_S``) and re-raise worker
exceptions as ``ChipFaultError`` with the chip index and device name
attached — a hung instrument surfaces as a diagnosable error instead of
an un-interruptible hang of the training step.

Everything host-side is NUMPY-PURE (workers may be forked processes,
where a CUDA call would fail); each chip's noise is its own per-device
stream, so the backend schedule cannot perturb the trajectory.
"""
from __future__ import annotations

import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.pipeline import check_chip_shardable, shard_chip_batch

from .backend import DeviceSpec, FarmBackend, make_backend
from .base import Plant, PlantMeta
from .devices import DriftingAnalogChip, SimulatedAnalogChip
from .external import (check_device, device_of, host_batch,
                       host_params)
from .faults import (DEFAULT_TIMEOUT_S, ChipFaultError, FarmHealth,
                     FaultLog, FaultPolicy, FaultSpec, FaultyChip)

#: Fixed-shape placeholder for a masked-out chip's cost pair — NaN, so a
#: bug that consumes an invalid pair without checking the mask poisons
#: the update loudly instead of silently biasing it.
_INVALID_PAIR = np.array([np.nan, np.nan], np.float32)


def _teardown(backend: FarmBackend,
              supervisors: Optional[ThreadPoolExecutor]) -> None:
    """Farm teardown (close() and the GC finalizer): backend workers
    first, then the supervisor pool — sweeps build many farms per
    process and leaked threads/processes would otherwise accumulate
    until interpreter exit."""
    backend.shutdown(wait=False)
    if supervisors is not None:
        supervisors.shutdown(wait=False)


class ChipFarm(Plant):
    """k opaque devices behind one host boundary, probed concurrently.

    Driven exclusively by ``repro_torch.driver(
    "probe_parallel_external", cfg, plant=farm)`` — the farm has no
    single-scalar ``read_cost`` (wrap one device in ``ExternalPlant``
    for the single-chip drivers).

    ``devices`` entries are live device instances (thread/serial
    backends) or picklable ``DeviceSpec``s (required by the process and
    cluster backends, accepted by all).  ``backend`` picks who executes
    the transactions; ``pipeline=True`` double-buffers parameter writes
    against the next probe round; ``shard_batch=True`` slices each probe
    batch into contiguous per-chip shards (the k-pod step's default
    batch layout).  ``fault_policy`` arms the host boundary: per-attempt
    timeouts, retries with exponential backoff, per-chip masking on
    exhaustion, quarantine/readmission via the ``health`` registry, and
    the robust aggregation mode ``core.probe_parallel`` reads at build
    time.  See the module docstring for the mask semantics and
    η-rescaling rule.

    The farm is a context manager; ``close()`` is idempotent and also
    runs at garbage collection.  ``max_workers`` is accepted for
    backward compatibility and ignored — execution is one worker per
    chip under every backend.
    """

    def __init__(self, devices: Sequence[Any], *,
                 meta: Optional[PlantMeta] = None,
                 max_workers: Optional[int] = None,
                 fault_policy: Optional[FaultPolicy] = None,
                 fault_log: Optional[FaultLog] = None,
                 backend="thread", pipeline: bool = False,
                 shard_batch: bool = False):
        del max_workers                 # legacy knob: one worker per chip
        entries = list(devices)
        if not entries:
            raise ValueError("ChipFarm needs at least one device")
        for entry in entries:
            if not isinstance(entry, DeviceSpec):
                check_device(entry)
        if fault_policy is not None and not isinstance(fault_policy,
                                                       FaultPolicy):
            raise TypeError(f"fault_policy must be a hardware.FaultPolicy, "
                            f"got {type(fault_policy).__name__}")
        self.devices = entries
        self.shard_batch = bool(shard_batch)
        self.policy = fault_policy
        self.fault_log = fault_log if fault_log is not None else FaultLog()
        self.pipeline = bool(pipeline)
        self.backend = make_backend(backend)
        self._caps = self.backend.start(entries, fault_log=self.fault_log)
        self._names = [c["name"] for c in self._caps]
        self.health = FarmHealth(self._names)
        self._pending_writes: list = []   # [(chip, step, Task)]
        self._t_start: Optional[float] = None
        self._copy_s = 0.0                # device→host copies of the step
        self._supervisors = None
        if fault_policy is not None:
            # one supervisor thread per chip runs the retry loop, so
            # per-chip timeouts/backoffs never serialize across chips
            self._supervisors = ThreadPoolExecutor(
                max_workers=len(entries),
                thread_name_prefix="chip-farm-sup")
        # reclaim workers when the farm is garbage-collected; close()
        # invokes the same finalizer, making it idempotent
        self._finalizer = weakref.finalize(
            self, _teardown, self.backend, self._supervisors)
        self.meta = meta or PlantMeta(name=f"chip-farm-{len(entries)}",
                                      external=True, chips=len(entries),
                                      fault_tolerant=fault_policy is not None)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Tear down backend workers and supervisor threads.  Idempotent
        (also runs at GC).  In-flight pipelined writes are drained
        best-effort first — call ``fence()`` yourself when you need the
        commit guaranteed (or an error surfaced)."""
        if self._pending_writes:
            try:
                self.fence(timeout=5.0)
            except Exception:           # noqa: BLE001 — teardown path
                self._pending_writes = []
        self._finalizer()

    def __enter__(self) -> "ChipFarm":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive

    @property
    def n_chips(self) -> int:
        return len(self.devices)

    def _label(self, i: int) -> str:
        return f"chip {i} ({self._names[i]})"

    def fault_summary(self) -> dict:
        """Fault-tolerance telemetry: event counts by kind plus the
        health registry summary.  ``{"events": 0, ...}`` means a clean
        run."""
        return {"events": len(self.fault_log),
                "by_kind": self.fault_log.counts(),
                **self.health.summary()}

    def pipeline_stats(self) -> dict:
        """Utilization telemetry: ``utilization`` is Σ per-chip device
        busy seconds / (k × wall seconds since the first probe round) —
        1.0 means every chip was converting for the whole run, the
        ≥0.8 target of the double-buffered pipeline.  ``copy_s`` is the
        seconds spent copying params, perturbations and batches to host
        numpy (on the card each copy waits for the queued step)."""
        busy = self.backend.busy_seconds()
        wall = (0.0 if self._t_start is None
                else time.perf_counter() - self._t_start)
        return {
            "backend": type(self.backend).__name__,
            "pipeline": self.pipeline,
            "chips": self.n_chips,
            "busy_s": busy,
            "wall_s": wall,
            "utilization": (busy / (wall * self.n_chips)) if wall else 0.0,
            "copy_s": self._copy_s,
        }

    # -- host side (numpy-pure, runs on the caller + supervisor threads) ---

    def fence(self, timeout: Optional[float] = None) -> None:
        """Drain in-flight pipelined parameter writes.  Write errors
        surface here with the failing chip named (or are logged and
        masked under a fault policy) — the explicit synchronization
        point before checkpoints, evals and recalibration."""
        pending, self._pending_writes = self._pending_writes, []
        self._resolve_writes(pending, timeout=timeout)

    def _resolve_writes(self, pending, timeout: Optional[float] = None):
        deadline = timeout if timeout is not None else DEFAULT_TIMEOUT_S
        for i, step, task in pending:
            try:
                task.result(timeout=deadline)
            except Exception as e:      # noqa: BLE001 — device failure
                if self.policy is None:
                    raise ChipFaultError(
                        f"{self._label(i)}: parameter write failed at "
                        f"step={step}: {e!r}") from e
                # under a policy a failed write must not unwind the step;
                # the chip keeps its stale parameters and the next probe
                # round surfaces (and masks) the damage
                self.fault_log.record("write-error", self._label(i),
                                      step=step, detail=str(e))

    def _guarded_submit(self, i, op, payload, *, step, tag, health):
        """One chip transaction under the fault policy: submit to the
        backend, bound each attempt by ``timeout_s``, ABANDON the
        chip's worker on timeout (thread: replace runner; process: kill
        + respawn), retry with exponential backoff, reject non-finite
        readouts.  Returns ``(value, latency_s, None)`` or ``(None,
        None, last_error)`` — the backend-native twin of
        ``faults.guarded_call``."""
        policy, label = self.policy, self._label(i)
        last: Optional[Exception] = None
        for attempt in range(policy.retries + 1):
            if attempt:
                time.sleep(policy.backoff_for(attempt))
            task = self.backend.submit(i, op, payload)
            t0 = time.monotonic()
            try:
                out = task.result(timeout=policy.timeout_s)
            except _FuturesTimeout:
                self.backend.abandon(i)
                last = ChipFaultError(
                    f"{label}: no response within timeout_s="
                    f"{policy.timeout_s}s at step={step} "
                    f"(attempt {attempt})")
                kind = "timeout"
            except Exception as e:      # noqa: BLE001 — any device failure
                last, kind = e, "error"
            else:
                if policy.reject_nonfinite and not np.all(
                        np.isfinite(np.asarray(out, np.float64))):
                    last = ChipFaultError(
                        f"{label}: non-finite readout {out!r} at "
                        f"step={step}")
                    kind = "nonfinite"
                else:
                    return out, time.monotonic() - t0, None
            if health is not None:
                health.attempts_failed += 1
                if kind == "timeout":
                    health.timeouts += 1
            self.fault_log.record(kind, label, step=step, tag=tag,
                                  attempt=attempt, detail=str(last))
        return None, None, last

    def _chip_pair_robust(self, i, params, theta, batch, step):
        """One chip's probe round under the fault policy (supervisor
        thread): quarantine fast-path, guarded attempts with retries,
        health bookkeeping.  Returns ``(f32[2] pair, valid)`` — never
        raises."""
        policy, h = self.policy, self.health.chips[i]
        if h.skip(step):
            # quarantined, not yet due a readmission probe: NO I/O
            return _INVALID_PAIR, False
        out, latency, err = self._guarded_submit(
            i, "pair", (params, theta, batch, step, 2 * i),
            step=step, tag=2 * i, health=h)
        if err is None:
            if h.quarantined:
                h.readmit()
                self.fault_log.record("readmit", self._label(i), step=step)
            h.record_success(latency, policy.latency_alpha)
            return np.asarray(out, np.float32), True
        h.record_failure()
        if h.quarantined:
            # failed readmission probe — back off until the next one
            h.next_reprobe = int(step) + policy.reprobe_every
        elif policy.quarantine_after and \
                h.consecutive_failures >= policy.quarantine_after:
            h.enter_quarantine(step, policy)
            self.fault_log.record(
                "quarantine", self._label(i), step=step,
                detail=f"{h.consecutive_failures} consecutive failures")
        return _INVALID_PAIR, False

    def _host_pairs(self, params, thetas, batch, step):
        step = int(step)
        k = self.n_chips
        if self._t_start is None:
            self._t_start = time.perf_counter()
        # pipelined writes from the previous step sit AHEAD of the pair
        # ops below in each chip's FIFO: dispatch the pairs first (the
        # workers run write→pair back to back), then resolve the write
        # tasks — by then effectively free — so write errors still
        # surface before this round's costs are consumed.
        pending, self._pending_writes = self._pending_writes, []
        if self.shard_batch:
            # contiguous per-chip slices — the block layout the k-pod
            # step's default batch split produces, so chip i and pod i
            # probe the identical rows (the bit-equality law under batch
            # sharding)
            batches = [shard_chip_batch(batch, k, i) for i in range(k)]
        else:
            batches = [batch] * k
        if self.policy is None:
            tasks = [
                self.backend.submit(i, "pair",
                                    (params, thetas[i], batches[i],
                                     step, 2 * i))
                for i in range(k)
            ]
            self._resolve_writes(pending)
            pairs = []
            # gather in chip order — the schedule cannot reorder results
            for i, t in enumerate(tasks):
                try:
                    pairs.append(np.asarray(t.result(
                        timeout=DEFAULT_TIMEOUT_S), np.float32))
                except Exception as e:
                    raise ChipFaultError(
                        f"{self._label(i)}: probe failed at step={step}: "
                        f"{e!r} — pass fault_policy=FaultPolicy(...) to "
                        f"retry and mask instead of failing the step"
                    ) from e
            return np.asarray(pairs, np.float32), np.ones(k, bool)
        futures = [
            self._supervisors.submit(self._chip_pair_robust, i, params,
                                     thetas[i], batches[i], step)
            for i in range(k)
        ]
        self._resolve_writes(pending)
        deadline = self.policy.round_deadline_s()
        costs = np.empty((k, 2), np.float32)
        valid = np.zeros(k, bool)
        for i, f in enumerate(futures):
            try:
                pair, ok = f.result(timeout=deadline)
            except Exception as e:  # supervisor failure — mask, keep going
                self.fault_log.record("error", self._label(i), step=step,
                                      detail=f"supervisor: {e}")
                pair, ok = _INVALID_PAIR, False
            costs[i] = pair
            valid[i] = ok
        return costs, valid

    def _host_write(self, params, step):
        step = int(step)
        tasks = [(i, step, self.backend.submit(i, "write", (params, step)))
                 for i in range(self.n_chips)]
        if self.pipeline:
            # double-buffer: the writes execute while the host runs the
            # host's work toward the next probe round; per-chip FIFO
            # guarantees they land before that round's pair ops, and
            # errors surface at the next gather (or fence())
            self._pending_writes.extend(tasks)
            return np.int32(0)
        self._resolve_writes(tasks)
        return np.int32(0)

    # -- step side ---------------------------------------------------------

    def _to_host(self, fn, tree):
        t0 = time.perf_counter()
        out = fn(tree)
        self._copy_s += time.perf_counter() - t0
        return out

    def read_cost_pairs(self, params, thetas, batch, *, step):
        """All k chips' antithetic pairs in one host round trip.
        ``thetas`` is the list of k perturbation trees (chip k probes its
        own θ̃_k); returns ``(f32[k, 2] costs, bool[k] valid)`` tensors on
        the params' device.  Without a fault policy ``valid`` is all-True
        (any failure raises); with one, masked chips carry NaN costs and
        ``valid=False``."""
        if len(thetas) != self.n_chips:
            raise ValueError(f"{len(thetas)} probe trees for "
                             f"{self.n_chips} chips")
        if self.shard_batch:
            # fail before any device I/O, not inside a worker mid-step
            check_chip_shardable(batch, self.n_chips)
        dev = device_of(params)
        host = self._to_host(
            lambda t: (host_params(t[0]), [host_params(x) for x in t[1]],
                       host_batch(t[2])), (params, thetas, batch))
        costs, valid = self._host_pairs(*host, int(step))
        return (torch.from_numpy(np.asarray(costs, np.float32)).to(dev),
                torch.from_numpy(np.asarray(valid, bool)).to(dev))

    def read_cost(self, params, batch, *, step, tag: int = 0):
        raise NotImplementedError(
            "ChipFarm has no single-chip cost read — drive it with "
            "repro_torch.driver('probe_parallel_external', cfg, "
            "plant=farm), or wrap one device in ExternalPlant for the "
            "single-chip drivers")

    def write_params(self, params, *, step, prev=None):
        """Commit the post-update parameters to EVERY chip (open-loop, as
        in ``ExternalPlant``: per-chip write noise stays invisible).
        Quarantined chips are still written — writes are cheap and keep
        them current for readmission.  With ``pipeline=True`` the host
        does not wait for the writes to land (see ``fence``)."""
        self._host_write(self._to_host(host_params, params), int(step))
        return params

    # -- evaluation harness (never part of the training step) ------------

    def measure_accuracy(self, params, batch, *, step=None) -> float:
        """Mean on-chip accuracy across the farm after committing
        ``params`` — the experimenter's bench readout, not training I/O.

        Self-fences first (a bench readout must not race an in-flight
        pipelined write).  Writes are timestamped with ``step`` for
        step-capable drifting chips (a bench readout of an aging chip
        must not silently reset its age).  Under a fault policy,
        quarantined chips are excluded from the bench average and
        per-chip errors are logged and skipped (falling back to all
        chips if every one is quarantined)."""
        params = host_params(params)
        batch = host_batch(batch)
        self.fence()
        capable = [i for i in range(self.n_chips)
                   if self._caps[i]["accuracy"]]
        if not capable:
            raise NotImplementedError("no device exposes measure_accuracy")
        indices = capable
        if self.policy is not None:
            live = [i for i in capable
                    if not self.health.chips[i].quarantined]
            indices = live or capable
        tasks = {i: self.backend.submit(i, "accuracy",
                                        (params, batch, step))
                 for i in indices}
        values = []
        for i, t in tasks.items():
            try:
                values.append(t.result(timeout=DEFAULT_TIMEOUT_S))
            except Exception as e:
                if self.policy is None:
                    raise ChipFaultError(
                        f"{self._label(i)}: accuracy readout failed: "
                        f"{e!r}") from e
                self.fault_log.record("accuracy-error", self._label(i),
                                      step=step, detail=str(e))
        if not values:
            raise ChipFaultError(
                "no chip produced an accuracy readout "
                f"(all {len(indices)} attempts failed)")
        return float(np.mean(values))

    @property
    def total_writes(self) -> int:
        """Summed ``writes`` counters across the farm (test/telemetry) —
        routed through the backend, so process-backend chips report
        their in-worker counters.  Self-fences first."""
        self.fence()
        tasks = [self.backend.submit(i, "writes", ())
                 for i in range(self.n_chips)]
        return sum(int(t.result(timeout=DEFAULT_TIMEOUT_S))
                   for t in tasks)


def simulated_chip_farm(k: int, sizes: Sequence[int] = (49, 4, 4), *,
                        base_seed: int = 0, sigma_a: float = 0.15,
                        sigma_theta: float = 0.01, sigma_c: float = 1e-4,
                        py_busy_ms: float = 0.0,
                        drift_rate: float = 0.0,
                        drift_rates: Optional[Sequence[float]] = None,
                        drift_mode: str = "walk", drift_tau: float = 0.0,
                        max_workers: Optional[int] = None,
                        faults=None, fault_seed: int = 1000,
                        fault_policy: Optional[FaultPolicy] = None,
                        backend="thread", pipeline: bool = False,
                        shard_batch: bool = False) -> ChipFarm:
    """A farm of k ``SimulatedAnalogChip``s with DISTINCT device seeds —
    k different physical chips (different defect draws, different noise
    streams), the same instrument replicated k× on the bench.

    ``backend`` picks the execution backend; spec-only backends
    (``process``/``cluster``) get picklable ``DeviceSpec`` entries that
    rebuild the identical chips — fault wrappers included — in their
    workers, everything else gets live instances.  ``pipeline=True``
    double-buffers parameter writes (see ``ChipFarm``).  ``py_busy_ms``
    makes each chip hold the GIL during readout conversions — the
    honest thread-vs-process scaling demonstration device.

    ``drift_rate`` (every chip) or ``drift_rates`` (one σ_d per chip — a
    HETEROGENEOUS farm, where chip i ages at its own rate) build
    ``DriftingAnalogChip``s instead; aging stays per-device-seed keyed,
    so two chips with different rates remain distinguishable across a
    checkpoint/resume.  Zero-rate chips stay plain (bit-identical to the
    drift-free farm).

    ``faults`` injects counter-keyed faults: a single ``FaultSpec``
    (every chip, per-chip fault seeds ``fault_seed + i``) or a k-long
    sequence with ``None`` entries for healthy chips.  ``fault_policy``
    arms the boundary (timeouts/retries/masking/quarantine) — the two
    compose but neither requires the other: inject faults with no policy
    to demonstrate the failure mode, or arm a policy over healthy chips
    at near-zero cost."""
    if k < 1:
        raise ValueError(f"need at least one chip, got k={k}")
    if drift_rates is None:
        rates = [float(drift_rate)] * k
    else:
        rates = [float(r) for r in drift_rates]
        if len(rates) != k:
            raise ValueError(f"{len(rates)} drift_rates for {k} chips")
    specs = [None] * k
    if faults is not None:
        specs = list(faults) if isinstance(faults, (list, tuple)) \
            else [faults] * k
        if len(specs) != k:
            raise ValueError(f"{len(specs)} fault specs for {k} chips")
        for spec in specs:
            if spec is not None and not isinstance(spec, FaultSpec):
                raise TypeError(f"faults entries must be FaultSpec or "
                                f"None, got {type(spec).__name__}")

    def chip_recipe(i):
        """(cls, kwargs) for chip i — one place, so the instance and
        DeviceSpec paths build the identical device."""
        kwargs = dict(seed=base_seed + i, sigma_a=sigma_a,
                      sigma_theta=sigma_theta, sigma_c=sigma_c,
                      py_busy_ms=py_busy_ms)
        if rates[i] or drift_tau:
            kwargs.update(drift_mode=drift_mode, drift_rate=rates[i],
                          drift_tau=drift_tau)
            return DriftingAnalogChip, kwargs
        return SimulatedAnalogChip, kwargs

    be = make_backend(backend)
    fault_log = FaultLog()
    if be.accepts_instances:
        devices = []
        for i in range(k):
            cls, kwargs = chip_recipe(i)
            device = cls(sizes, **kwargs)
            if specs[i] is not None:
                device = FaultyChip(device, specs[i], seed=fault_seed + i,
                                    log=fault_log)
            devices.append(device)
    else:
        devices = []
        for i in range(k):
            cls, kwargs = chip_recipe(i)
            devices.append(DeviceSpec(cls, (tuple(sizes),), kwargs,
                                      fault=specs[i],
                                      fault_seed=fault_seed + i))
    drifting = any(rates) or drift_tau
    return ChipFarm(
        devices, max_workers=max_workers, fault_policy=fault_policy,
        fault_log=fault_log, backend=be, pipeline=pipeline,
        shard_batch=shard_batch,
        meta=PlantMeta(name=f"sim-farm-{k}" + ("-drift" if drifting else ""),
                       cost_noise=sigma_c, write_noise=sigma_theta,
                       sigma_a=sigma_a, external=True, chips=k,
                       drift_mode=drift_mode if drifting else None,
                       drift_rate=max(rates), drift_tau=drift_tau,
                       fault_tolerant=fault_policy is not None))
