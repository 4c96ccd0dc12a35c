"""Farm execution backends: who runs a chip's device transactions, where.

``ChipFarm`` (``hardware/farm.py``) owns the MGD math and the
host-boundary contract — fixed-shape ``(f32[k,2] costs, bool[k] valid)``
gathers, one host round trip a step, fault-policy orchestration,
health/quarantine bookkeeping.  Everything about *executing* a device
transaction (on which thread, in which process, against which rebuilt
device object) lives behind the ``FarmBackend`` interface in this
package:

    backend.start(entries, fault_log=...)   -> per-chip capability dicts
    backend.submit(i, op, payload)          -> Task (future-like)
    task.result(timeout=...)                -> op value (or raises)
    backend.abandon(i)                      -> kill/replace chip i's worker
    backend.shutdown()                      -> idempotent teardown

Three properties every backend must provide:

* **Per-chip FIFO** — ops submitted to one chip execute in submission
  order.  The farm's double-buffered pipeline leans on this: step N+1's
  ``write`` is enqueued without waiting, and the following ``pair`` op
  cannot overtake it, so device state is always written-then-probed in
  program order even though the host never blocked.
* **Deterministic values** — a backend only moves WHERE an op runs.
  Device readout noise is counter-keyed on (device seed, step, tag), so
  serial, thread and process backends produce bit-identical cost streams
  from identically-seeded devices (σ_θ write noise is a live RNG, but
  the per-chip write sequence is schedule-independent, so it replays
  identically too).
* **Abandonment** — ``abandon(i)`` makes chip ``i`` responsive again
  after a hang: the thread backend replaces the runner (the zombie
  thread parks until the instrument releases it), the process backend
  KILLS the worker process — a strictly stronger guarantee — and
  respawns it from the chip's ``DeviceSpec``.

``ChipOps`` is the shared device-call logic (capability inspection +
write/pair/accuracy transactions) every backend executes, host-side or
in-worker.  ``DeviceSpec`` is the picklable recipe a worker process (or
a cluster node) rebuilds its device from — including the ``FaultyChip``
wrapper, so fault injection travels across the process boundary.

Everything here is host-side numpy/stdlib: it never creates a tensor
(the process backend runs it in forked workers, where a CUDA call
would fail), and the pytree walk is ``core.utils``' pure-Python one.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.utils import tree_map
from ..external import accepts_counters, accepts_step, check_device
from ..faults import FaultLog, FaultSpec, FaultyChip

#: Ops a backend must execute.  ``pair`` is the probe transaction
#: (base-θ write + antithetic readout), ``write`` the persistent
#: parameter commit, ``accuracy`` the bench readout, ``writes`` the
#: device write-counter telemetry.
OPS = ("pair", "write", "accuracy", "writes")


def _np_axpy(sign: float, theta, params):
    """params + sign·theta, host-side numpy."""
    return tree_map(
        lambda w, t: np.asarray(w, np.float32)
        + np.float32(sign) * np.asarray(t, np.float32), params, theta)


@dataclasses.dataclass
class DeviceSpec:
    """Picklable recipe for building a chip's device in-worker.

    The process (and cluster) backends cannot ship live device objects —
    a device is stateful, unpicklable in general, and MUST live where
    its transactions execute.  A spec ships the constructor instead:
    ``cls(*args, **kwargs)``, optionally wrapped in a ``FaultyChip``
    (``fault``/``fault_seed``), built via ``build(log=...)`` on the far
    side.  Identical specs build identical chips (device imperfections
    are keyed off the seed in ``kwargs``), which is what makes the
    thread and process backends bit-interchangeable.
    """

    cls: Any                     # device class — importable/picklable
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fault: Optional[FaultSpec] = None
    fault_seed: int = 0
    name: Optional[str] = None

    def __post_init__(self):
        if not callable(self.cls):
            raise TypeError(f"DeviceSpec.cls must be a device class, "
                            f"got {type(self.cls).__name__}")
        for attr in ("set_params", "measure_cost"):
            if not callable(getattr(self.cls, attr, None)):
                raise TypeError(
                    f"DeviceSpec.cls must define {attr}(); got "
                    f"{getattr(self.cls, '__name__', self.cls)!r}")
        if self.fault is not None and not isinstance(self.fault, FaultSpec):
            raise TypeError(f"DeviceSpec.fault must be a FaultSpec or "
                            f"None, got {type(self.fault).__name__}")

    def build(self, log: Optional[FaultLog] = None):
        """Construct the device (and its fault wrapper) where the ops
        will run.  ``log`` receives injected-fault events — the host
        ``FaultLog`` for in-process backends, a worker-local log whose
        events ship back in replies for the process backend."""
        device = self.cls(*self.args, **self.kwargs)
        if self.fault is not None:
            device = FaultyChip(device, self.fault, seed=self.fault_seed,
                                log=log, name=self.name)
        return device

    @property
    def display_name(self) -> str:
        """The chip label the farm shows before the device is built —
        matches ``getattr(device, 'name', ...)`` of the built object."""
        if self.name:
            return self.name
        cls_name = getattr(self.cls, "__name__", str(self.cls))
        if self.fault is not None:
            return f"faulty:{cls_name}:{self.fault_seed}"
        return cls_name


class ChipOps:
    """One chip's transaction executor: capability inspection at
    construction (never on the hot loop) + the shared write/pair/
    accuracy logic every backend runs, host-side or in-worker.

    ``pair`` is the full probe transaction for tags (2i, 2i+1): devices
    with a differential probe line (``measure_pair``) pay ONE persistent
    base-θ write per central pair; plain 2-method devices fall back to
    two perturbed-tree writes + reads."""

    def __init__(self, device: Any):
        check_device(device)
        self.device = device
        self.name = getattr(device, "name", None) or type(device).__name__
        pair = getattr(device, "measure_pair", None)
        self._pair = pair if callable(pair) else None
        self._pair_counters = (self._pair is not None
                               and accepts_counters(self._pair))
        self._counters = accepts_counters(device.measure_cost)
        self._write_step = accepts_step(device.set_params)
        acc = getattr(device, "measure_accuracy", None)
        self._acc = acc if callable(acc) else None
        self._acc_step = self._acc is not None and accepts_step(self._acc)

    def caps(self) -> dict:
        """Static capability record shipped to the farm at ``start``."""
        return {"name": self.name, "pair": self._pair is not None,
                "accuracy": self._acc is not None}

    def write(self, params, step=None) -> int:
        """One persistent write, timestamped for step-capable (drifting)
        devices."""
        if step is not None and self._write_step:
            self.device.set_params(params, step=int(step))
        else:
            self.device.set_params(params)
        return 0

    def pair(self, params, theta, batch, step, tag) -> np.ndarray:
        """One central-difference probe transaction → f32[2]."""
        if self._pair is not None:
            self.write(params, step)        # ONE base-θ write per pair
            if self._pair_counters:
                out = self._pair(theta, batch, step=step, tag=tag)
            else:
                out = self._pair(theta, batch)
            return np.asarray(out, np.float32)

        def read(perturbed, t):
            self.write(perturbed, step)
            if self._counters:
                return self.device.measure_cost(batch, step=step, tag=t)
            return self.device.measure_cost(batch)

        return np.asarray([read(_np_axpy(1.0, theta, params), tag),
                           read(_np_axpy(-1.0, theta, params), tag + 1)],
                          np.float32)

    def accuracy(self, params, batch, step=None) -> float:
        if self._acc is None:
            raise NotImplementedError(
                f"{self.name} exposes no measure_accuracy")
        self.write(params, step)
        if self._acc_step:
            return float(self._acc(
                batch, step=None if step is None else int(step)))
        return float(self._acc(batch))

    def writes(self) -> int:
        return int(getattr(self.device, "writes", 0))

    def run(self, op: str, payload: tuple):
        """Dispatch one op — the single entry point workers loop on."""
        if op == "pair":
            return self.pair(*payload)
        if op == "write":
            return self.write(*payload)
        if op == "accuracy":
            return self.accuracy(*payload)
        if op == "writes":
            return self.writes()
        raise ValueError(f"unknown chip op {op!r} (expected one of {OPS})")


class Task:
    """Future-like handle for one submitted op.  ``result(timeout=...)``
    blocks until the op resolves; raises ``concurrent.futures.
    TimeoutError`` on deadline (so callers can tell a hang from a device
    error) and re-raises the op's exception on failure.  ``busy_s`` is
    the device-execution time the backend measured — the numerator of
    the farm's pipeline-utilization metric."""

    __slots__ = ("_event", "_value", "_error", "busy_s")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.busy_s = 0.0

    def set_result(self, value, busy_s: float = 0.0) -> None:
        self._value = value
        self.busy_s = float(busy_s)
        self._event.set()

    def set_exception(self, error: BaseException,
                      busy_s: float = 0.0) -> None:
        if self._event.is_set():        # late zombie resolution: keep first
            return
        self._error = error
        self.busy_s = float(busy_s)
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise FuturesTimeout(
                f"op did not complete within timeout={timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


class FarmBackend:
    """Abstract farm execution backend.  See the module docstring for
    the contract (per-chip FIFO, deterministic values, abandonment)."""

    #: True when ``start`` accepts live device instances; spec-only
    #: backends (process/cluster) reject instances with a TypeError.
    accepts_instances: bool = True

    def start(self, entries: Sequence[Any], *,
              fault_log: Optional[FaultLog] = None) -> List[dict]:
        """Bring up one worker per entry (device instance or
        ``DeviceSpec``); returns each chip's capability dict
        (``ChipOps.caps()``)."""
        raise NotImplementedError

    def submit(self, i: int, op: str, payload: tuple) -> Task:
        """Enqueue one op on chip ``i`` (FIFO per chip); never blocks on
        the device."""
        raise NotImplementedError

    def abandon(self, i: int) -> None:
        """Give chip ``i`` a fresh worker after a hang (see class doc)."""
        raise NotImplementedError

    def shutdown(self, wait: bool = False) -> None:
        """Tear down every worker; idempotent."""
        raise NotImplementedError

    def busy_seconds(self) -> float:
        """Total device-execution seconds across all chips since
        ``start`` — the utilization numerator."""
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------

    def _build_ops(self, entries, fault_log) -> List[ChipOps]:
        """Instances pass through; specs build against the host log
        (in-process backends share the farm's ``FaultLog`` directly)."""
        ops = []
        for entry in entries:
            if isinstance(entry, DeviceSpec):
                ops.append(ChipOps(entry.build(log=fault_log)))
            else:
                ops.append(ChipOps(entry))
        return ops


class SerialBackend(FarmBackend):
    """Inline execution on the submitting thread — zero concurrency,
    zero extra threads.  The parity oracle: a farm on this backend is
    the plain sequential program, so thread/process trajectories are
    verified against it bit-for-bit, and it is the fallback when a
    deployment forbids spawning anything."""

    def __init__(self):
        self._ops: List[ChipOps] = []
        self._busy = 0.0
        self._lock = threading.Lock()
        self._down = False

    def start(self, entries, *, fault_log=None):
        self._ops = self._build_ops(entries, fault_log)
        return [op.caps() for op in self._ops]

    def submit(self, i, op, payload):
        task = Task()
        t0 = time.perf_counter()
        try:
            value = self._ops[i].run(op, payload)
        except Exception as e:          # noqa: BLE001 — device failure
            task.set_exception(e, time.perf_counter() - t0)
        else:
            busy = time.perf_counter() - t0
            with self._lock:
                self._busy += busy
            task.set_result(value, busy)
        return task

    def abandon(self, i):
        """Nothing to replace — the op ran (and hung) on the caller."""

    def shutdown(self, wait=False):
        self._down = True

    def busy_seconds(self):
        with self._lock:
            return self._busy


#: Registry: name -> zero-config constructor.  ``thread``/``process``/
#: ``cluster`` register themselves on import (``backend/__init__.py``).
BACKENDS: Dict[str, Callable[[], FarmBackend]] = {"serial": SerialBackend}


def make_backend(backend) -> FarmBackend:
    """Resolve ``backend``: a ``FarmBackend`` instance passes through, a
    registered name constructs one."""
    if isinstance(backend, FarmBackend):
        return backend
    if isinstance(backend, str):
        if backend not in BACKENDS:
            raise ValueError(f"unknown farm backend {backend!r} — "
                             f"registered: {sorted(BACKENDS)}")
        return BACKENDS[backend]()
    raise TypeError(f"backend must be a name or FarmBackend instance, "
                    f"got {type(backend).__name__}")
