"""Process backend: one worker process per chip, real kills on hangs.

Why processes: the thread backend can only *abandon* a hung instrument
call — the zombie thread parks until the device releases it, and a
GIL-holding device driver (pure-Python instrument stacks are the common
case) serializes k chips to k× single-chip wall-clock.  One worker
process per chip removes both limits: each chip's transactions run under
their own GIL (k GIL-bound chips probe in parallel), and ``abandon(i)``
is ``SIGTERM`` — the hung worker actually dies and a fresh one respawns
from the chip's ``DeviceSpec``.  The thread backend's hung-thread
abandonment becomes a real process kill, strictly stronger.

State contract across the boundary:

* Devices are built IN-WORKER from picklable ``DeviceSpec``s (live
  instances are rejected — a device must live where its transactions
  run).  Identical specs build identical chips, and readout noise is
  counter-keyed on (device seed, step, tag), so the process backend is
  bit-identical to thread/serial execution.
* ``FarmHealth``/quarantine and the ``FaultLog`` stay HOST-SIDE with the
  farm.  Workers record injected-fault events into a worker-local log
  and ship them back with each reply; the host runner folds them into
  the farm's log, so ``fault_summary()`` sees one merged stream.
* A retry after a kill re-runs the whole probe transaction, which
  starts by writing the base θ — a respawned worker needs no state
  restore beyond its spec.  (A ``FaultyChip``'s per-(step, tag) attempt
  counters die with the worker; non-kill retries — the bit-exactness
  path — never lose them because device exceptions leave the worker
  alive.)

Each chip pairs a long-lived worker process (duplex pipe, FIFO by
construction) with a host-side runner thread that services the chip's
task queue; the runner survives worker deaths and respawns the process.

The default start method is ``fork``: workers run numpy and pure Python
only and never touch CUDA, so forking a parent that has initialized the
card is safe for them (CUDA refuses only a forked child that calls it),
and fork makes respawn-after-kill milliseconds.  Pass
``context="spawn"`` where forking misbehaves; spawned workers import
``repro_torch`` (and torch) afresh, which takes seconds each.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
from typing import List, Optional

from ..faults import ChipFaultError, FaultLog
from .base import BACKENDS, ChipOps, DeviceSpec, FarmBackend, Task

#: Queue sentinel: tells a chip runner to stop servicing its worker.
_STOP = object()

#: Deadline for a freshly spawned worker's ready handshake.
START_TIMEOUT_S = 60.0


def _worker_main(conn, spec: DeviceSpec):
    """Worker process entry point: build the device from its spec, then
    loop recv (op, payload) → run → send (value, err, events, busy_s).
    Exits on EOF/sentinel via ``os._exit`` (no inherited atexit)."""
    log = FaultLog()
    try:
        ops = ChipOps(spec.build(log=log))
    except Exception as e:              # noqa: BLE001 — report, then die
        try:
            conn.send(("__init_error__", f"{type(e).__name__}: {e}"))
        finally:
            os._exit(1)
    conn.send(("__ready__", ops.caps()))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        op, payload = msg
        t0 = time.perf_counter()
        try:
            value, err = ops.run(op, payload), None
        except Exception as e:          # noqa: BLE001 — device failure
            value, err = None, f"{type(e).__name__}: {e}"
        busy = time.perf_counter() - t0
        try:
            conn.send((value, err, log.drain(), busy))
        except (BrokenPipeError, OSError):
            break
    os._exit(0)


class _ChipWorker:
    """One chip's worker process + the host runner thread that services
    its task queue.  The runner outlives worker deaths: a kill (or a
    worker crash) fails the in-flight task and respawns the process from
    the spec, then keeps draining the queue."""

    def __init__(self, backend: "ProcessBackend", chip: int,
                 spec: DeviceSpec):
        self.backend = backend
        self.chip = chip
        self.spec = spec
        self.queue: "queue.Queue" = queue.Queue()
        self.proc = None
        self.conn = None
        self.caps: Optional[dict] = None
        self._lock = threading.Lock()   # guards proc/conn swaps
        self._spawn()
        self.thread = threading.Thread(
            target=self._loop, name=f"chip-farm-proc-{chip}", daemon=True)
        self.thread.start()

    def _spawn(self):
        ctx = self.backend._ctx
        host, remote = ctx.Pipe(duplex=True)
        proc = ctx.Process(target=_worker_main, args=(remote, self.spec),
                           name=f"chip-worker-{self.chip}", daemon=True)
        proc.start()
        remote.close()                  # child holds its own end
        if not host.poll(START_TIMEOUT_S):
            proc.terminate()
            raise ChipFaultError(
                f"chip {self.chip} ({self.spec.display_name}): worker "
                f"did not come up within {START_TIMEOUT_S}s")
        kind, info = host.recv()
        if kind != "__ready__":
            proc.join(timeout=5.0)
            raise ChipFaultError(
                f"chip {self.chip} ({self.spec.display_name}): device "
                f"construction failed in worker: {info}")
        with self._lock:
            self.proc, self.conn, self.caps = proc, host, info

    def kill(self):
        """Terminate the worker NOW (abandon): the runner's blocked
        recv sees EOF, fails the in-flight task, and respawns."""
        with self._lock:
            proc = self.proc
        if proc is not None and proc.is_alive():
            proc.terminate()

    def _loop(self):
        while True:
            item = self.queue.get()  # mgdlint: disable=MGD003 (idle FIFO wait; the _STOP sentinel always wakes it on shutdown)
            if item is _STOP:
                self._teardown()
                return
            op, payload, task = item
            if self.backend._down:
                task.set_exception(ChipFaultError(
                    f"chip {self.chip}: farm backend is shut down"))
                continue
            try:
                self.conn.send((op, payload))
                reply = self.conn.recv()
            except (EOFError, OSError, BrokenPipeError) as e:
                busy = 0.0
                task.set_exception(ChipFaultError(
                    f"chip {self.chip} ({self.spec.display_name}): "
                    f"worker died mid-transaction ({type(e).__name__}) "
                    f"— killed on timeout or crashed"), busy)
                if self.backend._down:
                    self._teardown()
                    return
                try:
                    self._respawn()
                except Exception as spawn_err:  # noqa: BLE001
                    self._fail_pending(spawn_err)
                    return
                continue
            value, err, events, busy = reply
            self.backend._account(busy)
            if events and self.backend._fault_log is not None:
                self.backend._fault_log.extend(events)
            if err is not None:
                task.set_exception(ChipFaultError(
                    f"chip {self.chip} ({self.spec.display_name}): "
                    f"{err}"), busy)
            else:
                task.set_result(value, busy)

    def _respawn(self):
        with self._lock:
            old_proc, old_conn = self.proc, self.conn
            self.proc = self.conn = None
        if old_conn is not None:
            old_conn.close()
        if old_proc is not None:
            old_proc.join(timeout=5.0)
        self._spawn()

    def _fail_pending(self, error):
        """Respawn failed — drain the queue so nothing blocks forever."""
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP:
                item[2].set_exception(ChipFaultError(
                    f"chip {self.chip}: worker respawn failed: {error}"))

    def _teardown(self):
        with self._lock:
            proc, conn = self.proc, self.conn
            self.proc = self.conn = None
        if conn is not None:
            try:
                conn.send(None)         # graceful exit request
            except (BrokenPipeError, OSError):
                pass
            conn.close()
        if proc is not None:
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)


class ProcessBackend(FarmBackend):
    """One worker process per chip.  Requires ``DeviceSpec`` entries —
    live instances cannot cross the process boundary."""

    accepts_instances = False

    def __init__(self, context: Optional[str] = None):
        if context is None:
            context = "fork" if "fork" in mp.get_all_start_methods() \
                else None
        self._ctx = mp.get_context(context)
        self._workers: List[_ChipWorker] = []
        self._lock = threading.Lock()
        self._busy = 0.0
        self._down = False
        self._fault_log: Optional[FaultLog] = None

    def start(self, entries, *, fault_log=None):
        for i, entry in enumerate(entries):
            if not isinstance(entry, DeviceSpec):
                raise TypeError(
                    f"the process backend rebuilds each device in its "
                    f"worker and needs DeviceSpec entries; chip {i} is a "
                    f"live {type(entry).__name__} instance (build the "
                    f"farm with backend='thread', or pass DeviceSpecs)")
        self._fault_log = fault_log
        workers = []
        try:
            for i, spec in enumerate(entries):
                workers.append(_ChipWorker(self, i, spec))
        except Exception:
            self._workers = workers
            self.shutdown()
            raise
        self._workers = workers
        return [w.caps for w in workers]

    def submit(self, i, op, payload):
        task = Task()
        if self._down:
            task.set_exception(ChipFaultError(
                f"chip {i}: farm backend is shut down"))
            return task
        self._workers[i].queue.put((op, payload, task))
        return task

    def abandon(self, i):
        """KILL chip ``i``'s worker — the process-backend upgrade over
        thread abandonment: the hung transaction dies with it, and the
        runner respawns a fresh worker from the spec."""
        self._workers[i].kill()

    def shutdown(self, wait=False):
        if self._down:
            return
        self._down = True
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            w.queue.put(_STOP)
        for w in workers:
            # runners blocked in recv (op in flight) only unblock when
            # the worker dies; don't wait for a hung instrument
            w.kill()
        if wait:
            for w in workers:
                w.thread.join(timeout=5.0)
                proc = w.proc
                if proc is not None:
                    proc.join(timeout=5.0)

    def busy_seconds(self):
        with self._lock:
            return self._busy

    def _account(self, busy: float):
        with self._lock:
            self._busy += busy


BACKENDS["process"] = ProcessBackend
