"""Thread backend: one long-lived runner thread per chip.

In-process execution (live device instances work unchanged — the
default) with each chip's OWN serial runner thread fed by a FIFO queue.
That buys two things a shared thread pool could not:

* **Per-chip ordering for free** — the double-buffered pipeline enqueues
  step N+1's ``write`` and returns; the following ``pair`` op sits
  behind it in the same queue, so the device is always written before
  it is probed, with no host-side synchronization.
* **Structured abandonment** — when the fault policy times an op out,
  ``abandon(i)`` marks the runner stale and starts a replacement.  The
  zombie thread stays parked inside the hung instrument call (Python
  cannot kill a thread — that is the process backend's upgrade), but it
  can no longer resolve tasks or steal queued ones: pending ops migrate
  to the replacement's fresh queue, and the zombie exits at the next
  loop check once the instrument releases it.

GIL caveat (the reason the process backend exists): runner threads give
CONCURRENCY, not parallelism.  Devices that hold the GIL during their
transactions — pure-Python instrument drivers, ``SimulatedAnalogChip(
py_busy_ms=...)`` — serialize to k× single-chip wall-clock here;
numpy-heavy devices (which release the GIL inside BLAS) scale fine.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from ..faults import ChipFaultError
from .base import BACKENDS, ChipOps, FarmBackend, Task

#: Queue sentinel: tells a runner (stale or live) to exit.
_STOP = object()


class _Runner:
    """One chip's serial executor: a daemon thread draining a FIFO of
    ``(op, payload, Task)`` triples.  ``stale`` flips when the backend
    abandons this runner — after the in-flight device call returns, the
    zombie fails its task (if still unresolved) and exits instead of
    touching the queue again."""

    def __init__(self, backend: "ThreadBackend", chip: int, ops: ChipOps,
                 generation: int):
        self.backend = backend
        self.chip = chip
        self.ops = ops
        self.generation = generation
        self.stale = False
        self.queue: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(
            target=self._loop, name=f"chip-farm-{chip}-g{generation}",
            daemon=True)
        self.thread.start()

    def _loop(self):
        while True:
            item = self.queue.get()  # mgdlint: disable=MGD003 (idle FIFO wait; the _STOP sentinel always wakes it on shutdown)
            if item is _STOP:
                return
            if self.stale:
                # replaced while parked in get(): hand the op to the
                # live runner and exit
                self.backend._requeue(self.chip, item)
                return
            op, payload, task = item
            t0 = time.perf_counter()
            try:
                value = self.ops.run(op, payload)
            except Exception as e:      # noqa: BLE001 — device failure
                err: Optional[BaseException] = e
                value = None
            else:
                err = None
            busy = time.perf_counter() - t0
            if self.stale:
                # abandoned mid-call: the supervisor moved on, nothing
                # may consume a zombie's result
                task.set_exception(ChipFaultError(
                    f"chip {self.chip}: op {op!r} abandoned after "
                    f"{busy:.3f}s (worker replaced)"), busy)
                continue                # next get() sees _STOP
            self.backend._account(busy)
            if err is not None:
                task.set_exception(err, busy)
            else:
                task.set_result(value, busy)


class ThreadBackend(FarmBackend):
    """One runner thread per chip; accepts live device instances or
    ``DeviceSpec``s (specs build in-process against the host log)."""

    accepts_instances = True

    def __init__(self):
        self._runners: List[_Runner] = []
        self._lock = threading.Lock()
        self._busy = 0.0
        self._down = False

    def start(self, entries, *, fault_log=None):
        ops = self._build_ops(entries, fault_log)
        self._runners = [_Runner(self, i, op, generation=0)
                         for i, op in enumerate(ops)]
        return [op.caps() for op in ops]

    def submit(self, i, op, payload):
        task = Task()
        if self._down:
            task.set_exception(ChipFaultError(
                f"chip {i}: farm backend is shut down"))
            return task
        with self._lock:
            runner = self._runners[i]
        runner.queue.put((op, payload, task))
        return task

    def abandon(self, i):
        """Replace chip ``i``'s runner.  Pending queued ops migrate to
        the replacement; the zombie parks until the instrument releases
        it, then exits without resolving anything."""
        with self._lock:
            old = self._runners[i]
            old.stale = True
            new = _Runner(self, i, old.ops, old.generation + 1)
            # the zombie is blocked inside the hung device call, not in
            # get(), so draining its queue here does not race a consumer
            while True:
                try:
                    new.queue.put(old.queue.get_nowait())
                except queue.Empty:
                    break
            old.queue.put(_STOP)
            self._runners[i] = new

    def _requeue(self, i, item):
        with self._lock:
            self._runners[i].queue.put(item)

    def shutdown(self, wait=False):
        if self._down:
            return
        self._down = True
        with self._lock:
            runners = list(self._runners)
        for r in runners:
            r.queue.put(_STOP)
        if wait:
            for r in runners:
                r.thread.join(timeout=5.0)

    def busy_seconds(self):
        with self._lock:
            return self._busy

    def _account(self, busy: float):
        with self._lock:
            self._busy += busy


BACKENDS["thread"] = ThreadBackend
