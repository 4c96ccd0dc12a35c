"""Online-learning serving tier: inference under live traffic while MGD
re-trims the plant in the background.

The twin of the reference's ``serving/online.py``, class for class:

* **Serving** — requests are queued and batched into FIXED-SHAPE slots
  (``slots`` request lanes plus an alive mask; dead slots cycle zeros).
  The port predicts eagerly: ``ServiceConfig.jit_predict`` is kept for
  config parity and changes nothing (both values serve the same
  outputs).
* **Feedback logging** — every served request that carries feedback is
  appended to a bounded :class:`ReplayBuffer` (numpy rows, the
  reference's sidecar layout).
* **Background re-trim** — :class:`OnlineTrimmer` drives any registry
  driver through any ``hardware.Plant`` from replay samples, keyed on
  the global step, so the trim trajectory is a pure function of (buffer
  content, step) and checkpoint/resume replays it bit for bit (f32).
* **Snapshot-consistent swaps** — the trainer publishes parameters into
  a versioned :class:`ParamStore`; the dispatcher takes ONE snapshot per
  slot batch, so a response is computed entirely under one parameter
  tree.  Publishes come after ``fence()``, so the published tree is what
  landed on the device.
* **Checkpointing** — the trimmer checkpoints the ``{"params",
  "state"}`` driver-state tree through ``training.checkpoint``, with the
  replay ring in a sidecar ``replay_<step>.npz``.

Where things run: the service predicts on the device its params lie on,
and the trimmer's driver runs there too (the card unless the caller's
params are on the CPU).  The dispatcher and trainer threads share the
card's default stream; copying a response to the host waits for its
batch's device work, so a request's latency includes device time.  An
error in a predict call (a CUDA error too) fails every request of its
batch through their futures; an error in the trainer thread stops it and
is raised again by ``fence()``, ``stats()`` and ``close()``.

Lifecycle contract (shared with ``ExternalPlant`` and ``ChipFarm``):
``__enter__``/``__exit__``, idempotent ``close()``, and ``fence()``.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api.driver import MGDDriver, state_step
from repro_torch.core.utils import tree_leaves, tree_map
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_loop import resolve_driver

Pytree = Any

#: default bound on any blocking service operation — a serving tier must
#: degrade into a visible timeout, never a silent hang
DEFAULT_TIMEOUT_S = 60.0


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


# ---------------------------------------------------------------------------
# Versioned parameter store — the snapshot-consistency mechanism
# ---------------------------------------------------------------------------


class ParamSnapshot(NamedTuple):
    """One (version, params) pair.  Readers that hold a snapshot keep a
    complete, internally consistent tree no matter how many publishes
    happen while they decode with it."""

    version: int
    params: Pytree


class ParamStore:
    """Atomic published-parameter slot.

    ``publish`` swaps a single tuple reference under a lock;
    ``snapshot`` reads that one reference, so a reader never observes a
    mix of old and new leaves.  Torch tensors are mutable, where the
    reference's jax arrays are not: the store relies on every writer of
    the port being out of place (the MGD step and its update kernel, the
    plants' writes and drift, checkpoint restore), so a published tree is
    never written again (held in ``tests/test_torch_serving.py``).
    """

    def __init__(self, params: Pytree):
        self._lock = threading.Lock()
        self._snap = ParamSnapshot(0, params)

    def publish(self, params: Pytree) -> int:
        """Install ``params`` as the new serving tree; returns the new
        version.  Callers that drive a pipelined plant must ``fence()``
        first so the published tree is the landed one."""
        with self._lock:
            self._snap = ParamSnapshot(self._snap.version + 1, params)
            return self._snap.version

    def snapshot(self) -> ParamSnapshot:
        # one reference read — atomic; the lock only serializes writers
        return self._snap

    @property
    def version(self) -> int:
        return self._snap.version


# ---------------------------------------------------------------------------
# Bounded replay buffer — served traffic becomes training data
# ---------------------------------------------------------------------------


class ReplayBuffer:
    """Bounded ring of (input, feedback) examples logged from traffic.

    Examples are dicts of fixed-shape numpy rows (no leading batch dim);
    storage is allocated lazily from the first example's shapes/dtypes.
    ``sample`` draws with ``np.random.default_rng((seed, step))``, as the
    reference does, so both packages draw the same rows from the same
    buffer and a resumed trimmer replays the identical batch sequence.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._data: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._cursor = 0
        self._total = 0                 # lifetime adds (telemetry)

    def __len__(self) -> int:
        return self._size

    @property
    def total_added(self) -> int:
        return self._total

    def _allocate(self, example: Dict[str, np.ndarray]) -> None:
        self._data = {k: np.zeros((self.capacity,) + v.shape, v.dtype)
                      for k, v in example.items()}

    def add(self, example: Dict[str, Any]) -> None:
        """Append one example (dict of rows); oldest entry evicted when
        full."""
        rows = {k: np.asarray(v) for k, v in example.items()}
        with self._lock:
            if self._data is None:
                self._allocate(rows)
            if set(rows) != set(self._data):
                raise ValueError(
                    f"example keys {sorted(rows)} != buffer keys "
                    f"{sorted(self._data)}")
            for k, v in rows.items():
                self._data[k][self._cursor] = v
            self._cursor = (self._cursor + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)
            self._total += 1

    def add_batch(self, batch: Dict[str, Any]) -> None:
        """Append every row of a [B, ...] batch dict."""
        arrs = {k: np.asarray(v) for k, v in batch.items()}
        n = next(iter(arrs.values())).shape[0]
        for i in range(n):
            self.add({k: v[i] for k, v in arrs.items()})

    def sample(self, batch_size: int, step: int, *,
               seed: int = 0) -> Dict[str, np.ndarray]:
        """Draw ``batch_size`` examples (with replacement), keyed on
        (seed, step) — deterministic for a given buffer content."""
        with self._lock:
            if self._size == 0:
                raise ValueError("cannot sample from an empty replay buffer")
            rng = np.random.default_rng((int(seed), int(step)))
            idx = rng.integers(0, self._size, size=int(batch_size))
            return {k: v[idx].copy() for k, v in self._data.items()}

    # -- sidecar persistence (rides next to the driver-state checkpoint) ----

    def state(self) -> Dict[str, np.ndarray]:
        with self._lock:
            out = {"__size": np.int64(self._size),
                   "__cursor": np.int64(self._cursor),
                   "__total": np.int64(self._total)}
            if self._data is not None:
                out.update({f"data_{k}": v.copy()
                            for k, v in self._data.items()})
            return out

    def load_state(self, tree: Dict[str, np.ndarray]) -> None:
        with self._lock:
            data = {k[len("data_"):]: np.array(tree[k])
                    for k in tree if k.startswith("data_")}
            if data:
                cap = next(iter(data.values())).shape[0]
                if cap != self.capacity:
                    raise ValueError(
                        f"replay checkpoint capacity {cap} != configured "
                        f"{self.capacity}")
            self._data = data or None
            self._size = int(tree["__size"])
            self._cursor = int(tree["__cursor"])
            self._total = int(tree["__total"])

    def save_sidecar(self, path: str) -> None:
        np.savez(path, **self.state())

    def load_sidecar(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServiceConfig:
    """Loop-level knobs of :class:`OnlineService` (the serving twin of
    ``training.TrainLoopConfig``), field for field the reference's."""

    slots: int = 8                  # fixed decode-slot batch width
    queue_depth: int = 256          # bounded request queue (backpressure)
    batch_window_s: float = 0.002   # linger filling a slot batch
    jit_predict: bool = True        # parity only: the port predicts eagerly
    request_timeout_s: float = DEFAULT_TIMEOUT_S
    replay_capacity: int = 2048     # bounded feedback ring
    trim_batch: int = 8             # replay samples per trim step
    min_fill: int = 8               # examples required before trimming
    publish_every: int = 20         # trim steps between param publishes
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0       # trim steps between checkpoints
    resume: bool = True
    seed: int = 0                   # replay-sampling seed (counter-keyed)

    def replace(self, **kw) -> "ServiceConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TrimConfig:
    """What the background trimmer trains: an algorithm config (or a
    pre-built ``MGDDriver``) plus the model/device plumbing — the
    arguments ``repro_torch.driver`` takes at construction."""

    cfg: Any                        # DriverConfig | MGDConfig | MGDDriver
    loss_fn: Optional[Callable] = None
    plant: Any = None               # hardware.Plant (None → implicit ideal)
    algorithm: Optional[str] = None
    probe_fn: Optional[Callable] = None


# ---------------------------------------------------------------------------
# The background trimmer
# ---------------------------------------------------------------------------


class OnlineTrimmer:
    """Step-driven MGD re-trim over replay samples, with fenced
    publishes and driver-state checkpointing.

    The serving twin of ``train_mgd``'s inner loop: the same registry
    driver, the same ``{"params", "state"}`` checkpoint tree, the same
    fence-before-boundary discipline.  Driven synchronously (``step(n)``
    — deterministic, what the tests and gated benchmark rows use) or from
    the service's trainer thread.  The driver runs on the params' device
    (a pre-built driver on its own).
    """

    def __init__(self, trim: TrimConfig, params: Pytree,
                 replay: ReplayBuffer, store: ParamStore,
                 cfg: ServiceConfig):
        device = None if isinstance(trim.cfg, MGDDriver) \
            else _device_of(params)
        self._drv = resolve_driver(
            trim.loss_fn, trim.cfg, probe_fn=trim.probe_fn,
            plant=trim.plant, algorithm=trim.algorithm, device=device)
        self._device = self._drv.device or _device_of(params)
        self._replay = replay
        self._store = store
        self._cfg = cfg
        self._lock = threading.RLock()
        self._params = params
        self._state = self._drv.init(params)
        self._last_aux: Dict[str, Any] = {}
        self.steps_done = 0             # steps taken by THIS process
        self.publishes = 0

    @property
    def driver(self):
        return self._drv

    @property
    def plant(self):
        return self._drv.plant

    @property
    def params(self) -> Pytree:
        with self._lock:
            return self._params

    @property
    def state(self):
        """The driver state the next trim step starts from."""
        with self._lock:
            return self._state

    @property
    def global_step(self) -> int:
        with self._lock:
            return int(state_step(self._state))

    def fence(self) -> None:
        """Drain in-flight plant writes (pipelined farms) — the
        precondition for publishes, checkpoints and accuracy readouts.
        A no-op for plants without a fence."""
        plant_fence = getattr(self._drv.plant, "fence", None)
        if callable(plant_fence):
            plant_fence()

    # -- trimming -----------------------------------------------------------

    def ready(self) -> bool:
        return len(self._replay) >= max(self._cfg.min_fill, 1)

    def step(self, n: int = 1) -> int:
        """Run up to ``n`` trim steps; returns how many actually ran
        (0 when the replay buffer is below ``min_fill``).  Publish and
        checkpoint boundaries are pure functions of the global step, so
        a resumed trimmer replays the identical schedule."""
        took = 0
        for _ in range(n):
            with self._lock:
                if not self.ready():
                    break
                gstep = int(state_step(self._state))
                batch = self._replay.sample(
                    self._cfg.trim_batch, gstep, seed=self._cfg.seed)
                tbatch = {k: torch.as_tensor(v, device=self._device)
                          for k, v in batch.items()}
                with torch.no_grad():
                    self._params, self._state, self._last_aux = \
                        self._drv.step(self._params, self._state, tbatch)
                self.steps_done += 1
                took += 1
                done = gstep + 1
                if self._cfg.publish_every and \
                        done % self._cfg.publish_every == 0:
                    self.publish()
                if self._cfg.checkpoint_dir and self._cfg.checkpoint_every \
                        and done % self._cfg.checkpoint_every == 0:
                    self.save()
        return took

    # -- boundaries (fence first) ---------------------------------------------

    def publish(self) -> int:
        """Swap the trainer's parameters into the serving store,
        snapshot-consistently: fence the plant so every pipelined write
        has landed, then publish the whole tree in one atomic swap."""
        with self._lock:
            self.fence()
            version = self._store.publish(self._params)
            self.publishes += 1
            return version

    def save(self) -> Optional[str]:
        """Checkpoint the driver-state tree (+ replay sidecar)."""
        d = self._cfg.checkpoint_dir
        if not d:
            return None
        with self._lock:
            self.fence()
            step = int(state_step(self._state))
            # sidecar first: a crash between the two writes leaves an
            # orphan npz, never a checkpoint that references a missing one
            self._replay.save_sidecar(_sidecar_path(d, step))
            return ckpt.save(d, step,
                             {"params": self._params, "state": self._state},
                             extra={"algo": self._drv.algorithm,
                                    "service": True,
                                    "seed": int(self._cfg.seed)})

    def restore(self) -> Optional[int]:
        """Resume from the newest checkpoint under ``checkpoint_dir``;
        returns the restored global step (None when there is nothing to
        restore).  Parameters, driver state AND the replay ring come
        back, so the continued trajectory is the uninterrupted one."""
        d = self._cfg.checkpoint_dir
        if not d or ckpt.latest_step(d) is None:
            return None
        with self._lock:
            tree, _, step = ckpt.restore(
                d, {"params": self._params, "state": self._state})
            self._params, self._state = tree["params"], tree["state"]
            try:
                self._replay.load_sidecar(_sidecar_path(d, step))
            except FileNotFoundError:
                pass                     # pre-sidecar checkpoint: keep buffer
            return step

    def stats(self) -> Dict[str, Any]:
        """Telemetry, read without the trim lock: a trainer thread that
        steps back to back re-takes that lock at once, and a reader
        waiting on it would starve.  Each field is one reference read."""
        state, last_aux = self._state, self._last_aux
        aux = {k: float(v) for k, v in last_aux.items() if np.ndim(v) == 0}
        return {"global_step": int(state_step(state)),
                "steps_done": self.steps_done,
                "publishes": self.publishes,
                "replay_fill": len(self._replay),
                **{f"aux_{k}": v for k, v in aux.items()}}


def _sidecar_path(ckpt_dir: str, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    return os.path.join(ckpt_dir, f"replay_{step:012d}.npz")


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


class _Request(NamedTuple):
    inputs: Dict[str, Any]
    feedback: Optional[Dict[str, Any]]
    future: Future
    t0: float


class ServeResult(NamedTuple):
    """One served response: the output row (numpy), the parameter version
    that computed it (whole-tree consistent), and the request latency."""

    output: Any
    version: int
    latency_s: float


def _to_host(t):
    """A predict output on the host; bf16 comes back as f32 (numpy has no
    bfloat16, and the widening is exact)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class OnlineService:
    """Inference under live traffic with background MGD re-trim.

    ``predict_fn(params, batch) -> outputs`` maps a fixed-shape
    ``[slots, ...]`` batch dict of tensors (on the params' device) to
    outputs whose leading dim is the slot index.  ``trim=`` attaches an
    :class:`OnlineTrimmer`; without it the service is a plain batching
    inference tier.

    Thread layout: callers ``submit``; a dispatcher thread batches
    requests into slots and predicts them under ONE parameter snapshot
    per batch; an optional trainer thread runs the trimmer.  All threads
    are owned by the service and joined by ``close()``.
    """

    def __init__(self, predict_fn: Callable, params: Pytree,
                 cfg: Optional[ServiceConfig] = None, *,
                 trim: Optional[TrimConfig] = None,
                 name: str = "online-service"):
        self.cfg = cfg or ServiceConfig()
        self.name = name
        self._predict = predict_fn      # eager whatever cfg.jit_predict says
        self._device = _device_of(params)
        self.replay = ReplayBuffer(self.cfg.replay_capacity)
        self.trimmer: Optional[OnlineTrimmer] = None
        self.resumed_step: Optional[int] = None
        if trim is not None:
            # the trimmer never publishes during construction; the store
            # is rebuilt after a possible resume so version 0 is the tree
            # the service actually starts serving
            self.trimmer = OnlineTrimmer(trim, params, self.replay,
                                         ParamStore(params), self.cfg)
            if self.cfg.checkpoint_dir and self.cfg.resume:
                self.resumed_step = self.trimmer.restore()
            self._store = ParamStore(self.trimmer.params)
            self.trimmer._store = self._store
        else:
            self._store = ParamStore(params)
        self._queue: queue.Queue = queue.Queue(maxsize=self.cfg.queue_depth)
        self._stop = threading.Event()
        self._threads: list = []
        self._started = False
        self._closed = False
        self._lock = threading.Lock()
        self._served = 0
        self._batches = 0
        self._latencies: list = []      # rolling window (host-side floats)
        self._trim_error: Optional[BaseException] = None

    # -- lifecycle (uniform with ExternalPlant / ChipFarm) ------------------

    def start(self, *, background_trim: bool = True) -> "OnlineService":
        """Start the dispatcher (and, with a trimmer attached, the
        trainer thread).  Idempotent."""
        if self._closed:
            raise RuntimeError(f"{self.name}: service is closed")
        if self._started:
            return self
        self._started = True
        t = threading.Thread(target=self._dispatch_loop,
                             name=f"{self.name}-dispatch", daemon=True)
        t.start()
        self._threads.append(t)
        if self.trimmer is not None and background_trim:
            t = threading.Thread(target=self._trim_loop,
                                 name=f"{self.name}-trim", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self) -> None:
        """Stop threads, flush the queue (pending requests get a
        RuntimeError, never a hang), fence the plant.  Idempotent.  A
        trainer-thread error is raised here once everything is down."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for t in self._threads:
            t.join(timeout=DEFAULT_TIMEOUT_S)
        self._threads = []
        while True:                     # fail pending futures loudly
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            item.future.set_exception(
                RuntimeError(f"{self.name}: service closed"))
            self._queue.task_done()
        if self.trimmer is not None:
            self.trimmer.fence()
        self._raise_trim_error()

    def __enter__(self) -> "OnlineService":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def fence(self, timeout: Optional[float] = None) -> None:
        """Drain in-flight serving work (queued + mid-predict requests),
        then fence the trimmer's plant — after this, every submitted
        request has been answered and every parameter write has landed."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else DEFAULT_TIMEOUT_S)
        with self._queue.all_tasks_done:
            while self._queue.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._queue.all_tasks_done.wait(
                        timeout=remaining):
                    raise TimeoutError(
                        f"{self.name}: fence timed out with "
                        f"{self._queue.unfinished_tasks} requests in flight")
        self._raise_trim_error()
        if self.trimmer is not None:
            self.trimmer.fence()

    def _raise_trim_error(self) -> None:
        if self._trim_error is not None:
            raise RuntimeError(f"{self.name}: the trainer thread failed"
                               ) from self._trim_error

    # -- serving ------------------------------------------------------------

    @property
    def store(self) -> ParamStore:
        """The versioned serving-parameter store (read-mostly; writers
        must follow the fence-before-publish discipline)."""
        return self._store

    @property
    def version(self) -> int:
        return self._store.version

    def snapshot(self) -> ParamSnapshot:
        return self._store.snapshot()

    def submit(self, inputs: Dict[str, Any],
               feedback: Optional[Dict[str, Any]] = None) -> Future:
        """Enqueue one request (dict of per-example rows).  Returns a
        Future resolving to a :class:`ServeResult`.  ``feedback`` (e.g.
        the eventual label/cost target) is logged with the inputs into
        the replay buffer and becomes training signal for the trimmer."""
        if self._closed:
            raise RuntimeError(f"{self.name}: service is closed")
        if not self._started:
            raise RuntimeError(f"{self.name}: call start() (or use the "
                               f"service as a context manager) first")
        fut: Future = Future()
        item = _Request(inputs, feedback, fut, time.perf_counter())
        self._queue.put(item, timeout=self.cfg.request_timeout_s)
        return fut

    def serve(self, inputs: Dict[str, Any],
              feedback: Optional[Dict[str, Any]] = None,
              timeout: Optional[float] = None) -> ServeResult:
        """Synchronous ``submit`` + wait."""
        return self.submit(inputs, feedback).result(
            timeout=timeout if timeout is not None
            else self.cfg.request_timeout_s)

    # -- trimming (synchronous surface; the trainer thread uses the same) ---

    def trim(self, n: int = 1) -> int:
        """Run up to ``n`` trim steps synchronously; returns how many
        ran.  Deterministic — what tests and gated benchmarks drive."""
        if self.trimmer is None:
            raise RuntimeError(f"{self.name}: no trimmer attached "
                               f"(construct with trim=TrimConfig(...))")
        return self.trimmer.step(n)

    def publish(self) -> int:
        if self.trimmer is None:
            raise RuntimeError(f"{self.name}: no trimmer attached")
        return self.trimmer.publish()

    def stats(self) -> Dict[str, Any]:
        self._raise_trim_error()
        with self._lock:
            lat = np.asarray(self._latencies[-4096:], np.float64)
            out = {
                "served": self._served,
                "batches": self._batches,
                "version": self.version,
                "queue_depth": self._queue.qsize(),
                "latency_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                                   if lat.size else 0.0),
                "latency_p99_ms": (float(np.percentile(lat, 99)) * 1e3
                                   if lat.size else 0.0),
            }
        if self.trimmer is not None:
            out.update({f"trim_{k}": v
                        for k, v in self.trimmer.stats().items()})
        return out

    # -- internals ----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.perf_counter() + self.cfg.batch_window_s
            while len(items) < self.cfg.slots:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._serve_batch(items)
            for _ in items:
                self._queue.task_done()

    def _pad_slots(self, items):
        """Pack ragged request rows into the fixed [slots, ...] batch
        with an alive mask — dead slots cycle zeros."""
        slots = self.cfg.slots
        batch = {}
        for k in items[0].inputs:
            rows = [np.asarray(it.inputs[k]) for it in items]
            ref = rows[0]
            arr = np.zeros((slots,) + ref.shape, ref.dtype)
            for i, r in enumerate(rows):
                if r.shape != ref.shape or r.dtype != ref.dtype:
                    raise ValueError(
                        f"request {i}: key {k!r} has shape {r.shape} "
                        f"dtype {r.dtype}, slot expects {ref.shape} "
                        f"{ref.dtype} — fixed-shape serving pads ragged "
                        f"inputs caller-side (see serving.decode)")
                arr[i] = r
            batch[k] = torch.as_tensor(arr, device=self._device)
        alive = np.zeros((slots,), bool)
        alive[:len(items)] = True
        return batch, alive

    def _serve_batch(self, items) -> None:
        # ONE snapshot for the whole batch: every response in it was
        # computed under a single complete parameter tree
        snap = self._store.snapshot()
        try:
            batch, _alive = self._pad_slots(items)
            with torch.no_grad():
                out = tree_map(_to_host, self._predict(snap.params, batch))
        except Exception as e:          # noqa: BLE001 — surfaced per-request
            for it in items:
                it.future.set_exception(e)
            return
        t_done = time.perf_counter()
        lats = []
        for i, it in enumerate(items):
            row = tree_map(lambda a: a[i], out)
            lat = t_done - it.t0
            lats.append(lat)
            if it.feedback is not None:
                self.replay.add({**it.inputs, **it.feedback})
            it.future.set_result(ServeResult(row, snap.version, lat))
        with self._lock:
            self._served += len(items)
            self._batches += 1
            self._latencies.extend(lats)
            if len(self._latencies) > 65536:
                del self._latencies[:-4096]

    def _trim_loop(self) -> None:
        try:
            while not self._stop.is_set():
                took = self.trimmer.step(4)
                if not took:
                    self._stop.wait(timeout=0.005)
        except Exception as e:          # noqa: BLE001 — raised by fence/close
            self._trim_error = e


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------


def serve(cfg: Optional[ServiceConfig], predict_fn: Callable,
          params: Pytree, *, trim: Optional[TrimConfig] = None,
          start: bool = True, name: str = "online-service") -> OnlineService:
    """Build (and by default start) an :class:`OnlineService` — the
    canonical serving entry point, re-exported as ``repro_torch.serve``:

        svc = repro_torch.serve(ServiceConfig(slots=8), predict_fn, params,
                                trim=TrimConfig(DriverConfig(...), loss_fn,
                                                plant=farm))
        result = svc.serve({"x": x}, feedback={"y": y})

    The service runs where ``params`` lie (the card, from the port's
    inits, unless they were made with ``device="cpu"``).  Pass
    ``cfg=None`` for defaults; ``start=False`` to wire threads up later
    (tests that drive the service synchronously do this).
    """
    svc = OnlineService(predict_fn, params, cfg, trim=trim, name=name)
    return svc.start() if start else svc
