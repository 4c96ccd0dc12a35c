"""Fault injection + fault policy for the host-side hardware boundary.

The port's copy of ``repro.hardware.faults`` (host-side numpy and the
standard library, so the same code and the same draws).

Real instruments do not fail like Gaussian noise: they hang (a serial
link drops mid-transaction), they crash (a driver raises), and they
return garbage (a spiked ADC reads NaN or a full-scale outlier with no
exception to signal it).  The paper's deployment endgame — and the
scaling follow-up's k-chip probe parallelism (Oripov et al. 2025) —
multiplies that fault surface by k: one hung chip in a farm deadlocks
the whole training step at the host boundary, and one silent NaN
corrupts the averaged update ``−η·(1/k)ΣC̃_k·θ̃_k/Δθ²`` for every chip.

This module provides both sides of the robustness story:

* ``FaultSpec`` / ``FaultyChip`` — a composable wrapper over ANY host
  device (simulated, drifting, or a test fake) that injects
  counter-keyed, bit-reproducible faults: hangs, transient exceptions,
  NaN/Inf costs, stuck-at costs, outlier spikes, and intermittent flaky
  windows.  Fault draws are keyed on ``(fault seed, step, tag,
  attempt)``, so two identically-seeded runs inject the identical fault
  schedule, a RETRY of the same readout draws fresh (a transient fault
  clears on the next attempt, like a real glitch), and a resumed run
  replays the same faults at the same steps.
* ``FaultPolicy`` — the host boundary's tolerance configuration:
  per-read timeout, retry count with exponential backoff, non-finite
  rejection, quarantine threshold and re-probe period, and the robust
  aggregation mode the step applies to the gathered cost scalars
  (``core.probe_parallel``).  Frozen/hashable: the step builder reads
  it once, at build time.
* ``ChipHealth`` / ``FarmHealth`` — the per-chip health registry:
  consecutive-failure counts, EWMA latency, quarantine state and
  readmission bookkeeping.  Quarantine gates the PROBE path only: the
  farm keeps committing parameter writes to a quarantined chip (writes
  are cheap and keep it current for readmission), and periodically
  re-probes it; a successful re-probe readmits the chip with its
  counter-keyed noise stream untouched (device noise is a function of
  (step, tag), not of how many reads happened in between).
* ``FaultLog`` — a thread-safe record of every injected and observed
  fault event (injections, timeouts, errors, retries, quarantines,
  readmissions), for benchmarks and postmortems.
* ``guarded_call`` — the one retry/timeout primitive both ``ChipFarm``
  and ``ExternalPlant`` route device transactions through.

Everything here is host-side numpy/stdlib: it never creates a tensor,
so it runs unchanged in the process backend's forked workers.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, List, Optional, Tuple

import numpy as np

#: Gathers at the host boundary NEVER block forever: even without a
#: ``FaultPolicy``, every ``future.result`` passes this generous timeout
#: so a hung instrument surfaces as a diagnosable ``ChipFaultError``
#: instead of an un-interruptible hang of the training step.
DEFAULT_TIMEOUT_S = 120.0


class ChipFaultError(RuntimeError):
    """A device transaction failed at the host boundary (timeout,
    worker exception, or non-finite readout), annotated with the chip
    index / device name the bare traceback would omit."""


class InjectedFault(RuntimeError):
    """An exception deliberately raised by ``FaultyChip`` (transient
    instrument crash, or a hang released after its sleep)."""


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-readout fault probabilities for ``FaultyChip``.

    Each readout attempt draws ONE fault kind (or none) from a generator
    keyed on ``(fault seed, step, tag, attempt)`` — bit-reproducible
    across runs, fresh per retry.  Probabilities must sum to ≤ 1.

    ``fail_attempts`` is the deterministic variant for tests: the first
    ``fail_attempts`` attempts at any (step, tag) raise a transient
    fault, later attempts pass through (no RNG involved).

    ``only_steps=(lo, hi)`` restricts injection to the half-open step
    range; ``flaky_every``/``flaky_for`` model an intermittently flaky
    instrument (faults active only while ``step % flaky_every <
    flaky_for``).  Readouts without (step, tag) counters — the bench
    harness — are never faulted: injection is a property of the
    *training* I/O stream.
    """

    transient: float = 0.0     # P(raise InjectedFault)
    hang: float = 0.0          # P(sleep hang_s, then raise — link dropped)
    hang_s: float = 0.5        # how long a hang holds the worker thread
    nan: float = 0.0           # P(return NaN cost)
    inf: float = 0.0           # P(return +Inf cost)
    stuck: float = 0.0         # P(return stuck_value regardless of input)
    stuck_value: float = 0.0
    outlier: float = 0.0       # P(true cost ± outlier_scale spike)
    outlier_scale: float = 100.0
    fail_attempts: int = 0     # deterministic: fail the first n attempts
    only_steps: Optional[Tuple[int, int]] = None
    flaky_every: int = 0
    flaky_for: int = 0

    def __post_init__(self):
        probs = (self.transient, self.hang, self.nan, self.inf,
                 self.stuck, self.outlier)
        if any(not 0.0 <= p <= 1.0 for p in probs):
            raise ValueError(f"fault probabilities must be in [0, 1]: {self}")
        if sum(probs) > 1.0 + 1e-9:
            raise ValueError(
                f"fault probabilities sum to {sum(probs)} > 1: {self}")
        if self.fail_attempts < 0:
            raise ValueError(f"fail_attempts must be >= 0, "
                             f"got {self.fail_attempts}")
        if self.flaky_every < 0 or self.flaky_for < 0:
            raise ValueError("flaky_every/flaky_for must be >= 0")

    def active(self, step: int) -> bool:
        """Whether injection is live at optimizer ``step``."""
        if self.only_steps is not None:
            lo, hi = self.only_steps
            if not lo <= step < hi:
                return False
        if self.flaky_every:
            return (step % self.flaky_every) < self.flaky_for
        return True


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected or observed fault (``FaultLog`` entry)."""

    kind: str                  # inject-* | timeout | error | nonfinite |
    chip: str                  # retry-exhausted | quarantine | readmit |
    step: Optional[int]        # write-error | accuracy-error
    tag: Optional[int]
    attempt: int = 0
    detail: str = ""


class FaultLog:
    """Thread-safe append-only record of fault events."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: List[FaultEvent] = []

    def record(self, kind: str, chip: Any, *, step=None, tag=None,
               attempt: int = 0, detail: str = "") -> None:
        event = FaultEvent(
            kind=kind, chip=str(chip),
            step=None if step is None else int(step),
            tag=None if tag is None else int(tag),
            attempt=int(attempt), detail=str(detail)[:300])
        with self._lock:
            self.events.append(event)

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)

    def counts(self) -> dict:
        """Event counts by kind (telemetry/benchmarks)."""
        with self._lock:
            out: dict = {}
            for e in self.events:
                out[e.kind] = out.get(e.kind, 0) + 1
            return out

    def drain(self) -> List[FaultEvent]:
        """Return AND clear the recorded events — how a worker-local log
        (process/cluster farm backends) ships its entries back to the
        host with each reply, so the farm's log sees one merged stream."""
        with self._lock:
            events, self.events = self.events, []
            return events

    def extend(self, events) -> None:
        """Fold events shipped from a worker-local log into this one."""
        with self._lock:
            self.events.extend(events)


class FaultyChip:
    """Composable fault-injecting wrapper over any host device.

    Mirrors the wrapped device's capability surface so ``ExternalPlant``
    / ``ChipFarm`` signature inspection sees the same instrument:
    ``set_params`` accepts ``step`` (forwarded only if the inner device
    does), ``measure_cost`` accepts counters, and ``measure_pair`` /
    ``measure_accuracy`` exist exactly when the inner device has them.
    Faults are injected on the counter-carrying READOUT path only —
    writes and bench readouts pass through untouched.

    ``readouts`` counts every readout attempt (including faulted ones);
    ``injected`` counts injections — both feed the fault-tolerance
    benchmark's quarantine-efficiency metrics.
    """

    def __init__(self, device: Any, spec: Optional[FaultSpec] = None, *,
                 seed: int = 0, log: Optional[FaultLog] = None,
                 name: Optional[str] = None):
        for attr in ("set_params", "measure_cost"):
            if not callable(getattr(device, attr, None)):
                raise TypeError(f"FaultyChip wraps a device exposing "
                                f"{attr}(); got {type(device).__name__}")
        from .external import accepts_counters, accepts_step
        self.device = device
        self.spec = spec or FaultSpec()
        self.log = log
        self.name = name or f"faulty:{type(device).__name__}:{seed}"
        self._seed = int(seed)
        self._lock = threading.Lock()
        self._attempts: dict = {}
        self.readouts = 0
        self.injected = 0
        self._inner_counters = accepts_counters(device.measure_cost)
        self._inner_write_step = accepts_step(device.set_params)
        pair = getattr(device, "measure_pair", None)
        if callable(pair):
            self._inner_pair = pair
            self._inner_pair_counters = accepts_counters(pair)
            # instance attribute, so the capability probe
            # (callable(getattr(dev, "measure_pair", None))) mirrors
            # the inner device
            self.measure_pair = self._measure_pair_impl
        acc = getattr(device, "measure_accuracy", None)
        if callable(acc):
            self._inner_acc = acc
            self._inner_acc_step = accepts_step(acc)
            self.measure_accuracy = self._measure_accuracy_impl

    # -- pass-through surface ------------------------------------------------

    @property
    def writes(self) -> int:
        return int(getattr(self.device, "writes", 0))

    @property
    def meta(self):
        return getattr(self.device, "meta", None)

    def set_params(self, params, *, step=None):
        """Persistent write — never faulted, step forwarded when the
        inner device timestamps writes (drifting chips)."""
        if self._inner_write_step and step is not None:
            self.device.set_params(params, step=int(step))
        else:
            self.device.set_params(params)

    # -- fault engine --------------------------------------------------------

    def _draw(self, step, tag):
        """(kind, rng) for this attempt, or (None, None) when healthy.
        Counter-keyed: the SAME (seed, step, tag, attempt) always draws
        the same fault, a retry (attempt+1) draws fresh."""
        if step is None or tag is None:
            return None, None
        step, tag = int(step), int(tag)
        if not self.spec.active(step):
            return None, None
        with self._lock:
            key = (step, tag)
            attempt = self._attempts.get(key, 0)
            self._attempts[key] = attempt + 1
            if len(self._attempts) > 4096:   # keep the map bounded
                self._attempts = {k: v for k, v in self._attempts.items()
                                  if k[0] >= step - 2}
        if attempt < self.spec.fail_attempts:
            return "transient", None
        rng = np.random.default_rng(
            (self._seed, step, tag, attempt, 0xFA))
        u = rng.random()
        for kind, p in (("hang", self.spec.hang),
                        ("transient", self.spec.transient),
                        ("nan", self.spec.nan), ("inf", self.spec.inf),
                        ("stuck", self.spec.stuck),
                        ("outlier", self.spec.outlier)):
            if u < p:
                return kind, rng
            u -= p
        return None, None

    def _record(self, kind, step, tag, detail=""):
        with self._lock:
            self.injected += 1
        if self.log is not None:
            self.log.record(f"inject-{kind}", self.name, step=step,
                            tag=tag, detail=detail)

    def _raise_if_crash(self, kind, step, tag):
        if kind == "hang":
            self._record(kind, step, tag,
                         f"held worker {self.spec.hang_s}s")
            time.sleep(self.spec.hang_s)
            raise InjectedFault(
                f"{self.name}: link dropped (hang released after "
                f"{self.spec.hang_s}s) at step={step} tag={tag}")
        if kind == "transient":
            self._record(kind, step, tag)
            raise InjectedFault(
                f"{self.name}: transient instrument fault at "
                f"step={step} tag={tag}")

    # -- faulted readouts ----------------------------------------------------

    def measure_cost(self, batch, *, step=None, tag=None):
        with self._lock:
            self.readouts += 1
        kind, rng = self._draw(step, tag)
        self._raise_if_crash(kind, step, tag)
        if kind == "nan":
            self._record(kind, step, tag)
            return float("nan")
        if kind == "inf":
            self._record(kind, step, tag)
            return float("inf")
        if kind == "stuck":
            self._record(kind, step, tag)
            return float(self.spec.stuck_value)
        if self._inner_counters:
            c = self.device.measure_cost(batch, step=step, tag=tag)
        else:
            c = self.device.measure_cost(batch)
        if kind == "outlier":
            sign = 1.0 if rng.random() < 0.5 else -1.0
            self._record(kind, step, tag, f"spike {sign:+.0f}")
            return float(c) + sign * self.spec.outlier_scale
        return c

    def _measure_pair_impl(self, theta, batch, *, step=None, tag=None):
        with self._lock:
            self.readouts += 1
        kind, rng = self._draw(step, tag)
        self._raise_if_crash(kind, step, tag)
        if kind in ("nan", "inf"):
            self._record(kind, step, tag)
            v = float("nan") if kind == "nan" else float("inf")
            return v, v
        if kind == "stuck":
            self._record(kind, step, tag)
            return float(self.spec.stuck_value), float(self.spec.stuck_value)
        if self._inner_pair_counters:
            c_plus, c_minus = self._inner_pair(theta, batch, step=step,
                                               tag=tag)
        else:
            c_plus, c_minus = self._inner_pair(theta, batch)
        if kind == "outlier":
            sign = 1.0 if rng.random() < 0.5 else -1.0
            self._record(kind, step, tag, f"spike {sign:+.0f}")
            return float(c_plus) + sign * self.spec.outlier_scale, c_minus
        return c_plus, c_minus

    def _measure_accuracy_impl(self, batch, *, step=None):
        """Bench readout — never faulted (injection models the training
        I/O stream, not the experimenter's scope)."""
        if self._inner_acc_step:
            return self._inner_acc(batch, step=step)
        return self._inner_acc(batch)


# ---------------------------------------------------------------------------
# Fault policy + health registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Host-boundary tolerance configuration (frozen → hashable, safe to
    close over at trace time for the ``aggregate`` mode).

    Boundary knobs (host-side, applied per device transaction):

    * ``timeout_s`` — per-attempt deadline; a hung chip stalls its step
      by at most this (times retries), never forever.
    * ``retries`` / ``backoff_s`` / ``backoff_factor`` / ``backoff_max_s``
      — retry-with-exponential-backoff.  Retries re-run the WHOLE
      transaction (write + read) against the same (step, tag) counters,
      so a successful retry yields the identical counter-keyed readout a
      fault-free run would have seen — the trajectory stays a pure
      function of the gathered costs.
    * ``reject_nonfinite`` — treat NaN/Inf readouts as failures (retry,
      then mask) instead of letting them corrupt the averaged update.
    * ``quarantine_after`` — consecutive exhausted probe rounds before a
      chip is quarantined (0 = never).  ``reprobe_every`` — steps
      between readmission probes of a quarantined chip.

    Step knob (read by ``core.probe_parallel`` at build time):

    * ``aggregate`` — ``"none"`` | ``"mad"`` (MAD-based outlier
      rejection over the 2k gathered cost scalars) | ``"trimmed"``
      (symmetric trimmed mean over the k C̃ values), with
      ``mad_threshold`` / ``trim_frac`` as their parameters.  This is
      the silent-corruption guard: a spiked-but-finite cost raises no
      exception at the boundary, only the statistics can reject it.
    """

    timeout_s: float = 30.0
    retries: int = 2
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    reject_nonfinite: bool = True
    quarantine_after: int = 0
    reprobe_every: int = 50
    aggregate: str = "none"
    mad_threshold: float = 6.0
    trim_frac: float = 0.2
    latency_alpha: float = 0.2     # EWMA weight for per-chip latency

    def __post_init__(self):
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.quarantine_after < 0:
            raise ValueError(f"quarantine_after must be >= 0, "
                             f"got {self.quarantine_after}")
        if self.reprobe_every < 1:
            raise ValueError(f"reprobe_every must be >= 1, "
                             f"got {self.reprobe_every}")
        if self.aggregate not in ("none", "mad", "trimmed"):
            raise ValueError(f"aggregate must be 'none', 'mad' or "
                             f"'trimmed', got {self.aggregate!r}")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(f"trim_frac must be in [0, 0.5), "
                             f"got {self.trim_frac}")
        if not 0.0 < self.latency_alpha <= 1.0:
            raise ValueError(f"latency_alpha must be in (0, 1], "
                             f"got {self.latency_alpha}")

    def backoff_for(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (attempt >= 1)."""
        return min(self.backoff_s * self.backoff_factor ** (attempt - 1),
                   self.backoff_max_s)

    def round_deadline_s(self) -> float:
        """Worst-case wall-clock of one full probe round (all retries +
        backoffs) — the explicit outer-gather timeout."""
        backoffs = sum(self.backoff_for(a)
                       for a in range(1, self.retries + 1))
        return (self.retries + 1) * self.timeout_s + backoffs + 60.0


@dataclasses.dataclass
class ChipHealth:
    """Mutable per-chip health record.  Only that chip's supervisor
    thread touches it within a step (the host serializes steps),
    so no per-field locking is needed."""

    chip: int
    name: str = ""
    successes: int = 0
    failures: int = 0              # exhausted probe rounds
    attempts_failed: int = 0       # individual failed attempts
    timeouts: int = 0
    consecutive_failures: int = 0
    ewma_latency_s: Optional[float] = None
    quarantined: bool = False
    quarantined_at: Optional[int] = None
    next_reprobe: Optional[int] = None
    readmissions: int = 0

    def record_success(self, latency_s: float, alpha: float) -> None:
        self.successes += 1
        self.consecutive_failures = 0
        if self.ewma_latency_s is None:
            self.ewma_latency_s = float(latency_s)
        else:
            self.ewma_latency_s = ((1.0 - alpha) * self.ewma_latency_s
                                   + alpha * float(latency_s))

    def record_failure(self) -> None:
        self.failures += 1
        self.consecutive_failures += 1

    def skip(self, step: int) -> bool:
        """Quarantined and not yet due a readmission probe — the fast
        path: no I/O at all this step."""
        return self.quarantined and (self.next_reprobe is None
                                     or int(step) < self.next_reprobe)

    def enter_quarantine(self, step: int, policy: FaultPolicy) -> None:
        self.quarantined = True
        self.quarantined_at = int(step)
        self.next_reprobe = int(step) + policy.reprobe_every

    def readmit(self) -> None:
        self.quarantined = False
        self.quarantined_at = None
        self.next_reprobe = None
        self.readmissions += 1


class FarmHealth:
    """The farm's per-chip health registry."""

    def __init__(self, names):
        self.chips = [ChipHealth(i, str(n)) for i, n in enumerate(names)]

    def live(self):
        return [h.chip for h in self.chips if not h.quarantined]

    def summary(self) -> dict:
        return {
            "quarantined": [h.chip for h in self.chips if h.quarantined],
            "readmissions": sum(h.readmissions for h in self.chips),
            "failures": sum(h.failures for h in self.chips),
            "timeouts": sum(h.timeouts for h in self.chips),
            "ewma_latency_s": {
                h.chip: round(h.ewma_latency_s, 6)
                for h in self.chips if h.ewma_latency_s is not None},
        }


# ---------------------------------------------------------------------------
# The one retry/timeout primitive
# ---------------------------------------------------------------------------


def guarded_call(pool, fn, args, *, policy: FaultPolicy, label: str,
                 log: Optional[FaultLog] = None,
                 health: Optional[ChipHealth] = None,
                 step=None, tag=None):
    """Run one device transaction under ``policy``: submit attempts to
    ``pool``, bound each by ``policy.timeout_s``, retry with exponential
    backoff, reject non-finite readouts.  Returns ``(value, latency_s,
    None)`` on success or ``(None, None, last_error)`` after exhausting
    retries.  Per-attempt failures are logged and counted on ``health``;
    step-level success/failure bookkeeping stays with the caller.
    """
    last: Optional[Exception] = None
    for attempt in range(policy.retries + 1):
        if attempt:
            time.sleep(policy.backoff_for(attempt))
        future = pool.submit(fn, *args)
        t0 = time.monotonic()
        try:
            out = future.result(timeout=policy.timeout_s)
        except _FuturesTimeout:
            future.cancel()
            last = ChipFaultError(
                f"{label}: no response within timeout_s="
                f"{policy.timeout_s}s at step={step} (attempt {attempt})")
            kind = "timeout"
        except Exception as e:   # noqa: BLE001 — any worker failure
            last, kind = e, "error"
        else:
            if policy.reject_nonfinite and not np.all(
                    np.isfinite(np.asarray(out, np.float64))):
                last = ChipFaultError(
                    f"{label}: non-finite readout {out!r} at step={step}")
                kind = "nonfinite"
            else:
                return out, time.monotonic() - t0, None
        if health is not None:
            health.attempts_failed += 1
            if kind == "timeout":
                health.timeouts += 1
        if log is not None:
            log.record(kind, label, step=step, tag=tag, attempt=attempt,
                       detail=str(last))
    return None, None, last
