"""Chip-in-the-loop: a plant on the far side of a host boundary.

``ExternalPlant`` wraps any host-side device object exposing the minimal
lab-instrument API

    device.set_params(params)          # persistent analog write
    device.measure_cost(batch) -> float  # present input, read ONE scalar

and turns it into a ``Plant`` the MGD step can drive.  The port's step
is eager, so where the reference lowers a read to an ordered
``io_callback`` this one is a plain host transaction:

1. copy the params (and the batch) to host numpy — ``.detach().float()
   .cpu().numpy()``, since numpy has no bfloat16; on the card this is a
   device→host copy that waits for the step's queued work;
2. ``set_params`` then ``measure_cost`` (or ``measure_pair``) on the
   device object;
3. return the reading as a 0-dim float32 tensor on the params' device.

The optimizer never sees device internals — defects, write noise and
readout noise all live in the host object (paper §4/§6).

Three optional device capabilities refine the boundary:

* ``measure_cost(batch, *, step, tag)`` — devices whose readout noise is
  counter-keyed accept the optimizer's (step, tag) pair, so the +/−
  probe reads of a central pair are distinguishable and a restarted run
  replays the identical noise stream.  The signature is inspected ONCE
  at construction; plain 1-arg devices keep working unchanged.
* ``measure_pair(theta, batch, *, step, tag) -> (C₊, C₋)`` — a
  differential probe line: the perturbation θ̃ is applied transiently at
  the parameter, never through the persistent write path, so a central
  pair costs ONE ``set_params`` of the base θ and one host round trip.
* ``set_params(params, *, step)`` — drifting devices timestamp every
  persistent write with the optimizer's step counter.

External plants run the one step the reference lets them ride:
``MGDConfig(mode="central", tau_theta=1)`` without replay
(``build_mgd_step`` refuses the rest).  The reference's reason is its
traced step — ordered callbacks cannot sit inside ``lax.cond`` — and an
eager step has no such limit, but lifting the refusal would give the
port a feature the JAX package lacks, so it stays.

Host devices must be NUMPY-PURE: they run on the host's threads or in
forked worker processes, where a CUDA call would fail.

Real instruments hang and crash.  ``fault_policy=FaultPolicy(...)``
bounds every device transaction by a timeout and retries it with
exponential backoff through ``faults.guarded_call``; because readout
noise is counter-keyed on (step, tag), a successful retry is
bit-identical to the read a fault-free run would have produced.  A
single chip that exhausts its retries raises ``ChipFaultError`` with the
device name and counters attached (masking out a failed read needs a
farm — see ``farm.ChipFarm``).
"""
from __future__ import annotations

import inspect
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.utils import tree_leaves, tree_map

from .base import Plant, PlantMeta
from .faults import ChipFaultError, FaultLog, FaultPolicy, guarded_call


def accepts_counters(fn) -> bool:
    """True when ``fn`` accepts the optimizer's ``step``/``tag`` keywords
    (directly or through **kwargs).  Inspected once at plant construction
    — a per-read signature probe would sit on the training hot loop."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):     # builtins/C callables: be safe
        return False
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return True
    return "step" in params and "tag" in params


def accepts_step(fn) -> bool:
    """True when ``fn`` (a device's ``set_params``) accepts the optimizer's
    ``step`` keyword — drifting devices timestamp each persistent write so
    readouts know how long the stored weights have been aging.  Inspected
    once at construction, like ``accepts_counters``."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):     # builtins/C callables: be safe
        return False
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return True
    return "step" in params


def check_device(device: Any) -> None:
    """Validate the minimal lab-instrument surface of ``device``."""
    for attr in ("set_params", "measure_cost"):
        if not callable(getattr(device, attr, None)):
            raise TypeError(
                f"external device must expose {attr}(); got "
                f"{type(device).__name__}")


def _host_leaf(x, as_f32: bool):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if as_f32 or x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x, np.float32) if as_f32 else x


def host_params(tree):
    """Params (or perturbations) as host float32 numpy arrays."""
    return tree_map(lambda x: _host_leaf(x, True), tree)


def host_batch(tree):
    """A batch as host numpy: float tensors become float32, integer ones
    keep their dtype; non-tensor leaves pass through."""
    return tree_map(lambda x: _host_leaf(x, False), tree)


def device_of(tree) -> torch.device:
    """Where the step's tensors live: the first tensor leaf's device (the
    CPU for a tree of host arrays)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class ExternalPlant(Plant):
    """Host boundary around an opaque device object.

    **Fault tolerance** (``fault_policy=hardware.FaultPolicy(...)``):
    every device transaction (write + read, as one unit) runs on a side
    thread bounded by ``timeout_s`` and retried with exponential backoff
    — a retry re-runs the whole transaction against the same (step, tag)
    counters, so a successful retry returns the identical counter-keyed
    readout a fault-free run would have seen.  A single chip has no
    farm to mask it, so exhausting the retries raises ``ChipFaultError``
    (naming the device, step and tag) instead of hanging or surfacing an
    anonymous worker traceback.  Without a policy, device exceptions are
    still re-raised with the device name attached.
    """

    def __init__(self, device: Any, *, meta: Optional[PlantMeta] = None,
                 fault_policy: Optional[FaultPolicy] = None,
                 fault_log: Optional[FaultLog] = None):
        check_device(device)
        if fault_policy is not None and not isinstance(fault_policy,
                                                       FaultPolicy):
            raise TypeError(f"fault_policy must be a hardware.FaultPolicy, "
                            f"got {type(fault_policy).__name__}")
        self.device = device
        self.policy = fault_policy
        self.fault_log = fault_log if fault_log is not None else FaultLog()
        # capability inspection happens here, once — not per read
        self._measure_counters = accepts_counters(device.measure_cost)
        self._write_step = accepts_step(device.set_params)
        pair = getattr(device, "measure_pair", None)
        self._measure_pair = pair if callable(pair) else None
        self._pair_counters = (self._measure_pair is not None
                               and accepts_counters(self._measure_pair))
        self._label = (f"device {getattr(device, 'name', None) or ''}"
                       f"({type(device).__name__})").replace(" (", "(")
        self._attempt_pool = None
        if fault_policy is not None:
            # attempt threads: hung attempts hold a worker until their
            # sleep releases, so keep spares beyond retries+1
            self._attempt_pool = ThreadPoolExecutor(
                max_workers=fault_policy.retries + 2,
                thread_name_prefix="ext-plant")
            self._finalizer = weakref.finalize(
                self, self._attempt_pool.shutdown, wait=False)
        self.meta = meta or PlantMeta(
            name="external", external=True,
            fault_tolerant=fault_policy is not None)

    def fault_summary(self) -> dict:
        """Fault telemetry (events by kind) — empty dict means a clean
        run."""
        n = len(self.fault_log)
        return {"events": n, "by_kind": self.fault_log.counts()} if n else {}

    def close(self) -> None:
        """Shut the attempt pool down now.  Idempotent (also runs at GC);
        a no-op for policy-free plants, which own no threads."""
        if self._attempt_pool is not None:
            self._finalizer()

    def fence(self, timeout=None) -> None:
        """Drain in-flight work — part of the uniform lifecycle contract
        ``ChipFarm`` shares.  Every transaction here is synchronous, so
        there is never anything in flight: a no-op that lets callers
        fence any plant before a checkpoint without type-sniffing."""

    def __enter__(self) -> "ExternalPlant":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _set_params(self, params, step):
        """One persistent device write, timestamped for step-capable
        (drifting) devices."""
        if self._write_step:
            self.device.set_params(params, step=int(step))
        else:
            self.device.set_params(params)

    def _guarded(self, fn, args, step, tag):
        """One transaction under the fault policy; raises ChipFaultError
        with full context after exhausting the retries."""
        out, _, err = guarded_call(
            self._attempt_pool, fn, args, policy=self.policy,
            label=self._label, log=self.fault_log, step=step, tag=tag)
        if err is not None:
            self.fault_log.record("retry-exhausted", self._label,
                                  step=step, tag=tag, detail=str(err))
            raise ChipFaultError(
                f"{self._label}: transaction failed after "
                f"{self.policy.retries + 1} attempts at step={step} "
                f"tag={tag}: {err}") from err
        return out

    def _read_txn(self, params, batch, step, tag):
        self._set_params(params, step)
        if self._measure_counters:
            return np.float32(self.device.measure_cost(
                batch, step=int(step), tag=int(tag)))
        return np.float32(self.device.measure_cost(batch))

    def _host_read(self, params, batch, step, tag):
        if self.policy is not None:
            return np.float32(self._guarded(
                self._read_txn, (params, batch, step, tag), step, tag))
        try:
            return self._read_txn(params, batch, step, tag)
        except Exception as e:
            raise ChipFaultError(
                f"{self._label}: read failed at step={int(step)} "
                f"tag={int(tag)}: {e}") from e

    def read_cost(self, params, batch, *, step, tag: int = 0):
        out = self._host_read(host_params(params), host_batch(batch),
                              int(step), int(tag))
        return torch.tensor(float(out), dtype=torch.float32,
                            device=device_of(params))

    def _pair_txn(self, params, theta, batch, step, tag):
        # ONE persistent write of the base θ; the antithetic pair rides
        # the device's transient probe line (no second full-tree write).
        self._set_params(params, step)
        if self._pair_counters:
            c_plus, c_minus = self._measure_pair(
                theta, batch, step=int(step), tag=int(tag))
        else:
            c_plus, c_minus = self._measure_pair(theta, batch)
        return np.asarray([c_plus, c_minus], np.float32)

    def _host_read_pair(self, params, theta, batch, step, tag):
        if self.policy is not None:
            return self._guarded(
                self._pair_txn, (params, theta, batch, step, tag), step, tag)
        try:
            return self._pair_txn(params, theta, batch, step, tag)
        except Exception as e:
            raise ChipFaultError(
                f"{self._label}: pair read failed at step={int(step)} "
                f"tag={int(tag)}: {e}") from e

    def read_cost_pair(self, params, theta, batch, *, step, tag: int = 0):
        """Antithetic readout C(θ±θ̃).  Devices with a differential probe
        line (``measure_pair``) pay one base-θ write and one host round
        trip per pair; plain devices fall back to the base class's two
        independent reads (two full perturbed-tree writes)."""
        if self._measure_pair is None:
            return super().read_cost_pair(params, theta, batch,
                                          step=step, tag=tag)
        out = self._host_read_pair(host_params(params), host_params(theta),
                                   host_batch(batch), int(step), int(tag))
        out = torch.from_numpy(np.asarray(out, np.float32)).to(
            device_of(params))
        return out[0], out[1]

    def _write_txn(self, params, step):
        self._set_params(params, step)
        return np.int32(0)

    def _host_write(self, params, step):
        if self.policy is not None:
            return self._guarded(self._write_txn, (params, step), step, -1)
        try:
            return self._write_txn(params, step)
        except Exception as e:
            raise ChipFaultError(
                f"{self._label}: write failed at step={int(step)}: {e}"
            ) from e

    def write_params(self, params, *, step, prev=None):
        """Commit the post-update parameters to the chip.  The trainer's
        belief (the returned value) stays its own: analog write noise on
        the device is invisible by construction — exactly the open-loop
        write the paper's chip-in-the-loop setup performs."""
        self._host_write(host_params(params), int(step))
        return params
