"""Concrete device builders: defective sigmoid MLPs behind noisy or
quantized plants (paper §3.5, Fig. 10).

Device-to-device variation is keyed off one ``device_seed``: two plants
built with different seeds are two different physical chips (activation
defects, write and readout noise streams), and one seed is the same chip
across restarts and in both packages (``core.rng`` draws the reference's
threefry values).

The numpy chips (``SimulatedAnalogChip``, ``DriftingAnalogChip``,
``LinearLaneChip``) are the reference's, line for line and draw for
draw: ``default_rng(seed)`` for the defects, ``default_rng(seed + 101)``
for the live write noise, ``default_rng((seed, step, tag))`` for the
readout.  They are host instruments behind ``ExternalPlant`` /
``ChipFarm``: they take numpy params, never create a tensor, and so run
unchanged in the process backend's forked workers.
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.cost import mse
from repro_torch.core.noise import sample_defects
from repro_torch.core.utils import tree_flatten, tree_map, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.models.simple import make_mlp_probe_fn, mlp_apply

from .base import IdealPlant, Plant, PlantMeta
from .plants import NoisyPlant, QuantizedPlant


def mlp_device_fns(sizes: Sequence[int], *, sigma_a: float = 0.0,
                   device_seed: int = 0, cost=mse, device=None):
    """(loss_fn, probe_fn, defects) for a sigmoidal MLP with per-neuron
    fabrication defects sampled from ``device_seed`` (σ_a = 0 → exact
    sigmoid and defects=None).  ``device`` is where the defect tensors
    live: the CUDA card unless the caller passes ``device="cpu"``."""
    if sigma_a:
        dev = resolve_device(device)
        defects = [sample_defects(device_seed + i, n, sigma_a, device=dev)
                   for i, n in enumerate(sizes[1:])]
    else:
        defects = None

    def loss_fn(params, batch):
        return cost(mlp_apply(params, batch["x"], defects=defects),
                    batch["y"])

    return loss_fn, make_mlp_probe_fn(defects), defects


def noisy_mlp_plant(sizes: Sequence[int], *, sigma_c: float = 0.0,
                    sigma_theta: float = 0.0, sigma_a: float = 0.0,
                    dtheta: float = 1e-2, device_seed: int = 0,
                    cost=mse, device=None) -> Plant:
    """A full §3.5 device: σ_C readout noise, σ_θ write noise, σ_a static
    activation defects, all drawn from ``device_seed``."""
    loss_fn, probe_fn, _ = mlp_device_fns(
        sizes, sigma_a=sigma_a, device_seed=device_seed, cost=cost,
        device=device)
    if not (sigma_c or sigma_theta):
        return IdealPlant(loss_fn, probe_fn=probe_fn, meta=PlantMeta(
            name="mlp-ideal", sigma_a=sigma_a))
    return NoisyPlant(
        loss_fn, cost_noise=sigma_c, write_noise=sigma_theta,
        dtheta=dtheta, seed=device_seed, probe_fn=probe_fn,
        meta=PlantMeta(name="mlp-noisy", cost_noise=sigma_c,
                       write_noise=sigma_theta, sigma_a=sigma_a))


def quantized_mlp_plant(sizes: Sequence[int], *, bits: int = 8,
                        w_clip: float = 2.0, write_tau: float = 0.0,
                        quantize_probes: bool = False,
                        adc_bits: Optional[int] = None,
                        adc_mode: str = "round", adc_range: float = 1.0,
                        sigma_a: float = 0.0,
                        device_seed: int = 0, cost=mse,
                        device=None) -> QuantizedPlant:
    """An MLP whose weight memory sits behind a ``bits``-bit DAC and
    (optionally) whose cost readout passes an ``adc_bits``-bit ADC."""
    loss_fn, probe_fn, _ = mlp_device_fns(
        sizes, sigma_a=sigma_a, device_seed=device_seed, cost=cost,
        device=device)
    return QuantizedPlant(
        loss_fn, bits=bits, w_clip=w_clip, write_tau=write_tau,
        quantize_probes=quantize_probes, adc_bits=adc_bits,
        adc_mode=adc_mode, adc_range=adc_range, seed=device_seed,
        probe_fn=probe_fn,
        meta=PlantMeta(name=f"mlp-dac{bits}", weight_bits=bits,
                       adc_bits=adc_bits, sigma_a=sigma_a))


# GIL-bound instrument-driver model for SimulatedAnalogChip(py_busy_ms=…).
# Real lab stacks spend their readout time in pure-Python driver code and
# in C calls that do NOT release the GIL (ctypes.PyDLL is exactly that
# calling convention) — k such chips on a thread pool serialize to k×
# single-chip wall-clock, which is the failure mode the process farm
# backend exists to remove.  The busy loop below holds the GIL for a
# FIXED amount of held-GIL work (not a wall-clock deadline — a deadline
# would silently shrink under contention), chunked through a
# non-GIL-releasing 200 µs libc usleep so a single chip does not peg the
# CPU; without libc (non-POSIX) it degrades to a pure spin.
try:
    _LIBC = ctypes.PyDLL(None)
    _LIBC.usleep.argtypes = [ctypes.c_uint]
    _LIBC.usleep.restype = ctypes.c_int
except (OSError, AttributeError):       # pragma: no cover - non-POSIX
    _LIBC = None


def _hold_gil_busy(ms: float) -> None:
    """Hold the GIL for ≈``ms`` milliseconds of driver 'work'."""
    if _LIBC is not None:
        for _ in range(max(1, int(ms * 5))):
            _LIBC.usleep(200)           # PyDLL: the GIL stays held
        return
    deadline = time.perf_counter() + ms * 1e-3  # pragma: no cover
    while time.perf_counter() < deadline:       # pragma: no cover
        pass


class SimulatedAnalogChip:
    """Reference host device for ``ExternalPlant``: a sigmoidal network
    with fabrication defects, noisy analog writes and noisy readout.

    Nothing outside this class may see the defects or the internal
    parameters — only ``set_params`` / ``measure_cost`` /
    ``measure_pair`` / the public readouts, like a lab instrument.
    Deliberately implemented in PURE NUMPY: the instrument lives on the
    far side of the host boundary (on runner threads, or in forked worker
    processes that must never touch the card).  Writes mutate
    the instrument; READOUT noise is counter-keyed on the optimizer's
    (step, tag) pair when provided, so the +/− probe reads of a central
    pair draw distinct noise and a restarted run replays the identical
    readout stream (write noise stays a live RNG — an analog memory has
    no replayable write history).

    ``measure_pair`` is the differential probe line: θ̃ is applied
    transiently at the parameter (paper's dedicated-perturbation-line /
    LFSR-per-synapse picture), so a central pair costs ONE persistent
    base-θ write instead of two full perturbed-tree writes.

    ``py_busy_ms`` models a GIL-BOUND instrument driver: every readout
    conversion holds the GIL for that many milliseconds of pure-Python
    driver work (``_hold_gil_busy``), so k such chips on the farm's
    thread backend serialize to k× single-chip wall-clock while the
    process backend stays flat — the honest demonstration device for
    ``benchmarks/farm_scaling.py --backend``.
    """

    def __init__(self, sizes: Sequence[int] = (49, 4, 4), *, seed: int = 0,
                 sigma_a: float = 0.15, sigma_theta: float = 0.01,
                 sigma_c: float = 1e-4, py_busy_ms: float = 0.0):
        rng = np.random.default_rng(seed)
        # per-neuron logistic defects, one tuple (α, β, a0, b0) per layer
        # (the numpy twin of core.noise.sample_defects — same model, the
        # chip's own fabrication draw)
        self._defects = [
            (1.0 + sigma_a * rng.standard_normal(n),
             1.0 + sigma_a * rng.standard_normal(n),
             sigma_a * rng.standard_normal(n),
             sigma_a * rng.standard_normal(n))
            for n in sizes[1:]
        ]
        self._seed = int(seed)
        self._sigma_theta = sigma_theta
        self._sigma_c = sigma_c
        self._py_busy_ms = float(py_busy_ms)
        self._params = None
        self._rng = np.random.default_rng(seed + 101)
        self.writes = 0
        self.meta = PlantMeta(name="sim-chip", cost_noise=sigma_c,
                              write_noise=sigma_theta, sigma_a=sigma_a,
                              external=True)

    def set_params(self, params):
        """Analog memory write — each write lands with noise."""
        self.writes += 1
        self._params = tree_map(
            lambda w: (np.asarray(w, np.float32)
                       + self._sigma_theta * self._rng.standard_normal(
                           np.shape(w)).astype(np.float32)),
            params)

    def _stored(self, step):
        """The weights a readout at optimizer step ``step`` sees.  The
        stable chip returns the stored values as written; the drifting
        variant overrides this with the aged values."""
        return self._params

    def _forward(self, x, params=None):
        h = np.asarray(x, np.float32)
        for (a, b, a0, b0), layer in zip(
                self._defects, self._params if params is None else params):
            z = h @ layer["w"]
            if "b" in layer:
                z = z + layer["b"]
            h = a / (1.0 + np.exp(-b * (z - a0))) + b0
        return h

    def _readout_noise(self, step, tag):
        """One standard normal per readout.  Counter-keyed on
        (device seed, step, tag) when the optimizer supplies them —
        deterministic across restarts and distinguishing the +/− probe
        reads — else drawn from the live instrument RNG."""
        if step is None or tag is None:
            return float(self._rng.standard_normal())
        rng = np.random.default_rng((self._seed, int(step), int(tag)))
        return float(rng.standard_normal())

    def _cost(self, params, batch, step, tag):
        if self._py_busy_ms:
            # GIL-bound driver work per readout CONVERSION (a pair is
            # two conversions) — see _hold_gil_busy above
            _hold_gil_busy(self._py_busy_ms)
        err = self._forward(batch["x"], params) - np.asarray(
            batch["y"], np.float32)
        c = float(np.mean(err * err))
        return c + self._sigma_c * self._readout_noise(step, tag)

    def measure_cost(self, batch, *, step=None, tag=None):
        """Scalar cost readout (MSE) with measurement noise."""
        return self._cost(self._stored(step), batch, step, tag)

    def measure_pair(self, theta, batch, *, step=None, tag=None):
        """Differential probe readout (C(θ+θ̃), C(θ−θ̃)): θ̃ rides the
        transient probe line on top of the stored (write-noisy) θ; each
        half is a separate physical conversion with its own readout
        noise (consecutive tags, like the base-class two-read path)."""
        stored = self._stored(step)
        plus = tree_map(
            lambda w, t: w + np.asarray(t, np.float32), stored, theta)
        minus = tree_map(
            lambda w, t: w - np.asarray(t, np.float32), stored, theta)
        tag2 = None if tag is None else tag + 1
        return (self._cost(plus, batch, step, tag),
                self._cost(minus, batch, step, tag2))

    def measure_accuracy(self, batch, *, step=None):
        """Classification readout (evaluation harness only — the
        optimizer never calls this).  ``step`` reads the drifting
        variant's AGED weights; the stable chip ignores it."""
        pred = self._forward(batch["x"], self._stored(step))
        return float(np.mean(np.argmax(pred, -1)
                             == np.argmax(np.asarray(batch["y"]), -1)))


class DriftingAnalogChip(SimulatedAnalogChip):
    """A ``SimulatedAnalogChip`` whose stored weights AGE between writes.

    The drift model mirrors ``hardware.plants.DriftingPlant`` on the far
    side of the host boundary: a readout at optimizer step n sees the
    stored weights taken through one transition

        θ ← rest + a·(θ − rest) + σ_d·ξ(seed, step, leaf)

    per step j in [write_step, n], ``a = exp(−1/drift_tau)`` — the j =
    write_step transition is the write-settle interval, so even a read
    in the SAME step as its write sees one kick of aging.  ``set_params``
    records the optimizer's step counter when given (``ExternalPlant``/
    ``ChipFarm`` forward it to step-capable devices), so the aged weights
    any readout sees are a pure function of (device seed, write step,
    read step, written values) — a restarted run replays the identical
    aging, and two chips with different ``drift_rate`` stay
    distinguishable across the resume.  Writes or reads without a step
    counter (the bench harness) see the un-aged stored values.

    Under continuous training the trainer rewrites the chip every step,
    so exactly one transition lands per read — drift shows up as excess
    probe noise the optimizer must average through.  Once writes STOP (a
    deployed chip, or the interval between scheduled recalibrations) the
    walk accumulates freely; the cost of reconstructing it at a readout
    is O(elapsed steps).
    """

    def __init__(self, sizes: Sequence[int] = (49, 4, 4), *, seed: int = 0,
                 sigma_a: float = 0.15, sigma_theta: float = 0.01,
                 sigma_c: float = 1e-4, py_busy_ms: float = 0.0,
                 drift_mode: str = "walk",
                 drift_rate: float = 0.0, drift_tau: float = 0.0,
                 rest: float = 0.0):
        if drift_mode not in ("walk", "decay"):
            raise ValueError(f"drift mode must be 'walk' or 'decay', "
                             f"got {drift_mode!r}")
        super().__init__(sizes, seed=seed, sigma_a=sigma_a,
                         sigma_theta=sigma_theta, sigma_c=sigma_c,
                         py_busy_ms=py_busy_ms)
        self._drift_mode = drift_mode
        self._drift_rate = float(drift_rate)
        self._drift_tau = float(drift_tau)
        self._rest = float(rest)
        self._write_step = None
        self.meta = PlantMeta(name="sim-chip-drift", cost_noise=sigma_c,
                              write_noise=sigma_theta, sigma_a=sigma_a,
                              external=True, drift_mode=drift_mode,
                              drift_rate=self._drift_rate,
                              drift_tau=self._drift_tau, drift_rest=rest)

    def set_params(self, params, *, step=None):
        """Analog memory write; ``step`` (when the plant forwards it)
        timestamps the write so later readouts know how long the stored
        values have been aging."""
        super().set_params(params)
        self._write_step = None if step is None else int(step)

    def _drift_once(self, params, step):
        a = (np.exp(-1.0 / self._drift_tau) if self._drift_tau else 1.0)

        def leaf(i, w):
            w = np.asarray(w, np.float32)
            if self._drift_tau:
                w = self._rest + a * (w - self._rest)
            if self._drift_rate:
                rng = np.random.default_rng(
                    (self._seed + 313, int(step), i))
                w = w + self._drift_rate * rng.standard_normal(
                    w.shape).astype(np.float32)
            return w

        flat, treedef = tree_flatten(params)
        return tree_unflatten(
            treedef, [leaf(i, w) for i, w in enumerate(flat, start=1)])

    def _stored(self, step):
        """Stored weights aged from the recorded write step to ``step``,
        inclusive — the readouts inherited from ``SimulatedAnalogChip``
        all see the aged values through this one hook."""
        params = self._params
        if (step is None or self._write_step is None
                or (not self._drift_rate and not self._drift_tau)):
            return params
        for j in range(self._write_step, int(step) + 1):
            params = self._drift_once(params, j)
        return params


class LinearLaneChip:
    """Bit-transparent affine readout lane: ``C = mean(|x @ w + b − y|)``
    with NO noise, NO defects and NO nonlinearity.

    This is the calibration device for the farm ≡ mesh bit-equality
    law.  Driven with dyadic-rational parameters (multiples of 2^-m),
    probe amplitudes that are powers of two and {0,1} data, every
    intermediate value of the cost — products, partial sums, |·|, the
    power-of-two batch mean — is exactly representable in f32, so the
    numpy arithmetic here and the torch arithmetic of the in-process
    twin (``models.simple.linear_apply`` + ``mae``) produce identical bits
    no matter how either side associates or fuses the operations.
    Tests use it to pin the batch-sharded k-chip farm against the
    k-pod mesh where a defective-sigmoid chip would diverge in the
    last ulp for libm reasons unrelated to the optimizer.

    Same transaction surface as ``SimulatedAnalogChip``: ``set_params``
    (counted, exact), ``measure_cost``, the differential ``measure_pair``
    probe line, and a threshold ``measure_accuracy`` readout.  Pure
    numpy — host-callback safe.
    """

    def __init__(self, *, seed: int = 0):
        del seed  # noiseless; accepted so farm builders can fan out seeds
        self._params = None
        self.writes = 0
        self.meta = PlantMeta(name="linear-lane", external=True)

    def set_params(self, params):
        """Exact (noise-free) weight write."""
        self.writes += 1
        self._params = tree_map(
            lambda w: np.asarray(w, np.float32), params)

    def _forward(self, x, params=None):
        h = np.asarray(x, np.float32)
        for layer in (self._params if params is None else params):
            h = h @ layer["w"]
            if "b" in layer:
                h = h + layer["b"]
        return h

    def _cost(self, params, batch):
        err = self._forward(batch["x"], params) - np.asarray(
            batch["y"], np.float32)
        return float(np.mean(np.abs(err), dtype=np.float32))

    def measure_cost(self, batch, *, step=None, tag=None):
        """Exact L1 cost readout."""
        return self._cost(self._params, batch)

    def measure_pair(self, theta, batch, *, step=None, tag=None):
        """(C(θ+θ̃), C(θ−θ̃)) with θ̃ applied exactly on the probe line."""
        plus = tree_map(
            lambda w, t: w + np.asarray(t, np.float32), self._params, theta)
        minus = tree_map(
            lambda w, t: w - np.asarray(t, np.float32), self._params, theta)
        return self._cost(plus, batch), self._cost(minus, batch)

    def measure_accuracy(self, batch, *, step=None):
        """Fraction of outputs on the correct side of 1/2."""
        pred = self._forward(batch["x"])
        return float(np.mean((pred > 0.5)
                             == (np.asarray(batch["y"]) > 0.5)))
