"""Cluster backend stub: the wire contract for farm-over-network chips.

The scaling endgame (ROADMAP: data-parallel farms, the Oripov et al.
2025 k-chip axis) eventually puts chips on OTHER HOSTS — a rack of
instrument servers, each owning one device.  This stub pins down the
wire protocol now, so the farm/backend split is proven against it and a
real transport (gRPC, ZeroMQ, a lab message bus) only has to implement
one function:

    transport(chip_index, request_bytes) -> reply_bytes

Request/reply schema (pickled tuples, version-tagged):

    request:  (PROTOCOL_VERSION, op, payload)
        op      — one of ``base.OPS`` ("pair" | "write" | "accuracy" |
                  "writes")
        payload — the op's argument tuple (numpy trees/scalars only —
                  the same host-boundary types the process backend
                  ships over its pipe)
    reply:    (PROTOCOL_VERSION, value, err, events, busy_s)
        value   — the op result (None when ``err`` is set)
        err     — None, or a string describing the remote failure
        events  — drained worker-local ``FaultLog`` entries (the host
                  folds them into the farm's log)
        busy_s  — remote device-execution seconds (utilization metric)

Chips are addressed by index; each node builds its device from the
``DeviceSpec`` it is handed at provisioning time — exactly the process
backend's contract with the network substituted for the pipe.  Without
a transport, ``start`` raises ``NotImplementedError`` (this is a stub);
``loopback_transport`` runs the full serialize → execute → deserialize
round trip in-process so the protocol is testable today.

Ops are executed through a per-chip runner thread (FIFO preserved —
requests to one chip must not be reordered by the transport layer), so
a slow network chip overlaps with its peers just like a slow local one.
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..faults import ChipFaultError, FaultLog
from .base import BACKENDS, ChipOps, DeviceSpec, FarmBackend
from .thread import ThreadBackend

PROTOCOL_VERSION = 1

#: transport(chip_index, request_bytes) -> reply_bytes
Transport = Callable[[int, bytes], bytes]


def encode_request(op: str, payload: tuple) -> bytes:
    return pickle.dumps((PROTOCOL_VERSION, op, payload))


def decode_request(blob: bytes):
    version, op, payload = pickle.loads(blob)
    if version != PROTOCOL_VERSION:
        raise ChipFaultError(f"cluster protocol version mismatch: "
                             f"node speaks {version}, host "
                             f"{PROTOCOL_VERSION}")
    return op, payload


def encode_reply(value, err: Optional[str], events, busy_s: float) -> bytes:
    return pickle.dumps((PROTOCOL_VERSION, value, err, events, busy_s))


def decode_reply(blob: bytes):
    version, value, err, events, busy_s = pickle.loads(blob)
    if version != PROTOCOL_VERSION:
        raise ChipFaultError(f"cluster protocol version mismatch: "
                             f"node speaks {version}, host "
                             f"{PROTOCOL_VERSION}")
    return value, err, events, busy_s


def serve_request(ops: ChipOps, log: Optional[FaultLog],
                  request: bytes) -> bytes:
    """One node-side dispatch: what a cluster node's request handler
    runs per message (the worker loop of ``process.py``, reshaped as a
    function of bytes)."""
    op, payload = decode_request(request)
    t0 = time.perf_counter()
    try:
        value, err = ops.run(op, payload), None
    except Exception as e:              # noqa: BLE001 — device failure
        value, err = None, f"{type(e).__name__}: {e}"
    busy = time.perf_counter() - t0
    return encode_reply(value, err, log.drain() if log else [], busy)


def loopback_transport(specs: Sequence[DeviceSpec]) -> Transport:
    """An in-process transport running the full wire round trip —
    request bytes → node dispatch → reply bytes — against devices built
    from ``specs``.  Proves the protocol (and pickling of every payload
    type) without a network."""
    logs = [FaultLog() for _ in specs]
    built = [ChipOps(spec.build(log=log))
             for spec, log in zip(specs, logs)]

    def transport(i: int, request: bytes) -> bytes:
        return serve_request(built[i], logs[i], request)

    return transport


class _RemoteOps:
    """ChipOps-shaped adapter: runs every op through the transport, so
    the per-chip runner machinery (reused from ``ThreadBackend``) drives
    remote chips unchanged."""

    def __init__(self, backend: "ClusterStubBackend", chip: int,
                 spec: DeviceSpec):
        self.backend = backend
        self.chip = chip
        self.spec = spec
        self.name = spec.display_name

    def run(self, op: str, payload: tuple):
        reply = self.backend.transport(
            self.chip, encode_request(op, payload))
        value, err, events, busy_s = decode_reply(reply)
        if events and self.backend._fault_log is not None:
            self.backend._fault_log.extend(events)
        if err is not None:
            raise ChipFaultError(
                f"chip {self.chip} ({self.name}) [remote]: {err}")
        return value

    def caps(self) -> dict:
        """Capability probe: remote accuracy/pair support is resolved
        from the spec host-side (nodes build from the same spec)."""
        cls = self.spec.cls
        return {"name": self.name,
                "pair": callable(getattr(cls, "measure_pair", None)),
                "accuracy": callable(getattr(cls, "measure_accuracy",
                                             None))}


class ClusterStubBackend(ThreadBackend):
    """Farm backend speaking the cluster wire protocol.  A stub: without
    a ``transport`` it refuses to start; with one (e.g.
    ``loopback_transport`` for tests, a real RPC client in deployment)
    it drives remote chips through per-chip runner threads, FIFO per
    chip.  ``abandon`` replaces the runner (the stub cannot kill a
    remote process — a real transport would add a node-reset RPC)."""

    accepts_instances = False

    def __init__(self, transport: Optional[Transport] = None):
        super().__init__()
        self.transport = transport
        self._fault_log: Optional[FaultLog] = None

    def start(self, entries, *, fault_log=None):
        if self.transport is None:
            raise NotImplementedError(
                "ClusterStubBackend is the wire-contract stub: pass "
                "transport=... (see loopback_transport) or run a real "
                "cluster client implementing transport(chip, request_"
                "bytes) -> reply_bytes")
        for i, entry in enumerate(entries):
            if not isinstance(entry, DeviceSpec):
                raise TypeError(
                    f"the cluster backend provisions nodes from "
                    f"DeviceSpec entries; chip {i} is a live "
                    f"{type(entry).__name__} instance")
        self._fault_log = fault_log
        from .thread import _Runner
        remotes: List[_RemoteOps] = [
            _RemoteOps(self, i, spec) for i, spec in enumerate(entries)]
        self._runners = [_Runner(self, i, ops, generation=0)
                         for i, ops in enumerate(remotes)]
        return [ops.caps() for ops in remotes]


BACKENDS["cluster"] = ClusterStubBackend
