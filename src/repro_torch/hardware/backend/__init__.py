"""Pluggable farm execution backends (see ``base.py`` for the contract).

    serial   inline on the calling thread — the parity oracle
    thread   one runner thread per chip (live instances OK; GIL-bound
             devices serialize)
    process  one worker process per chip (DeviceSpec entries; real kills
             on hangs, GIL-bound devices scale)
    cluster  wire-protocol stub for farm-over-network chips

``ChipFarm(devices, backend=...)`` accepts any registered name or a
``FarmBackend`` instance.
"""
from .base import (BACKENDS, ChipOps, DeviceSpec, FarmBackend,
                   SerialBackend, Task, make_backend)
from .cluster_stub import ClusterStubBackend, loopback_transport
from .process import ProcessBackend
from .thread import ThreadBackend

__all__ = [
    "BACKENDS", "ChipOps", "ClusterStubBackend", "DeviceSpec",
    "FarmBackend", "ProcessBackend", "SerialBackend", "Task",
    "ThreadBackend", "loopback_transport", "make_backend",
]
