"""Production mesh definitions.

The twin of the reference's ``launch/mesh.py``.  ``make_production_mesh``
is a FUNCTION (never a module-level constant) so importing this module
never touches a process group.  It keeps the reference's shapes, so the
dry-run artifacts of both packages compare cell for cell:

    single-pod:  (16, 16)      axes ("data", "model")        — 256 ranks
    multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") — 512 ranks

On H100s those are 256 / 512 GPUs in nodes of 8 (NVLink inside a node,
InfiniBand between nodes), so the 16-wide "model" axis crosses two
nodes: its collectives ride the inter-node link, which
``launch.roofline`` prices.

The "pod" axis is outer data parallelism by default; MGD re-purposes it
as the probe axis (``core.probe_parallel``, pods as ranks) or a pipeline
axis (``distributed.pipeline``).  Both functions need a
``torch.distributed`` world of the mesh's size (``distributed.world``).
"""
from __future__ import annotations

import torch.distributed as dist


def _device_type(device_type=None) -> str:
    """The mesh's device type: ``device_type``, or the card
    (``device.resolve_device``, which raises without one: a mesh on the
    CPU is asked for with ``device_type="cpu"``)."""
    from repro_torch.device import resolve_device
    return resolve_device(device_type).type


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device_type=None):
    """Whatever ranks exist, as a 1-D "data" mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type),
                            (dist.get_world_size(),), mesh_dim_names=("data",))
