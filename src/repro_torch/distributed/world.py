"""Process groups for the port's distributed paths.

``init_world`` joins a ``torch.distributed`` world through a file store
(no network port to pick; ranks of one host meet in a shared file), and
``fake_world`` starts a one-process world of ``world_size`` fake ranks
whose collectives move nothing — the dry run's (``launch.dryrun``).
Nothing here reads the environment: the caller names the rank, the
world size and the store.
"""
from __future__ import annotations

import datetime

import torch.distributed as dist


def init_world(backend: str, rank: int, world_size: int, store_path: str,
               timeout_s: float = 300.0):
    """Join the default process group as ``rank`` of ``world_size`` over
    a ``FileStore`` at ``store_path`` (``"gloo"`` on the CPU, ``"nccl"``
    on the card)."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def fake_world(world_size: int):
    """A one-process world of ``world_size`` fake ranks: this process is
    rank 0, every collective returns at once and moves nothing.  The fake
    backend lives in a private torch module, imported here only."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def close_world():
    if dist.is_initialized():
        dist.destroy_process_group()
