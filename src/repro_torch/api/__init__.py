"""The driver API: registry, configs and the multi-step runner, plus the
verbs ``train`` (``train_mgd``) and ``serve`` (the online service), as in
the reference's front door.

``train``/``serve`` and their config dataclasses resolve lazily, so that
importing the driver surface alone does not pull in the training loop or
the serving tier.
"""
from .driver import (ALGORITHMS, DriverConfig, MGDDriver, ProbeParallelState,
                     as_analog_config, as_mgd_config, driver, make_epoch,
                     register_driver, replace_step, state_step)

_LAZY = {
    # offline loop
    "train": ("repro_torch.training.train_loop", "train_mgd"),
    "train_mgd": ("repro_torch.training.train_loop", "train_mgd"),
    "TrainLoopConfig": ("repro_torch.training.train_loop", "TrainLoopConfig"),
    "TrainResult": ("repro_torch.training.train_loop", "TrainResult"),
    # online serving tier
    "serve": ("repro_torch.serving.online", "serve"),
    "OnlineService": ("repro_torch.serving.online", "OnlineService"),
    "ServiceConfig": ("repro_torch.serving.online", "ServiceConfig"),
    "TrimConfig": ("repro_torch.serving.online", "TrimConfig"),
}

__all__ = ["ALGORITHMS", "DriverConfig", "MGDDriver", "ProbeParallelState",
           "as_analog_config",
           "as_mgd_config", "driver", "make_epoch", "register_driver",
           "replace_step", "state_step"] + sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'repro_torch.api' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
