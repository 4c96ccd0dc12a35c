"""The driver API: registry, configs and the multi-step runner, plus the
verb ``train`` (``train_mgd``, as in the reference's front door).

``train`` and the loop's config dataclasses resolve lazily, so that
importing the driver surface alone does not pull in the training loop.
"""
from .driver import (ALGORITHMS, DriverConfig, MGDDriver, as_analog_config,
                     as_mgd_config, driver, make_epoch, register_driver,
                     replace_step, state_step)

_LAZY = {
    "train": "train_mgd",
    "train_mgd": "train_mgd",
    "TrainLoopConfig": "TrainLoopConfig",
    "TrainResult": "TrainResult",
}

__all__ = ["ALGORITHMS", "DriverConfig", "MGDDriver", "as_analog_config",
           "as_mgd_config", "driver", "make_epoch", "register_driver",
           "replace_step", "state_step"] + sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.training import train_loop
        return getattr(train_loop, _LAZY[name])
    raise AttributeError(
        f"module 'repro_torch.api' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
