"""The driver API: registry, configs and the multi-step runner."""
from .driver import (ALGORITHMS, DriverConfig, MGDDriver, as_analog_config,
                     as_mgd_config, driver, make_epoch, register_driver,
                     replace_step, state_step)

__all__ = ["ALGORITHMS", "DriverConfig", "MGDDriver", "as_analog_config",
           "as_mgd_config", "driver", "make_epoch", "register_driver",
           "replace_step", "state_step"]
