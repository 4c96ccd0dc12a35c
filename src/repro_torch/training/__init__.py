"""Training loop for the MGD drivers, with checkpoint/resume."""
from . import checkpoint
from .train_loop import TrainLoopConfig, TrainResult, resolve_driver, train_mgd

__all__ = ["TrainLoopConfig", "TrainResult", "checkpoint", "resolve_driver",
           "train_mgd"]
