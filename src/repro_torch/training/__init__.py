"""Training loop for the MGD drivers."""
from .train_loop import TrainLoopConfig, TrainResult, resolve_driver, train_mgd

__all__ = ["TrainLoopConfig", "TrainResult", "resolve_driver", "train_mgd"]
