"""Training loops: MGD with checkpoint/resume, and the backprop baseline."""
from . import checkpoint
from .train_loop import (TrainLoopConfig, TrainResult, classification_accuracy,
                         resolve_driver, train_backprop, train_mgd)

__all__ = ["TrainLoopConfig", "TrainResult", "checkpoint",
           "classification_accuracy", "resolve_driver", "train_backprop",
           "train_mgd"]
