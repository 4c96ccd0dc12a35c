"""Cost functions: the paper uses MSE throughout (no softmax, §3.6)."""
from __future__ import annotations

import torch


def mse(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements, in float32."""
    d = y.float() - y_hat.float()
    return torch.mean(d * d)
