"""Cost functions.  The paper uses MSE throughout (no softmax, §3.6);
LM-scale configs use softmax cross-entropy."""
from __future__ import annotations

import torch


def mse(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements, in float32."""
    d = y.float() - y_hat.float()
    return torch.mean(d * d)


def mae(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over all elements, in float32."""
    return torch.mean(torch.abs(y.float() - y_hat.float()))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Token-mean softmax cross entropy; labels == ignore_id are masked."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(
        logits, labels.clamp(min=0)[..., None].long(), dim=-1)[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)


COSTS = {"mse": mse, "xent": softmax_xent}
