"""Device resolution for the port's entry points.

Every entry point that creates tensors (``mlp_init``, the CNN inits,
the batch functions and samplers, ``driver``, ``train_mgd``,
``convert.to_torch``) runs on the CUDA card
unless the caller passes ``device="cpu"``.  Without a card and without
that request they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and torch sees "
            "none; pass device='cpu' to run the plain PyTorch path on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
