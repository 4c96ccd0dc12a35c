"""Rotary position embeddings — standard RoPE and Qwen2-VL M-RoPE.

PyTorch counterpart of ``repro.models.rope``.  M-RoPE (multimodal RoPE,
arXiv:2409.12191) splits the rotary half-dim into three sections
(temporal, height, width) and rotates each section with its own position
id; for pure text all three ids are equal and it reduces to 1-D RoPE.
"""
from __future__ import annotations

import numpy as np
import torch


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [d_head//2] (f32), computed in numpy
    exactly as the reference computes its constant."""
    half = d_head // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate x: [..., S, H, D] by per-token positions [..., S]."""
    inv = rope_freqs(x.shape[-1], theta, x.device)      # [D/2]
    ang = positions[..., None].float() * inv            # [..., S, D/2]
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL M-RoPE.  x: [B, S, H, D]; positions3: [B, S, 3] (t, h, w).

    ``sections`` partitions the half-dim (sum(sections) == D//2); section
    i rotates with positions3[..., i].
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to the "
                         f"rotary half-dim {half}")
    inv = rope_freqs(x.shape[-1], theta, x.device)
    sec_id = torch.from_numpy(np.concatenate([
        np.full((s,), i, np.int64) for i, s in enumerate(sections)
    ])).to(x.device)                                    # [D/2]
    pos = positions3.index_select(-1, sec_id)           # [B, S, D/2]
    return _rotate(x, pos.float() * inv)
