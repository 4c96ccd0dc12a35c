"""Procedural datasets for the paper's MLP experiments.

* XOR / n-bit parity — exact (the paper's Figs 4–7, 9).
* NIST7x7 — the paper's 7×7 N/I/S/T letter task: base glyphs, ±1 px
  shifts and pixel noise (the 49-4-4 net's data).
* Synthetic LM streams — Zipf-Markov token sequences for the LM archs.

Draws come from an explicit ``torch.Generator`` on the target device; the
samplers in ``pipeline`` key it on (seed, index).  They do not reproduce
the JAX package's threefry draws: parity tests feed both packages the
same arrays.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


def parity_dataset(n_bits: int, *, device=None):
    """All 2^n (x, y) pairs; y = XOR of the bits.  (x [N,n], y [N,1])."""
    n = 2 ** n_bits
    x = ((np.arange(n)[:, None] >> np.arange(n_bits)[None, :]) & 1
         ).astype(np.float32)
    y = (x.sum(axis=1) % 2).astype(np.float32)[:, None]
    dev = resolve_device(device)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def xor_dataset(*, device=None):
    return parity_dataset(2, device=device)


_GLYPHS = {
    "N": ["X.....X", "XX....X", "X.X...X", "X..X..X", "X...X.X", "X....XX",
          "X.....X"],
    "I": ["..XXX..", "...X...", "...X...", "...X...", "...X...", "...X...",
          "..XXX.."],
    "S": [".XXXXX.", "X......", "X......", ".XXXX..", "......X", "......X",
          "XXXXXX."],
    "T": ["XXXXXXX", "...X...", "...X...", "...X...", "...X...", "...X...",
          "...X..."],
}


@functools.lru_cache(maxsize=None)
def _base(device: str) -> torch.Tensor:
    """The four glyphs as a constant [4,7,7] tensor on ``device``."""
    glyphs = np.stack([
        np.array([[1.0 if c == "X" else 0.0 for c in row]
                  for row in _GLYPHS[name]], np.float32)
        for name in "NIST"])
    return torch.from_numpy(glyphs).to(device)


def nist7x7_batch(gen: torch.Generator, batch_size: int, *, noise=0.25,
                  shift=True):
    """Random (x [B,49], y one-hot [B,4]) N/I/S/T samples with pixel noise
    and ±1 px shifts, drawn from ``gen`` on its device."""
    dev = gen.device
    labels = torch.randint(0, 4, (batch_size,), generator=gen, device=dev)
    imgs = _base(str(dev))[labels]                          # [B,7,7]
    if shift:
        sh = torch.randint(-1, 2, (batch_size, 2), generator=gen, device=dev)
        ar = torch.arange(7, device=dev)
        rows = (ar[None, :] - sh[:, :1]) % 7               # roll along H
        cols = (ar[None, :] - sh[:, 1:]) % 7               # roll along W
        b = torch.arange(batch_size, device=dev)
        imgs = imgs[b[:, None, None], rows[:, :, None], cols[:, None, :]]
    imgs = imgs + noise * torch.randn(imgs.shape, generator=gen, device=dev)
    x = imgs.reshape(batch_size, 49)
    y = torch.nn.functional.one_hot(labels, 4).to(torch.float32)
    return x, y


def lm_batch(gen: torch.Generator, batch_size: int, seq_len: int,
             vocab: int):
    """Zipf-Markov synthetic text, the reference's law: a Zipfian marginal
    by inverse CDF on a uniform in [1e-6, 1), and 75 % of positions
    continuing the deterministic chain t → (31·t + 7) mod vocab.  Returns
    dict(tokens, labels) [B, S] int64 with next-token labels."""
    dev = gen.device
    shape = (batch_size, seq_len + 1)
    u = torch.rand(shape, generator=gen, device=dev) * (1.0 - 1e-6) + 1e-6
    z = torch.exp(u * math.log(vocab)).to(torch.int64) - 1    # ~1/rank
    z = z.clamp(0, vocab - 1)
    cont = torch.rand(shape, generator=gen, device=dev) < 0.75
    cols = [z[:, 0]]
    for t in range(1, seq_len + 1):
        cols.append(torch.where(cont[:, t], (cols[-1] * 31 + 7) % vocab,
                                z[:, t]))
    toks = torch.stack(cols, dim=1)                            # [B, S+1]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
