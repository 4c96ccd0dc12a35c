"""Procedural datasets for every paper experiment.

* XOR / n-bit parity — exact (the paper's Figs 4–7, 9).
* NIST7x7 — the paper's 7×7 N/I/S/T letter task: base glyphs, ±1 px
  shifts and pixel noise (the 49-4-4 net's data).
* Fashion-MNIST / CIFAR-10 stand-ins — procedural class-template images
  of the same shape and cardinality (28×28×1 and 32×32×3, 10 classes),
  ±2 px shifts and pixel noise (the Table 2 CNNs' data).
* Synthetic LM streams — Zipf-Markov token sequences for the LM archs.

Every batch is a pure function of a threefry key (``core.rng``): the
reference's ``jax.random`` draws, split the way the reference splits
them, so a key gives the reference's labels, shifts and Bernoulli bits
bitwise, and its images within ``rng.NORMAL_ULPS`` of the noise draw.
Tensors are made on the CUDA card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.utils import f32
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


def _roll(imgs: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """Per-sample ``jnp.roll(im, s, axis=(0, 1))`` of [B, H, W, ...] images
    by shifts ``sh`` [B, 2], as one modular gather."""
    b, h, w = imgs.shape[:3]
    dev = imgs.device
    rows = (torch.arange(h, device=dev)[None, :] - sh[:, :1]) % h
    cols = (torch.arange(w, device=dev)[None, :] - sh[:, 1:]) % w
    bi = torch.arange(b, device=dev)
    return imgs[bi[:, None, None], rows[:, :, None], cols[:, None, :]]


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels, n).to(torch.float32)


def nist7x7_batch(key, batch_size: int, *, noise=0.25, shift=True,
                  device=None):
    """Random (x [B,49], y one-hot [B,4]) N/I/S/T samples with pixel noise
    and ±1 px shifts, drawn from the threefry ``key``."""
    dev = resolve_device(device)
    k1, k2, k3, _ = rng.split(key, 4)
    labels = rng.randint(k1, (batch_size,), 0, 4, device=dev)
    imgs = _base(str(dev))[labels]                          # [B,7,7]
    if shift:
        imgs = _roll(imgs, rng.randint(k2, (batch_size, 2), -1, 2,
                                       device=dev))
    imgs = imgs + f32(noise) * rng.normal(k3, imgs.shape, device=dev)
    return imgs.reshape(batch_size, 49), _one_hot(labels, 4)


# --- procedural image classes (F-MNIST / CIFAR stand-ins) -------------------


@functools.lru_cache(maxsize=None)
def _templates(hw: int, ch: int, n_classes: int, seed: int) -> np.ndarray:
    """Smooth class templates, low-frequency random fields [n, hw, hw, ch]
    (numpy, the reference's own recipe and generator)."""
    gen = np.random.default_rng(seed)
    base = gen.standard_normal((n_classes, hw // 4, hw // 4, ch))
    t = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    # light smoothing to remove the blockiness
    t = (t + np.roll(t, 1, axis=1) + np.roll(t, 1, axis=2)
         + np.roll(t, -1, axis=1) + np.roll(t, -1, axis=2)) / 5.0
    return t.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _templates_on(hw: int, ch: int, n_classes: int, seed: int,
                  device: str) -> torch.Tensor:
    return torch.from_numpy(_templates(hw, ch, n_classes, seed)).to(device)


def procedural_image_batch(key, batch_size: int, *, hw, ch, n_classes=10,
                           noise=0.6, seed=17, device=None):
    """x [B,hw,hw,ch] f32 (NHWC), y one-hot [B,n_classes]: a class
    template rolled by ±2 px, plus pixel noise."""
    dev = resolve_device(device)
    t = _templates_on(hw, ch, n_classes, seed, str(dev))
    k1, k2, k3 = rng.split(key, 3)
    labels = rng.randint(k1, (batch_size,), 0, n_classes, device=dev)
    imgs = _roll(t[labels], rng.randint(k2, (batch_size, 2), -2, 3,
                                        device=dev))
    imgs = imgs + f32(noise) * rng.normal(k3, imgs.shape, device=dev)
    return imgs, _one_hot(labels, n_classes)


def fashion_batch(key, batch_size: int, *, device=None):
    return procedural_image_batch(key, batch_size, hw=28, ch=1, seed=23,
                                  device=device)


def cifar_batch(key, batch_size: int, *, device=None):
    return procedural_image_batch(key, batch_size, hw=32, ch=3, seed=29,
                                  device=device)


# --- synthetic LM token streams ---------------------------------------------


def lm_batch(key, batch_size: int, seq_len: int, vocab: int, *,
             device=None):
    """Zipf-Markov synthetic text, the reference's law: a Zipfian marginal
    by inverse CDF on a uniform in [1e-6, 1), and 75 % of positions
    continuing the deterministic chain t → (31·t + 7) mod vocab.  Returns
    dict(tokens, labels) [B, S] int64 with next-token labels.

    ``log(vocab)`` is rounded to f32 before the multiply, as the
    reference's f32 program does; ``exp`` can still round across an
    integer apart from XLA's (rare; tests/test_torch_data.py counts it)."""
    dev = resolve_device(device)
    shape = (batch_size, seq_len + 1)
    k1, k2 = rng.split(key)
    u = rng.uniform(k1, shape, 1e-6, 1.0, device=dev)
    z = torch.exp(u * f32(np.log(vocab))).to(torch.int64) - 1   # ~1/rank
    z = z.clamp(0, vocab - 1)
    cont = rng.bernoulli(k2, 0.75, shape, device=dev)
    cols = [z[:, 0]]
    for t in range(1, seq_len + 1):
        cols.append(torch.where(cont[:, t], (cols[-1] * 31 + 7) % vocab,
                                z[:, t]))
    toks = torch.stack(cols, dim=1)                            # [B, S+1]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
