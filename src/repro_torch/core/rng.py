"""Counter-keyed threefry2x32: the port's copy of the ``jax.random`` draws
the imperfect devices and the data samplers make.

The JAX package's plants key every draw as ``PRNGKey(seed)`` →
``fold_in(tag)`` → ``fold_in(step)`` and draw with ``jax.random.normal``
or ``uniform``; its samplers draw batch i from ``fold_in(PRNGKey(seed),
i)`` with ``split``, ``randint``, ``normal``, ``uniform`` and
``bernoulli``.  This module reproduces those draws in torch so a noisy,
quantized or drifting device lands the same values, and a sampler the
same batches, in both packages.

It follows jax 0.9.0 with ``jax_threefry_partitionable = True`` (that
release's default; ``jax/_src/prng.py``):

* ``prng_key(seed)`` is ``(0, seed & 0xFFFFFFFF)`` (``threefry_seed``
  of the int32 seed that 32-bit mode, jax's default, makes of any int);
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))`` read as a key;
* ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``
  (``_threefry_split_foldlike``);
* ``random_bits(key, shape)[i] = b₁ ^ b₂`` with
  ``(b₁, b₂) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` for the
  row-major flat index i (``_threefry_random_bits_partitionable``): a
  per-element hash, so the bits are made in chunks of ``CHUNK`` elements
  on any device and the chunking changes no value.

``constraints-ci.txt`` pins jax 0.4.37, where this flag defaulted to
``False``: there ``split`` and ``random_bits`` hash a different counter
layout and every draw differs from these.

Keys are host ints (a ``(k1, k2)`` pair of uint32 values): deriving one
never touches a device.  The element hash runs in int32 tensors, whose
``+`` and ``<<`` wrap modulo 2³² on the CPU and on CUDA; ``>>`` is
arithmetic, so the rotation masks its high bits.  The tensor draws are
made on the CUDA card unless the caller passes ``device="cpu"``
(``repro_torch.device``).  ``normal_scalar`` and ``uniform_scalar`` make
one draw on the host, in Python ints and numpy f32, for the scalar reads
the plants key per step and tag: a dozen host operations where the
tensor path would dispatch ~190 ops for one element.

``gumbel`` and ``categorical`` are jax 0.9.0's default ("low") mode,
``−log(−log(uniform(key, lo=tiny, hi=1)))`` and ``argmax(logits +
gumbel)``: the serving path's temperature sampling.

Bits and uniforms are bitwise equal to jax's.  ``normal`` is
``√2·erfinv(u)`` with XLA's single-precision ``erf_inv`` polynomial
(Giles) ported op for op; it differs from jax's CPU draws only where
torch's ``log1p`` rounds apart from XLA's (within ``NORMAL_ULPS``
ulps, tests/test_torch_plants.py).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from .utils import f32

MASK = 0xFFFFFFFF
CHUNK = 1 << 24            # elements per pass of the element hash
NORMAL_ULPS = 4            # stated bound of normal() against jax's draws
GUMBEL_ULPS = 2            # gumbel() against jax's, in ulps of max(|g|, 1)
_TINY = float(np.finfo(np.float32).tiny)

Key = Tuple[int, int]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _s32(v: int) -> int:
    """A uint32 host int as the int32 with the same bit pattern."""
    v &= MASK
    return v - (1 << 32) if v >= (1 << 31) else v


def _threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 (20 rounds) of counters ``(x1, x2)`` under key
    ``(k1, k2)``.  ``x1``/``x2`` are host ints in [0, 2³²) or int32
    tensors holding uint32 bit patterns; the result has their kind."""
    if isinstance(x1, torch.Tensor):
        def wrap(v):
            return v

        def const(c):
            return _s32(c)
    else:
        def wrap(v):
            return v & MASK

        def const(c):
            return c & MASK

    def rotl(v, r):
        return wrap(v << r) | ((v >> (32 - r)) & ((1 << r) - 1))

    ks = (k1 & MASK, k2 & MASK, (k1 ^ k2 ^ _PARITY) & MASK)
    x1 = wrap(x1 + const(ks[0]))
    x2 = wrap(x2 + const(ks[1]))
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = wrap(x1 + x2)
            x2 = rotl(x2, r) ^ x1
        x1 = wrap(x1 + const(ks[(i + 1) % 3]))
        x2 = wrap(x2 + const(ks[(i + 2) % 3] + i + 1))
    return x1, x2


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as a host pair."""
    return (0, int(seed) & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` (``data`` taken as uint32)."""
    return _threefry2x32(key[0], key[1], 0, int(data) & MASK)


def split(key: Key, n: int = 2):
    """``jax.random.split(key, n)`` as a list of host pairs."""
    return [_threefry2x32(key[0], key[1], 0, i) for i in range(n)]


def _flat_counts(start: int, stop: int, device):
    """(hi, lo) int32 counter tensors of flat indices ``start..stop-1``."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    lo = idx & MASK
    lo = torch.where(lo >= (1 << 31), lo - (1 << 32), lo).to(torch.int32)
    if stop <= (1 << 32):
        hi = torch.zeros_like(lo)
    else:
        hi = (idx >> 32).to(torch.int32)
    return hi, lo


def bits_slice(key: Key, start: int, stop: int, device=None
               ) -> torch.Tensor:
    """Flat elements ``start..stop-1`` of ``random_bits(key, shape)``
    for any shape of at least ``stop`` elements (int32 bit patterns)."""
    hi, lo = _flat_counts(start, stop, resolve_device(device))
    b1, b2 = _threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def _fill(shape, dtype, device, make) -> torch.Tensor:
    """A tensor of ``shape`` whose flat elements ``start..stop-1`` are
    ``make(start, stop)``, made ``CHUNK`` elements at a time."""
    n = math.prod(shape)
    out = torch.empty((n,), dtype=dtype, device=device)
    for start in range(0, n, CHUNK):
        stop = min(n, start + CHUNK)
        out[start:stop] = make(start, stop)
    return out.reshape(shape)


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``, as the int32 tensor with
    the same bit patterns."""
    device = resolve_device(device)
    return _fill(shape, torch.int32, device,
                 lambda a, b: bits_slice(key, a, b, device))


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) floats from the top 23 bits (``jax.random._uniform``)."""
    mant = (bits >> 9) & 0x7FFFFF
    return (mant | 0x3F800000).view(torch.float32) - f32(1.0)


def _uniform_from_bits(bits, lo, hi):
    """``max(lo, f·(hi − lo) + lo)`` with one rounding, as XLA contracts
    it into a fused multiply-add: the product of two f32 values is exact
    in f64, so the f64 sum rounds to the f32 that the FMA gives."""
    lo = f32(lo)
    span = f32(hi) - lo
    u = (_unit_floats(bits).double() * span.double() + lo.double()).float()
    return torch.maximum(lo, u)


def uniform(key: Key, shape=(), lo: float = 0.0, hi: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)``, bitwise."""
    device = resolve_device(device)
    return _fill(shape, torch.float32, device, lambda a, b: _uniform_from_bits(
        bits_slice(key, a, b, device), lo, hi))


def randint(key: Key, shape, minval: int, maxval: int, device=None
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), bitwise,
    as an int64 tensor (indexing takes int64).

    jax 0.9.0's ``_randint``: 32 bits from each half of ``split(key)``,
    ``span = maxval − minval`` as uint32 (1 when ``maxval <= minval``),
    ``m = (2¹⁶ mod span)² mod span`` and ``minval + ((hi mod span)·m +
    lo mod span) mod span``, every product and sum wrapping modulo 2³² as
    uint32 does.  torch has no uint32 ``%``: the bits are masked into
    int64, where every remainder is of a non-negative value."""
    device = resolve_device(device)
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = (((1 << 16) % span) ** 2 & MASK) % span
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device).to(torch.int64) & MASK
    lo = random_bits(k2, shape, device).to(torch.int64) & MASK
    off = ((hi % span) * mult) & MASK
    off = ((off + lo % span) & MASK) % span
    return off + minval


def bernoulli(key: Key, p: float = 0.5, shape=(), device=None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform(key, shape) < p``
    in f32, bitwise (a bool tensor)."""
    return uniform(key, shape, device=device) < f32(p)


# XLA's ErfInv for f32 (xla/hlo/builder/lib/math.cc, after Giles 2010):
# w = −log1p(−x²); a degree-8 polynomial in w − 2.5 (w < 5) or √w − 3.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``erf_inv`` in torch ops, in its order."""
    w = -torch.log1p(x * -x)
    lt = w < f32(5.0)
    z = torch.where(lt, w - f32(2.5), torch.sqrt(w) - f32(3.0))
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, f32(c_lt), f32(c_ge)) + p * z
    return torch.where(x.abs() == f32(1.0), x * f32(math.inf), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def _normal_from_bits(bits):
    # u on [nextafter(−1, 0), 1): the span rounds to 2.0 in f32, so f·2 is
    # exact and the f32 sum rounds once, as the fused multiply-add does
    lo = f32(_NORMAL_LO)
    u = torch.maximum(lo, _unit_floats(bits) * f32(2.0) + lo)
    return erf_inv(u) * f32(_SQRT2)


def normal_slice(key: Key, start: int, stop: int, device=None
                 ) -> torch.Tensor:
    """Flat elements ``start..stop-1`` of ``normal(key, shape)``."""
    return _normal_from_bits(bits_slice(key, start, stop, device))


def normal_chunks(key: Key, n: int, device=None):
    """``(start, stop, draws)`` over the flat draws of
    ``jax.random.normal(key, (n,))``, ``CHUNK`` elements at a time: the
    noisy plants add them into a leaf without a full-size f32 copy."""
    device = resolve_device(device)
    for start in range(0, n, CHUNK):
        stop = min(n, start + CHUNK)
        yield start, stop, normal_slice(key, start, stop, device)


def normal(key: Key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (see ``NORMAL_ULPS``)."""
    device = resolve_device(device)
    return _fill(shape, torch.float32, device,
                 lambda a, b: normal_slice(key, a, b, device))


def gumbel(key: Key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default mode:
    ``−log(−log(u))`` of ``uniform(key, shape, tiny, 1)`` (the uniforms
    bitwise; torch's logs round apart from XLA's, within ``GUMBEL_ULPS``
    ulps of max(|g|, 1))."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0, device)))


def categorical(key: Key, logits: torch.Tensor, axis: int = -1
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max draw
    ``argmax(logits + gumbel(key, logits.shape))`` (int64), made on the
    logits' device."""
    g = gumbel(key, tuple(logits.shape), logits.device).to(logits.dtype)
    return torch.argmax(g + logits, dim=axis)


# -- one draw on the host ----------------------------------------------------


def _unit_float_scalar(key: Key) -> np.float32:
    """Element 0 of the unit floats of ``key``: its hash in Python ints."""
    b1, b2 = _threefry2x32(key[0], key[1], 0, 0)
    mant = ((b1 ^ b2) >> 9) & 0x7FFFFF
    one = np.array([mant | 0x3F800000], np.uint32).view(np.float32)[0]
    return one - np.float32(1.0)


def _erf_inv_scalar(x: np.float32) -> np.float32:
    """``erf_inv`` of one f32 value in numpy f32 ops, in its order."""
    w = -np.log1p(x * -x)
    table = _ERFINV_LT5 if w < np.float32(5.0) else _ERFINV_GE5
    z = w - np.float32(2.5) if w < np.float32(5.0) \
        else np.sqrt(w) - np.float32(3.0)
    p = np.float32(table[0])
    for c in table[1:]:
        p = np.float32(c) + p * z
    return x * np.float32(math.inf) if abs(x) == np.float32(1.0) else p * x


def normal_scalar(key: Key) -> torch.Tensor:
    """``normal(key, ())`` made on the host, as a 0-dim CPU tensor (it
    combines with a card tensor without a copy)."""
    lo = np.float32(_NORMAL_LO)
    u = max(lo, _unit_float_scalar(key) * np.float32(2.0) + lo)
    return torch.tensor(_erf_inv_scalar(u) * np.float32(_SQRT2))


def uniform_scalar(key: Key, lo: float = 0.0, hi: float = 1.0
                   ) -> torch.Tensor:
    """``uniform(key, (), lo, hi)`` made on the host, bitwise, as a 0-dim
    CPU tensor (the f64 sum rounds once, as in ``_uniform_from_bits``)."""
    lo32 = np.float32(lo)
    span = np.float32(np.float32(hi) - lo32)
    u = np.float32(float(_unit_float_scalar(key)) * float(span) + float(lo32))
    return torch.tensor(max(lo32, u))
