"""What the references share: the perturbed parameters of one MGD step,
float32 numerics with TF32 off, and the lower-precision control.

Parameters are a flat ``{path: tensor}`` of key-path tuples, in the
configuration's storage type (bfloat16 here).  A forward never sees the
stored tensors: it asks ``Perturbed`` for a leaf (or a stacked layer's
slice of it) and gets one float32 tensor a probe sign, θ ± Δθ·s with the
signs of ``counts.signs`` and nothing rounded.  The signs of a step are
kept as int8 until the step's update has read them.
"""
from __future__ import annotations

import contextlib
import math

import torch

from mgdbench.counts import signs as sg

SIGN_CHUNK = 1 << 24          # elements a pass of the int64 hash
STACKED = "layers"            # leaves under this key stack layers on dim 0


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convolutions without TF32, the caller's
    settings back afterwards."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32, torch.get_float32_matmul_precision())
    mm.allow_tf32 = cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved[0], saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def exact(x: torch.Tensor) -> torch.Tensor:
    """The float32 reference's matmul operands: as they are."""
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a power-of-two scale per tensor
    (its largest magnitude at most 448), as float32 values: exact in
    bfloat16 too, so a leaf can hold them."""
    amax = x.abs().amax().float().clamp(min=1e-30)
    scale = torch.exp2(torch.floor(torch.log2(448.0 / amax)))
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """Where the reference rounds.  ``operand``: each matmul's operands.
    ``store``: the parameters as held (θ₀, each perturbed θ ± θ̃ and each
    update), or None to keep the configuration's storage type alone."""

    def __init__(self, operand, store=None):
        self.operand, self.store = operand, store


# float32: the reference.  fp8: the control, the precision below the
# configurations' bfloat16 wherever they hold or multiply in bfloat16;
# fp8_matmul: a milder reading, fp8 matmul operands alone.
PRECISION = {"float32": Precision(exact), "fp8": Precision(fp8, fp8),
             "fp8_matmul": Precision(fp8)}


def mm(x: torch.Tensor, w: torch.Tensor, quant=exact) -> torch.Tensor:
    return quant(x) @ quant(w)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def layernorm(x, scale, bias, eps):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean((x - mu) ** 2, -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy over the labels ≥ 0."""
    labels = labels.long()
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def is_stacked(path) -> bool:
    return path[0] == STACKED


def slice_numel(t: torch.Tensor, path) -> int:
    return math.prod(t.shape[1:]) if is_stacked(path) else t.numel()


def fill_signs(out: torch.Tensor, lseed: int, start: int) -> None:
    """``out`` (int8, any shape) ← the signs of elements start .. start +
    out.numel() − 1 of a leaf under ``lseed``, in passes."""
    flat = out.reshape(-1)
    for a in range(0, flat.numel(), SIGN_CHUNK):
        b = min(flat.numel(), a + SIGN_CHUNK)
        flat[a:b] = sg.signs(lseed, start + a, start + b,
                             device=out.device).to(torch.int8)


class Perturbed:
    """θ ± Δθ·s of one step: ``streams(path, layer)`` gives one float32
    tensor a sign of ``self.signs``; ``sign_leaf(path)`` the leaf's ±1
    signs (int8), the same ones the forward read."""

    signs = (1.0, -1.0)           # the central probe's two streams

    def __init__(self, params, seed: int, step: int, dtheta: float,
                 store=None):
        self.params, self.store = params, store
        self.dtheta = dtheta
        ids = sg.leaf_ids(params)
        self.lseed = {p: sg.leaf_seed(seed, step, i) for p, i in ids.items()}
        self._cache = {}
        self._done = {}

    def _slice_signs(self, path, layer):
        leaf = self.params[path]
        if path not in self._cache:
            self._cache[path] = torch.empty(leaf.shape, dtype=torch.int8,
                                            device=leaf.device)
            self._done[path] = set()
        key = layer if is_stacked(path) else None
        buf = self._cache[path]
        if key not in self._done[path]:
            if key is None:
                fill_signs(buf, self.lseed[path], 0)
            else:
                fill_signs(buf[key], self.lseed[path],
                           key * slice_numel(leaf, path))
            self._done[path].add(key)
        return buf if key is None else buf[key]

    def sign_leaf(self, path) -> torch.Tensor:
        if is_stacked(path):
            for layer in range(self.params[path].shape[0]):
                self._slice_signs(path, layer)
            return self._cache[path]
        return self._slice_signs(path, None)

    def base(self, path, layer=None) -> torch.Tensor:
        leaf = self.params[path]
        return leaf[layer] if layer is not None else leaf

    def _perturb(self, w, s):
        out = tuple(w + f32(sign * self.dtheta).to(w.device) * s
                    for sign in self.signs)
        return out if self.store is None else tuple(map(self.store, out))

    def streams(self, path, layer=None):
        return self._perturb(self.base(path, layer).float(),
                             self._slice_signs(path, layer).float())

    def rows(self, path, idx):
        """Rows ``idx`` of a [rows, d] leaf, perturbed: an embedding
        lookup that forms θ ± θ̃ of the gathered rows only (held as the
        whole table would be)."""
        if self.store is not None:
            return tuple(t[idx] for t in self.streams(path))
        return self._perturb(self.base(path)[idx].float(),
                             self._slice_signs(path, None)[idx].float())

    def release(self) -> None:
        self._cache.clear()
        self._done.clear()
