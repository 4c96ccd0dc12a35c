"""Dispatch for the MGD kernels.

``impl`` selects the route:

* ``"cuda"`` — the hand-written Hopper kernels (``csrc/``), CUDA tensors only;
* ``"ref"``  — the plain PyTorch versions (``ref.py``), any device;
* ``None``   — by the tensor's device: a CUDA tensor launches the kernel,
  a CPU tensor takes the plain version.

A CUDA tensor goes through its kernel or raises; it reaches the plain
version only when the caller asks for ``impl="ref"`` explicitly (as the
on-card comparison does).  The JAX package's ``"pallas"`` and
``"interpret"`` routes do not exist here and raise.

The kernels mask the ragged edge themselves, so no operand is padded; the
sign index is ``r*n_cols + c``, where ``n_cols`` (the reference kernels'
argument) defaults to the unpadded N and is the whole leaf's N for a
column block of it, and an ndim ≥ 2 leaf is viewed row-major as a matrix,
which keeps those indices.
"""
from __future__ import annotations

import torch

from repro_torch.core.perturbations import MASK
from repro_torch.core.utils import f32
from . import mgd_update as _mu
from . import perturbed_matmul as _pm
from . import ref as _ref

IMPLS = ("cuda", "ref")


def default_impl(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "ref"


def resolve_impl(impl, t: torch.Tensor) -> str:
    if impl in ("pallas", "interpret"):
        raise ValueError(
            f"kernel_impl={impl!r} is a Pallas route of the JAX package; "
            f"the port runs its CUDA kernels (impl='cuda') or their plain "
            f"PyTorch versions (impl='ref')")
    impl = impl or default_impl(t)
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; use one of {IMPLS}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs tensors on a CUDA device, got "
                         f"{t.device}")
    return impl


def _flatten_lead(x):
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def _as_matrix(w):
    """View an ndim ≥ 2 leaf as [prod(lead), last], row-major."""
    if w.dim() < 2:
        raise ValueError(f"expected an ndim >= 2 leaf, got shape "
                         f"{tuple(w.shape)}")
    return w.reshape(-1, w.shape[-1])


def seeds_tensor(seeds, device) -> torch.Tensor:
    """uint32 seeds (host ints, any nesting) as int32 bit patterns on
    ``device``.  To a card the copy goes from pinned memory without
    blocking, so a training step never waits on the device for it."""
    t = torch.tensor(seeds, dtype=torch.int64) & MASK
    t = torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def perturbed_matmul(x, w, lseed, *, dtheta, sign=1.0, impl=None,
                     out_dtype=None, n_cols=None):
    """y = x @ (W + sign·Δθ·rademacher(lseed)); lead dims of x flatten
    into M; the signs' row stride is ``n_cols`` (None: N)."""
    if resolve_impl(impl, x) == "ref":
        return _ref.perturbed_matmul_ref(
            x, w, lseed, dtheta=dtheta, sign=sign, out_dtype=out_dtype,
            n_cols=n_cols)
    x2, lead = _flatten_lead(x)
    y = _pm.perturbed_matmul(x2.contiguous(), w.contiguous(), lseed,
                             amp=sign * dtheta, out_dtype=out_dtype,
                             n_cols=n_cols)
    return y.reshape(*lead, w.shape[-1])


def perturbed_matmul_pair(xp, xm, w, lseed, *, dtheta, impl=None,
                          out_dtype=None, n_cols=None):
    """(xp @ (W+θ̃), xm @ (W−θ̃)) with one pass over W."""
    if resolve_impl(impl, xp) == "ref":
        return _ref.perturbed_matmul_pair_ref(
            xp, xm, w, lseed, dtheta=dtheta, out_dtype=out_dtype,
            n_cols=n_cols)
    xp2, lead = _flatten_lead(xp)
    xm2, _ = _flatten_lead(xm)
    yp, ym = _pm.perturbed_matmul_pair(
        xp2.contiguous(), xm2.contiguous(), w.contiguous(), lseed,
        dtheta=dtheta, out_dtype=out_dtype, n_cols=n_cols)
    n = w.shape[-1]
    return yp.reshape(*lead, n), ym.reshape(*lead, n)


def mgd_update_window(w, lseeds, coefs, *, alpha, dtheta, impl=None,
                      n_cols=None):
    """W + α·Σ_j (Δθ·sign_j)·coefs[j], applied sequentially in j —
    bit-exact (f32) fused form of the optimizer's per-step axpy chain.

    ``lseeds`` is a [J] int32 tensor of uint32 bit patterns (see
    ``seeds_tensor``; the plain version also takes host ints), ``coefs`` a
    [J] float32 tensor.  Any ndim ≥ 2 leaf is viewed row-major as a matrix
    whose signs' row stride is ``n_cols`` (None: its N).  On the card this
    is a group of one (``mgd_update_window_group``).
    """
    if resolve_impl(impl, w) == "ref":
        return _ref.mgd_update_window_ref(
            _as_matrix(w), lseeds, coefs, alpha=alpha,
            dtheta=dtheta, n_cols=n_cols).reshape(w.shape)
    if not isinstance(lseeds, torch.Tensor):
        lseeds = seeds_tensor(list(lseeds), w.device)
    return mgd_update_window_group([w], lseeds.reshape(1, -1), coefs,
                                   alpha=alpha, dtheta=dtheta, impl=impl,
                                   n_cols=[n_cols])[0]


def mgd_update_window_group(leaves, lseeds, coefs, *, alpha, dtheta,
                            impl=None, n_cols=None, out=None):
    """``mgd_update_window`` of every leaf in ``leaves`` (ndim ≥ 2 each),
    with the seeds of leaf l in row l of ``lseeds`` [L, J] (an int32 tensor
    of uint32 bit patterns, or host ints) and its signs' row stride in
    ``n_cols[l]`` (None: its N); returns the updated leaves, written into
    ``out`` (contiguous tensors shaped as the leaves) when it is given.

    On the card one launch updates up to ``mgd_update.MAX_LEAVES`` leaves
    of a dtype, and the kernel forms each term α·(Δθ·coefs[j]) in f32 in
    the reference's association; the plain version is the per-leaf loop.
    """
    leaves = list(leaves)
    if not leaves:
        return []
    n_cols = list(n_cols) if n_cols is not None else [None] * len(leaves)
    if resolve_impl(impl, leaves[0]) == "ref":
        new = [mgd_update_window(w, lseeds[i], coefs, alpha=alpha,
                                 dtheta=dtheta, impl="ref", n_cols=n_cols[i])
               for i, w in enumerate(leaves)]
        if out is None:
            return new
        for o, n in zip(out, new):
            o.copy_(n)
        return list(out)
    if not isinstance(lseeds, torch.Tensor):
        lseeds = seeds_tensor([list(row) for row in lseeds],
                              leaves[0].device)
    outs = _mu.mgd_update_window_group(
        [_as_matrix(w).contiguous() for w in leaves], lseeds,
        coefs.float().contiguous(), alpha=alpha, dtheta=dtheta,
        n_cols=n_cols,
        out=None if out is None else [_as_matrix(o) for o in out])
    return [o.reshape(w.shape) for o, w in zip(outs, leaves)]


def mgd_update(w, lseeds, coefs, *, eta, dtheta, impl=None, n_cols=None):
    """W − (η/Δθ)·Σ_j coefs[j]·sign_j: the window's sum first, in an f32
    accumulator, then one subtract (the reference's ``mgd_update``).

    ``lseeds`` are [J] uint32 seeds (host ints or an int32 bit-pattern
    tensor), ``coefs`` a [J] float32 tensor (the C̃ of each window step).
    Any ndim ≥ 2 leaf is viewed row-major as a matrix whose signs' row
    stride is ``n_cols`` (None: its N).
    """
    shape = w.shape
    w2 = _as_matrix(w)
    if resolve_impl(impl, w) == "ref":
        return _ref.mgd_update_ref(w2, lseeds, coefs, eta=eta,
                                   dtheta=dtheta, n_cols=n_cols
                                   ).reshape(shape)
    if not isinstance(lseeds, torch.Tensor):
        lseeds = seeds_tensor(list(lseeds), w.device)
    scale = f32(float(eta) / float(dtheta)).item()
    return _mu.mgd_update(w2.contiguous(), lseeds,
                          coefs.float().contiguous(), scale=scale,
                          n_cols=n_cols).reshape(shape)
