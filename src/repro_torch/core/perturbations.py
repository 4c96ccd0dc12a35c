"""Perturbation generators for multiplexed gradient descent (paper §2.1, §3.4).

PyTorch counterpart of ``repro.core.perturbations``.  Four families:
``rademacher`` (counter-hashed ±Δθ, the default and the only one the
fused path and the CUDA kernels regenerate), ``walsh``, ``sequential``
and ``sinusoidal``.  Every generator is a pure function of (shapes, step,
seed): no state, no global RNG.

The murmur3 counter hash has two forms that agree bit for bit:

* a **host-int** form (Python ints masked to 32 bits) for the per-leaf
  seeds handed to kernels, so a step never reads the device;
* a **tensor** form for the plain versions.  torch on the CPU has no
  uint32 ``+``/``>>``/``*``, so it computes in int64 and masks with
  ``& 0xFFFFFFFF``; the 32-bit product is split into 16-bit halves so no
  int64 product overflows.

Negative steps (the replay window can reach before step 0 under
staleness) wrap as uint32, and ``step // tau_p`` is floor division, both
as in the reference.

Signs on a shard.  A leaf may be a DTensor placed on a device mesh
(``distributed.sharding``).  Its θ̃ is then formed on the local shard
alone, each local element hashed at its *global* row-major index
(``shard_index``, from the shard's offset): θ̃ of a sharded leaf is the
unsharded θ̃ restricted to the shard, bit for bit, and its
``full_tensor()`` the unsharded θ̃.  The kernels take a shard as row runs
(``shard_runs``): each run's first global index folds into the seed
(``shifted_leaf_seed``) and the leaf's last dim is the signs' row stride
(the kernels' ``n_cols``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Optional

import torch

from .utils import f32, is_dtensor, leaf_meta, tree_flatten, tree_unflatten

PERTURBATION_TYPES = ("rademacher", "walsh", "sequential", "sinusoidal")

MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _u32(x):
    """uint32 view of a host int or an int64 tensor (two's-complement wrap)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mul32(a, b: int):
    """``(a * b) mod 2**32`` for ``0 <= a, b < 2**32``."""
    if not isinstance(a, torch.Tensor):
        return (a * b) & MASK
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & MASK


def _fmix32(x):
    """murmur3 32-bit finalizer on a host int or an int64 tensor."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def leaf_seed(seed, pert_step, leaf_id):
    """32-bit per-(step, leaf) seed; host ints in, host int out (tensors
    are accepted elementwise too)."""
    s = (_mul32(_u32(seed), _GOLDEN) + _u32(leaf_id)) & MASK
    s = _fmix32(s)
    s = (s + _mul32(_u32(pert_step), _M1)) & MASK
    return _fmix32(s)


def rademacher_signs(lseed, idx: torch.Tensor) -> torch.Tensor:
    """±1 float32 signs from a leaf seed and uint32 intra-leaf indices;
    ``rademacher_signs.signs_hashed`` counts the indices hashed."""
    rademacher_signs.signs_hashed += idx.numel()
    h = _fmix32((_mul32(_u32(idx), _GOLDEN) + _u32(lseed)) & MASK)
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)


rademacher_signs.signs_hashed = 0


def _walsh_signs(pert_step: int, idx: torch.Tensor) -> torch.Tensor:
    """Walsh function W_{i+1}(t): (-1)^popcount((i+1) & t)."""
    v = ((_u32(idx) + 1) & MASK) & _u32(pert_step)
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    parity = (v & 1).to(torch.float32)
    return 1.0 - 2.0 * parity


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def shard_layout(leaf):
    """(local shape, global offset of the local block) of a DTensor
    leaf."""
    return local_layout(tuple(leaf.shape), leaf.device_mesh,
                        tuple(leaf.placements))


def local_layout(shape, mesh, placements):
    """(local shape, global offset) of this rank's block of a tensor of
    ``shape`` under ``placements``.  It reads the rank's mesh coordinate,
    so under ``FakeTensorMode`` (the dry run) it steps out of it."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        local, offset = compute_local_shape_and_global_offset(
            shape, mesh, placements)
    return tuple(local), tuple(offset)


def shard_index(shape, local_shape, offset, rows=None, device=None):
    """Global row-major flat indices (int64, flattened) of a local block
    of ``local_shape`` at ``offset`` in a tensor of ``shape``, or of its
    rows ``rows = (start, stop)``, the block viewed as a matrix [every
    leading dim, last dim].  A column shard's indices are strided, not
    one range, so each row's start is built dim by dim."""
    if not shape:
        return torch.zeros((1,), dtype=torch.int64, device=device)
    lo, hi = rows if rows is not None else (0, math.prod(local_shape[:-1]))
    rest = torch.arange(lo, hi, dtype=torch.int64, device=device)
    base = torch.zeros_like(rest)
    stride = shape[-1]
    for d in range(len(shape) - 2, -1, -1):
        base = base + (rest % local_shape[d] + offset[d]) * stride
        rest = torch.div(rest, local_shape[d], rounding_mode="floor")
        stride *= shape[d]
    cols = torch.arange(offset[-1], offset[-1] + local_shape[-1],
                        dtype=torch.int64, device=device)
    return (base[:, None] + cols[None, :]).reshape(-1)


def local_device(leaf):
    """The device of a leaf's data (a DTensor's local shard's)."""
    return leaf.to_local().device if is_dtensor(leaf) else leaf.device


def shard_runs(shape, local_shape, offset):
    """The local block (``local_shape`` at ``offset``) of a tensor of
    ``shape``, ndim ≥ 2, as runs the kernels take: [(index into the local
    block, global row-major index of the run's first element)].  A run is
    the local sub-block below its index, contiguous, whose rows lie one
    global row stride apart once viewed as a matrix [rows, shape[-1]]: the
    kernel takes it with ``n_cols = shape[-1]`` and its first index folded
    into the seed.  One run unless a row dim other than the outermost is
    split, as a row shard of a stacked [L, d_in, d_out] bank is (one run a
    layer)."""
    n = len(shape)
    m = n - 2
    while m > 0 and local_shape[m] == shape[m]:
        m -= 1
    strides = [math.prod(shape[d + 1:]) for d in range(n)]
    base = offset[m] * strides[m] + offset[n - 1]
    runs = []
    for idx in itertools.product(*(range(t) for t in local_shape[:m])):
        start = base + sum((i + offset[d]) * strides[d]
                           for d, i in enumerate(idx))
        runs.append((idx, start))
    return runs


def _leaf_index(leaf, n: int):
    """Hash indices of every element ``generate`` forms for ``leaf``: the
    iota of a whole leaf, or a shard's global indices."""
    if not is_dtensor(leaf):
        return _iota(n, leaf.device)
    local_shape, offset = shard_layout(leaf)
    return shard_index(tuple(leaf.shape), local_shape, offset,
                       device=leaf.to_local().device)


def _rademacher_values(leaf, lseed, dtheta, dtype, chunk=None):
    """``(signs · f32(Δθ)).to(dtype)`` for every element of ``leaf`` (its
    local shard if a DTensor), formed in passes of at most ``chunk``
    elements (``THETA_CHUNK``): the int64 hash temporaries of a
    full-width leaf never exist whole."""
    chunk = chunk or THETA_CHUNK
    if not is_dtensor(leaf):
        n = leaf.numel()
        res = torch.empty((n,), dtype=dtype, device=leaf.device)
        for start in range(0, n, chunk):
            stop = min(n, start + chunk)
            res[start:stop] = theta_range(lseed, start, stop, dtheta, dtype,
                                          leaf.device)
        return res.reshape(leaf.shape)
    from torch.distributed.tensor import DTensor
    local_shape, offset = shard_layout(leaf)
    dev = leaf.to_local().device
    res = torch.empty(local_shape, dtype=dtype, device=dev)
    if res.numel():
        cols = local_shape[-1] if local_shape else 1
        rows = res.numel() // cols
        flat = res.reshape(rows, cols)
        step_rows = max(1, chunk // cols)
        for r0 in range(0, rows, step_rows):
            r1 = min(rows, r0 + step_rows)
            idx = shard_index(tuple(leaf.shape), local_shape, offset,
                              rows=(r0, r1) if local_shape else None,
                              device=dev)
            flat[r0:r1] = (rademacher_signs(lseed, idx) * f32(dtheta)).to(
                dtype).reshape(r1 - r0, -1)
    return DTensor.from_local(res, leaf.device_mesh, leaf.placements,
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def leaf_theta(leaf, lseed, dtheta, dtype=None):
    """Rademacher θ̃ = signs·f32(Δθ) of a leaf under leaf seed ``lseed``,
    as ``generate`` forms it, in ``dtype`` (default the leaf's): a plain
    tensor for a plain leaf, the local shard's as a DTensor of the leaf's
    placements for a DTensor leaf (a layer slice of a stacked bank takes
    its layer's offset folded into ``lseed``)."""
    return _rademacher_values(leaf, lseed, dtheta, dtype or leaf.dtype)


def _as_leaf(values, leaf, dtype):
    """Flat per-element values shaped as ``leaf`` — a DTensor with the
    leaf's placements when the leaf is one."""
    if not is_dtensor(leaf):
        return values.reshape(leaf.shape).to(dtype)
    from torch.distributed.tensor import DTensor
    local = values.reshape(shard_layout(leaf)[0]).to(dtype)
    return DTensor.from_local(local, leaf.device_mesh, leaf.placements,
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def generate(params_like, *, ptype, step: int, seed: int, dtheta: float,
             tau_p: int = 1, total: Optional[int] = None):
    """The perturbation pytree θ̃ for global timestep ``step`` (host int).

    Only the leaves' shapes, dtypes and devices are read.  Bit-identical
    to the reference for rademacher, walsh and sequential; sinusoidal
    agrees to the rounding of ``sin``.
    """
    if ptype not in PERTURBATION_TYPES:
        raise ValueError(f"unknown perturbation type {ptype!r}")
    metas = leaf_meta(params_like)
    total = total or sum(m[2] for m in metas)
    step = int(step)
    pert_step = step // int(tau_p)
    leaves, treedef = tree_flatten(params_like)
    out = []
    for (lid, offset, n), leaf in zip(metas, leaves):
        if ptype == "rademacher":
            out.append(_rademacher_values(
                leaf, leaf_seed(seed, pert_step, lid), dtheta, leaf.dtype))
            continue
        iota = _leaf_index(leaf, n)
        if ptype == "walsh":
            idx = (iota + _u32(offset)) & MASK
            pert = _walsh_signs(pert_step, idx) * f32(dtheta)
        elif ptype == "sequential":
            active = pert_step % int(total)
            idx = iota + offset
            pert = (idx == active).to(torch.float32) * f32(dtheta)
        else:   # sinusoidal
            if is_dtensor(leaf):
                idx = iota.to(torch.float32) + f32(float(offset))
            else:
                idx = torch.arange(n, dtype=torch.float32,
                                   device=leaf.device) + f32(float(offset))
            f = (idx + f32(1.0)) / f32(float(total + 1)) \
                * f32(0.5 / float(tau_p))
            t = f32(float(step))
            pert = f32(dtheta) * torch.sin(f32(2.0 * math.pi) * f * t)
        out.append(_as_leaf(pert, leaf, leaf.dtype))
    return tree_unflatten(treedef, out)


def generate_signs_only(params_like, *, step: int, seed: int,
                        tau_p: int = 1):
    """Rademacher ±1 signs (no Δθ), float32, one tensor per leaf."""
    pert_step = int(step) // int(tau_p)
    leaves, treedef = tree_flatten(params_like)
    out = []
    for (lid, _, n), leaf in zip(leaf_meta(params_like), leaves):
        out.append(_rademacher_values(
            leaf, leaf_seed(seed, pert_step, lid), 1.0, torch.float32))
    return tree_unflatten(treedef, out)


THETA_CHUNK = 1 << 26   # elements a pass of ``perturbed_tree``'s hash


def theta_range(lseed, start: int, stop: int, dtheta: float, dtype,
                device=None) -> torch.Tensor:
    """Rademacher θ̃ of a flattened leaf's elements ``start .. stop − 1``
    under leaf seed ``lseed``: the hash's index is the element's row-major
    index, wrapped to uint32 as the reference's uint32 iota wraps, and is
    formed in int64, so no index past 2³¹ changes sign."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return (rademacher_signs(lseed, idx) * f32(dtheta)).to(dtype)


def perturbed_tree(params, *, step: int, seed: int, dtheta: float,
                   tau_p: int = 1, sign: float = 1.0,
                   chunk: int = THETA_CHUNK):
    """``params + sign·θ̃`` for the rademacher θ̃ of ``step``, bit for bit
    ``tree_add(params, generate(...))`` for sign = +1 and
    ``tree_axpy(sign, generate(...), params)`` otherwise (``apply_signed``'s
    float order), formed leaf by leaf in passes of at most ``chunk``
    elements: neither θ̃ nor its int64 hash temporaries ever exist whole,
    which a full-width materializing probe could not hold beside the
    params.  A DTensor leaf is formed on its local shard, in passes of
    whole rows of its matrix view (every leading dim × the last)."""
    pert_step = int(step) // int(tau_p)
    leaves, treedef = tree_flatten(params)
    out = []
    for lid, leaf in enumerate(leaves):
        lseed = leaf_seed(seed, pert_step, lid)
        if is_dtensor(leaf):
            out.append(_perturbed_shard(leaf, lseed, dtheta, sign, chunk))
            continue
        flat = leaf.reshape(-1)
        res = torch.empty_like(flat)
        for start in range(0, flat.numel(), chunk):
            stop = min(flat.numel(), start + chunk)
            theta = theta_range(lseed, start, stop, dtheta, leaf.dtype,
                                leaf.device)
            res[start:stop] = apply_signed(flat[start:stop], theta, sign)
        out.append(res.reshape(leaf.shape))
    return tree_unflatten(treedef, out)


def _perturbed_shard(leaf, lseed, dtheta, sign, chunk):
    """``perturbed_tree``'s leaf + sign·θ̃ of a DTensor leaf, on its local
    shard: rows of the local block at a time, each element hashed at its
    global index."""
    from torch.distributed.tensor import DTensor
    local = leaf.to_local()
    local_shape, offset = shard_layout(leaf)
    res = torch.empty_like(local)
    if local.numel():
        cols = local_shape[-1] if local.dim() else 1
        rows = local.numel() // cols
        step_rows = max(1, chunk // cols)
        flat_res = res.reshape(rows, cols)
        flat_in = local.reshape(rows, cols)
        for r0 in range(0, rows, step_rows):
            r1 = min(rows, r0 + step_rows)
            idx = shard_index(tuple(leaf.shape), local_shape, offset,
                              rows=(r0, r1) if local.dim() else None,
                              device=local.device)
            theta = (rademacher_signs(lseed, idx) * f32(dtheta)).to(
                leaf.dtype)
            flat_res[r0:r1] = apply_signed(
                flat_in[r0:r1].reshape(-1), theta, sign).reshape(r1 - r0, -1)
    return DTensor.from_local(res, leaf.device_mesh, leaf.placements,
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def shifted_leaf_seed(lseed: int, offset_elems: int) -> int:
    """Seed under which a kernel's local indices reproduce the global signs
    of a row-major slice that starts ``offset_elems`` into the leaf:
    fmix32((i+Δ)·G + s) == fmix32(i·G + (s + Δ·G))."""
    return (_u32(lseed) + _mul32(_u32(offset_elems), _GOLDEN)) & MASK


def apply_signed(leaf, theta, sign: float):
    """``leaf + sign·θ̃`` in the materializing optimizer's float order:
    ``tree_add`` for sign = +1, the f32 ``tree_axpy`` otherwise."""
    if sign == 1.0:
        return leaf + theta
    return (leaf.float() + f32(sign) * theta.float()).to(leaf.dtype)


@dataclasses.dataclass(frozen=True)
class ProbeCtx:
    """Static descriptor of a fused probe evaluation.

    ``signs`` is (1.0,) for a forward probe and (1.0, −1.0) for an
    antithetic central pair (routed through the pair kernel).  ``impl``
    selects the kernel route: ``"cuda"``, ``"ref"`` or ``None`` (by the
    tensors' device).
    """

    signs: tuple = (1.0,)
    dtheta: float = 1e-3
    tau_p: int = 1
    impl: Optional[str] = None

    @property
    def n_streams(self) -> int:
        return len(self.signs)

    @property
    def is_pair(self) -> bool:
        return self.signs == (1.0, -1.0)


class Probe(NamedTuple):
    """One probe evaluation: host step and seed plus the static context."""

    step: int
    seed: int
    ctx: ProbeCtx

    def lseed(self, leaf_id: int) -> int:
        """Per-leaf kernel seed: the hash chain of ``generate``."""
        return leaf_seed(self.seed, int(self.step) // int(self.ctx.tau_p),
                         leaf_id)


def orthogonality_check(ptype, n_params, n_steps, *, seed=0, dtheta=1.0,
                        tau_p=1, device=None):
    """Empirical Gram matrix of the perturbation sequences (test helper):
    the (n_params, n_params) time-average of θ̃ᵢθ̃ⱼ.  Pairwise
    orthogonality is Gram ≈ Δθ²·I (sinusoids: Δθ²/2·I).  Runs on the
    card unless ``device="cpu"``."""
    from repro_torch.device import resolve_device

    dummy = {"w": torch.zeros((n_params,), dtype=torch.float32,
                              device=resolve_device(device))}
    seq = torch.stack([
        generate(dummy, ptype=ptype, step=t, seed=seed, dtheta=dtheta,
                 tau_p=tau_p)["w"] for t in range(n_steps)])   # [T, P]
    return (seq.T @ seq) / f32(float(n_steps))
