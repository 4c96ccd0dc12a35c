"""Shared building blocks (plain functions on dicts of tensors).

Parameters keep the JAX package's layout (``{"w": [d_in, d_out],
"b": [d_out]}``, ``{"scale": [d]}``, ``{"table": [vocab, d]}``), so leaf
ids and sign indices match it.  Compute dtype follows the input;
normalization statistics are f32.  Init functions draw from an explicit
``torch.Generator`` on the generator's device.  Convolutions take NHWC
activations and HWIO weights, as the reference stores them, and permute
only inside ``conv2d``/``maxpool2``.

``pdense`` is the perturbable counterpart of ``dense`` on the fused probe
path: the weight matmul goes through the perturbed-matmul kernels, which
regenerate the Rademacher signs next to the multiply, so θ̃ of a weight
never exists in device memory; an antithetic central pair (signs
(+1, −1)) uses the pair kernel and reads W once per pair.  Biases are
O(d) and take a materialized θ̃.  Perturbable ops take and return a tuple
of activation streams, one per probe sign, plus the leaf-id subtree that
anchors every leaf to the global hash.

On a DeviceMesh a weight is a DTensor and its kernel runs on the local
shard: the shard's offset (r0, c0) folds into the seed (r0·N + c0) and the
leaf's N is the signs' row stride (``n_cols``), so every sign is the
unsharded one.  The streams are placed as the shard needs
(``_shard_product``, which ``dense`` shares on a DTensor weight): over a
mesh dim that splits the streams' rows (the batch), or that the active
rules give to "fsdp", W's block is gathered, as FSDP gathers it; else a
column shard takes the streams whole over its mesh dim and gives its
columns, and a row shard takes the streams' matching block of their last
dim and gives a partial sum (tensor parallelism: no weight is gathered).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.core import perturbations as pert
from repro_torch.core.perturbations import MASK
from repro_torch.core.utils import f32, is_dtensor
from repro_torch.kernels import ops as kops


def gen_device(gen):
    """The device ``gen`` draws on.  ``None`` stands for the meta device
    (``model_init(..., device="meta")``: shapes and dtypes, nothing drawn
    or allocated), where torch has no generator."""
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias=False,
               dtype=torch.float32, scale=None, device=None):
    """W ~ N(0, 1)·scale (default 1/sqrt(d_in)) drawn from ``gen`` on the
    generator's device, then placed on ``device``; zero bias."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen_device(gen)) * scale
    p = {"w": w.to(dtype).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    w = p["w"]
    y = _sharded_matmul(x, w) if is_dtensor(w) else x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def groupnorm_heads(p, x, n_heads: int, eps=1e-5):
    """GroupNorm with one group per head over the flattened head dim
    (RWKV-6's ln_x), statistics in f32.  x: [..., H·D]."""
    *lead, hd = x.shape
    xf = x.float().reshape(*lead, n_heads, hd // n_heads)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, hd)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device=None):
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen_device(gen)) * 0.02
    return {"table": table.to(dtype).to(device)}


def embed(p, ids):
    table = p["table"]
    if is_dtensor(table):
        # a DTensor table: ``embedding`` is the gather DTensor shards over
        # the vocabulary (masked lookup + reduction); the same rows.  The
        # reduction is settled here, then the rows placed (DTensor cannot
        # turn the masked partial into a batch shard in one move), before
        # any op reshapes them.
        from repro_torch.distributed.sharding import settle, shard
        return shard(settle(F.embedding(ids.long(), table)), "batch")
    return table[ids.long()]


def glu_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                 dtype=torch.float32, device=None):
    """Gated (SwiGLU) MLP — the LM-family feedforward."""
    return {
        "gate": dense_init(gen, d, d_ff, dtype=dtype, device=device),
        "up": dense_init(gen, d, d_ff, dtype=dtype, device=device),
        "down": dense_init(gen, d_ff, d, dtype=dtype, device=device),
    }


def glu_mlp(p, x):
    h = F.silu(dense(p["gate"], x).float()).to(x.dtype)
    return dense(p["down"], h * dense(p["up"], x))


def _stream_offset(layer: int, nelem: int) -> int:
    """Element offset of layer ``layer``'s slice in a stacked leaf (uint32
    wraparound, as the generator's uint32 iota)."""
    return (int(layer) * (int(nelem) & MASK)) & MASK


def pleaf(leaf, leaf_id, probe, *, layer=None):
    """Per-stream perturbed values of a non-matmul leaf (or its layer
    slice), in the materializing optimizer's float order; a DTensor leaf's
    θ̃ is formed on its local shard."""
    offset = 0 if layer is None else _stream_offset(layer, leaf.numel())
    theta = pert.leaf_theta(
        leaf, pert.shifted_leaf_seed(probe.lseed(leaf_id), offset),
        probe.ctx.dtheta)
    return tuple(pert.apply_signed(leaf, theta, s) for s in probe.ctx.signs)


def _shard_product(xs, w):
    """Streams and ``w`` [K, N] placed for a product shard by shard, and
    the product's placements, mesh dim by mesh dim: where the streams'
    rows (batch, sequence) are split, or the active rules give the mesh
    dim to "fsdp" (``MOE_EP_RULES`` splits the dense weights' rows over
    "model" so), W's block over that dim is gathered (FSDP, as the
    reference's program gathers it) and the product keeps the streams'
    rows' placement; else where W is split by columns the streams are
    whole and the product takes W's columns; where W is split by rows
    (tensor parallelism) the streams take the matching block of their
    last dim and the product is a partial sum; elsewhere the streams keep
    their placement (a split of their last dim is gathered)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.distributed.sharding import fsdp_axes, replicate, settle
    xs = tuple(settle(replicate(x, w.device_mesh)) for x in xs)
    last = xs[0].dim() - 1
    fsdp = fsdp_axes(w.device_mesh)
    want, want_w, out = [], [], []
    names = w.device_mesh.mesh_dim_names or (None,) * w.device_mesh.ndim
    for name, pw, px in zip(names, w.placements, xs[0].placements):
        rows = isinstance(px, Shard) and px.dim != last
        gather = rows or name in fsdp
        if gather or not isinstance(pw, Shard):
            keep = rows or not isinstance(px, Shard)
            want.append(px if keep else Replicate())
            want_w.append(Replicate() if gather else pw)
            out.append(want[-1])
        elif pw.dim == 1:
            want.append(Replicate())
            want_w.append(pw)
            out.append(Shard(last))
        else:
            want.append(Shard(last))
            want_w.append(pw)
            out.append(Partial())
    xs = tuple(x.redistribute(x.device_mesh, want) for x in xs)
    if tuple(want_w) != tuple(w.placements):
        w = w.redistribute(w.device_mesh, want_w)
    return xs, w, tuple(out)


def _from_local(y, mesh, placements, shape):
    """The local product ``y`` as a DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(y, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _sharded_matmul(x, w):
    """``x @ w`` for a DTensor ``w`` [K, N], placed by ``_shard_product``
    as the fused path places its products, so the unfused and fused steps
    move and reduce the same blocks.  The local product stands for one
    block of the global one a split (or partial) mesh dim
    (``launch.op_cost`` counts it so)."""
    from torch.distributed.tensor import Shard
    from repro_torch.distributed.sharding import block_work
    (x,), w, out_pl = _shard_product((x,), w)
    mesh = w.device_mesh
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    with block_work(mesh, tuple(Shard(0) if p.is_partial() else p
                                for p in out_pl)):
        y = x.to_local() @ w.to_local()
    return _from_local(y, mesh, out_pl, shape)


def _pmatmul(xs, w, lseed, ctx):
    """The per-stream products xs @ (W ± θ̃), W's sign seed ``lseed``:
    one pair-kernel launch for a central pair, else one a stream; on a
    DTensor W the kernels take its local shard (``_shard_product``)."""
    sharded = is_dtensor(w)
    n_cols = None
    if sharded:
        xs, w, out_pl = _shard_product(xs, w)
        local_shape, offset = pert.shard_layout(w)
        lseed = pert.shifted_leaf_seed(lseed, offset[0] * w.shape[1]
                                       + offset[1])
        n_cols = w.shape[1]
        mesh, shape = w.device_mesh, tuple(xs[0].shape[:-1]) + (w.shape[1],)
        xs, w = tuple(x.to_local() for x in xs), w.to_local()
    if ctx.is_pair:
        ys = kops.perturbed_matmul_pair(
            xs[0], xs[1], w, lseed, dtheta=ctx.dtheta, impl=ctx.impl,
            n_cols=n_cols)
    else:
        ys = tuple(
            kops.perturbed_matmul(
                x, w, lseed, dtheta=ctx.dtheta, sign=s, impl=ctx.impl,
                n_cols=n_cols)
            for x, s in zip(xs, ctx.signs))
    if not sharded:
        return tuple(ys)
    return tuple(_from_local(y, mesh, out_pl, shape) for y in ys)


def pdense(p, xs, ids, probe, *, layer=None):
    """Perturbable dense: xs (tuple of per-sign streams) @ (W ± θ̃) + (b ± θ̃_b).

    ``ids`` is the leaf-id subtree aligned with ``p``; ``layer`` the
    stacked-bank slice index (or None).
    """
    w = p["w"]
    lseed = probe.lseed(ids["w"])
    if layer is not None:
        lseed = pert.shifted_leaf_seed(
            lseed, _stream_offset(layer, w.shape[-2] * w.shape[-1]))
    ys = _pmatmul(xs, w, lseed, probe.ctx)
    if "b" in p:
        bs = pleaf(p["b"], ids["b"], probe, layer=layer)
        ys = tuple(y + b for y, b in zip(ys, bs))
    return tuple(ys)


def prmsnorm(p, xs, ids, probe, *, layer=None, eps=1e-5):
    """Per-stream rmsnorm with the scale leaf perturbed (materialized)."""
    scales = pleaf(p["scale"], ids["scale"], probe, layer=layer)
    return tuple(rmsnorm({"scale": sc}, x, eps)
                 for sc, x in zip(scales, xs))


def pembed(p, tokens, ids, probe):
    """Per-stream rows of the perturbed embedding table, ``take(table ±
    θ̃, tokens)``, with θ̃ generated for the gathered rows only.

    The sign of element (t, c) has index t·d + c in the table's row-major
    order, and ``apply_signed`` is elementwise, so this equals
    materializing θ̃ over the whole [vocab, d] table and gathering, bit for
    bit, at the cost of the rows the batch reads."""
    table = p["table"]
    d = table.shape[-1]
    tok = tokens.long()
    if is_dtensor(tok):
        from repro_torch.distributed.sharding import full
        tok = full(tok)
    idx = (tok[..., None] * d
           + torch.arange(d, dtype=torch.int64, device=tok.device)) & MASK
    sgn = pert.rademacher_signs(probe.lseed(ids["table"]), idx)
    theta = (sgn * f32(probe.ctx.dtheta)).to(table.dtype)
    if is_dtensor(table):
        # a vocabulary-sharded table: its rows gathered as ``embed`` does;
        # θ̃ of those rows is the same on every rank
        from repro_torch.distributed.sharding import replicate, settle
        rows = settle(F.embedding(replicate(tok, table.device_mesh), table))
        theta = replicate(theta, table.device_mesh)
    else:
        rows = table[tok]
    return tuple(pert.apply_signed(rows, theta, s) for s in probe.ctx.signs)


# --- convolutions for the paper-scale CNNs ---------------------------------


def conv2d_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                c_out: int, dtype=torch.float32, device=None):
    """W [kh, kw, c_in, c_out] (HWIO, the reference's layout, so the
    perturbation hash's row-major indices land on the same elements)
    ~ N(0, 1)/sqrt(kh·kw·c_in) drawn from ``gen``; zero bias."""
    scale = 1.0 / math.sqrt(kh * kw * c_in)
    w = torch.randn((kh, kw, c_in, c_out), generator=gen,
                    dtype=torch.float32, device=gen_device(gen)) * scale
    return {"w": w.to(dtype).to(device),
            "b": torch.zeros((c_out,), dtype=dtype, device=device)}


def _same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding of one spatial dim: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def full_f32_matmul():
    """cuBLAS's TF32 off for the enclosed f32 matmuls and einsums, the
    caller's setting back after them (the MoE router and the MLA decode's
    f32 einsums, which the reference computes in full f32)."""
    mm = torch.backends.cuda.matmul
    tf32 = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32 = tf32


@contextlib.contextmanager
def _cudnn_full_f32():
    """cuDNN's TF32 off and its algorithms deterministic for the enclosed
    calls, the caller's settings back after them.  Otherwise cuDNN is
    free to pick a nondeterministic algorithm (a weight gradient summed
    with atomics): the CIFAR CNN's 16 backprop steps on the card landed
    1.2e-5 from the CPU's in one run and 3e-8 in another."""
    cudnn = torch.backends.cudnn
    tf32, det = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = tf32, det


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` (NCHW, OIHW) whose forward and backward both run with
    cuDNN's TF32 off and its algorithms deterministic, whatever the
    caller's setting."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        with _cudnn_full_f32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        gx = gw = None
        with _cudnn_full_f32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, gy, stride,
                                                padding)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, gy, stride,
                                                 padding)
        return gx, gw, None, None


def conv2d(p, x, *, stride=1, padding="SAME"):
    """x: [B, H, W, C] NHWC, W HWIO → [B, H', W', C_out] NHWC.

    One ``torch.nn.functional.conv2d`` (the reference computes this conv
    outside any Pallas kernel) in full f32 on a card, forward and
    backward: cuDNN's TF32 is off for this call whatever the caller's
    setting, since C̃ at Δθ = 1e-3 is a difference of two costs that TF32
    rounding would swamp."""
    w = p["w"]
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)                        # NCHW
    if padding == "SAME":
        (ht, hb), (wl, wr) = (_same_pads(x.shape[1], kh, stride),
                              _same_pads(x.shape[2], kw, stride))
        if (ht, wl) == (hb, wr):
            pad = (ht, wl)
        else:
            xc, pad = F.pad(xc, (wl, wr, ht, hb)), (0, 0)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    y = _Conv2dF32.apply(xc, w.permute(3, 2, 0, 1), (stride, stride), pad)
    return y.permute(0, 2, 3, 1) + p["b"]


def maxpool2(x):
    """2×2 max-pool, stride 2, VALID (floor). x: [B, H, W, C]."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
