"""Mixture-of-Experts with grouped one-hot dispatch.

PyTorch counterpart of ``repro.models.moe``.  Tokens are split into
groups of ``group_size``; each group routes its tokens to their top-k
experts under a per-group capacity C = ceil(group·k/E·cf), rounded up to
a multiple of 4.  The dispatch and combine tensors are [G, Sg, E, C].  A
token's capacity position within its expert counts the routings before
it in (s, k) order; routings past C are dropped (combine weight 0).  The
top-k gates are renormalized over the selected experts (DeepSeek-V3); an
optional shared expert runs densely on every token.

The reference computes all of this in plain ``jnp`` (no Pallas kernel),
so the port does it in plain PyTorch: the router in f32 with TF32 off,
ties of the top-k going to the lower expert index as in
``jax.lax.top_k``, and the three expert einsums in the model's dtype with
SiLU in f32.

``DropRecorder`` counts, while it is entered, the routings ``moe_apply``
makes and the ones capacity drops (device tensors, read once at the end).

On a DeviceMesh the tokens' groups are split over the batch axes, the
router's logits are gathered whole over the experts (the router stays f32
and every rank routes its own groups, ``sharding.local_apply``), and the
expert tensors lie as the reference places them, experts over "expert"
and groups over "batch" (its ``shard(expert_in, "expert", "batch", None,
None)``): each rank dispatches its groups' tokens to its own block of
experts (``_expert_dispatch``), runs its local expert banks, and
combines their outputs into a partial sum over the expert axis
(``_expert_combine``), reduced once: no rank forms another rank's
experts' inputs or outputs.  A bank's FSDP split (its d or f over
"data") is gathered first (``_gather_bank``), as the reference's program
gathers it, so each expert's contraction is summed whole on one rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.utils import f32, is_dtensor
from repro_torch.distributed.sharding import (active_mesh, block_work,
                                              full, local_apply, settle,
                                              shard)
from .layers import (dense, dense_init, full_f32_matmul, gen_device, glu_mlp,
                     glu_mlp_init)

_RECORDERS = []


class DropRecorder:
    """Inside ``with DropRecorder() as rec:``, every ``moe_apply`` call
    appends its routings (a host int) and the ones it kept (a device
    tensor) to ``rec.calls``; ``totals()`` reads them back as host ints."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)
        return False

    def totals(self):
        """(routings, dropped) summed over the recorded calls."""
        routed = sum(r for r, _ in self.calls)
        return routed, routed - sum(int(kept) for _, kept in self.calls)


def moe_init(gen: torch.Generator, cfg, dtype, device=None):
    """f32 router [d, E], expert banks gate/up [E, d, f] and down [E, f, d]
    in ``dtype``, and the shared GLU expert when ``cfg.n_shared_experts``.
    A bank is drawn one expert at a time, so the f32 draw never holds a
    whole bank."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale = 1.0 / math.sqrt(d)

    def bank(d_in, d_out):
        out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
        for i in range(e):
            out[i] = (torch.randn((d_in, d_out), generator=gen,
                                  dtype=torch.float32, device=gen_device(gen))
                      * scale).to(dtype)
        return out

    p = {
        "router": dense_init(gen, d, e, dtype=torch.float32, device=device),
        "gate": bank(d, f),
        "up": bank(d, f),
        "down": bank(f, d),
    }
    if cfg.n_shared_experts:
        p["shared"] = glu_mlp_init(gen, d, f * cfg.n_shared_experts, dtype,
                                   device)
    return p


def capacity(group_size: int, top_k: int, n_experts: int,
             factor: float = 1.25, multiple: int = 4) -> int:
    c = math.ceil(group_size * top_k / n_experts * factor)
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


def top_k(probs: torch.Tensor, k: int):
    """The k largest of the last dim, descending, equal values in index
    order (``jax.lax.top_k``'s ties; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(probs: torch.Tensor, k: int):
    """(top-k gates renormalized over the selected experts, expert ids)."""
    gate_vals, expert_idx = top_k(probs, k)
    return gate_vals / (gate_vals.sum(-1, keepdim=True) + f32(1e-9)), \
        expert_idx


def router_probs(p, xg):
    """Softmax over experts of the f32 router logits, TF32 off; under a
    mesh the logits are first made whole over the experts."""
    with full_f32_matmul():
        logits = dense(p["router"], xg.float())
    if active_mesh() is not None:
        logits = shard(logits, "batch", None, None)
    return torch.softmax(logits, dim=-1)


def route(probs: torch.Tensor, k: int, c: int):
    """Routing of router probabilities [G, Sg, E] at capacity ``c``:
    (gates [G, Sg, K] renormalized, expert ids [G, Sg, K], combine
    [G, Sg, E, C] f32, keep [G, Sg, K, E])."""
    g, gs, e = probs.shape
    gate_vals, expert_idx = _gates(probs, k)
    onehot = F.one_hot(expert_idx, e).float()                 # [G,Sg,K,E]
    # position of each (token, k) routing within its expert, in (s, k) order
    flat = onehot.reshape(g, gs * k, e)
    pos = ((torch.cumsum(flat, dim=1) - f32(1.0)) * flat).reshape(
        g, gs, k, e)
    keep = (pos < c) & (onehot > 0)
    slot = ((pos * onehot).sum(-1)[..., None]
            == torch.arange(c, dtype=torch.float32,
                            device=probs.device)).float()     # [G,Sg,K,C]
    # combine[g,s,e,c] = Σ_k gate·onehot·keep·slot
    combine = torch.einsum("gske,gskc->gsec",
                           onehot * keep * gate_vals[..., None], slot)
    return gate_vals, expert_idx, combine, keep


def moe_apply(p, x, cfg, *, group_size: int = 256,
              capacity_factor: float = 1.25):
    """x: [B, S, d] → [B, S, d]."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    t = b * s
    gs = min(group_size, t)
    if t % gs:
        raise ValueError(f"{t} tokens do not split into MoE groups of {gs}")
    g = t // gs
    c = capacity(gs, k, e, capacity_factor)

    xg = x.reshape(g, gs, d)
    if active_mesh() is not None:
        xg = shard(xg, "batch", None, None)
    combine, keep = local_apply(lambda pr: route(pr, k, c)[2:],
                                router_probs(p, xg), like=(0, 0))
    for rec in _RECORDERS:
        rec.calls.append((g * gs * k, full(keep.sum())))
    dispatch = (combine > 0).to(x.dtype)

    # expert tensors: experts over "expert", groups over "batch" (the
    # reference's sites)
    gate, up, down = p["gate"], p["up"], p["down"]
    if is_dtensor(gate):
        gate, up, down = (_gather_bank(b) for b in (gate, up, down))
        expert_in = _expert_dispatch(dispatch, xg, gate)
    else:
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, gate)
               .float()).to(x.dtype)
    h = h * torch.einsum("egcd,edf->egcf", expert_in, up)
    h = shard(h, "expert", "batch", None, None)
    expert_out = torch.einsum("egcf,efd->egcd", h, down)
    if is_dtensor(expert_out):
        y = _expert_combine(combine.to(x.dtype), expert_out)
    else:
        y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out)
    y = y.reshape(b, s, d)

    if "shared" in p:
        y = y + glu_mlp(p["shared"], x)
    return y


def _gather_bank(bank):
    """The DTensor expert bank [E, ...] with its FSDP split (of d or f,
    never of the experts) gathered, as the reference's program gathers
    it: each expert's product then sums its whole contraction on one
    rank, where a split contraction would give partial sums reduced in
    the bank's dtype."""
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_shard() and p.dim != 0 else p
                 for p in bank.placements)
    return bank if want == tuple(bank.placements) else bank.redistribute(
        bank.device_mesh, want)


def _expert_block(bank):
    """(first expert, experts, mesh dims) of this rank's block of the
    DTensor expert bank ``bank`` [E, ...]."""
    from repro_torch.core.perturbations import shard_layout
    local_shape, offset = shard_layout(bank)
    dims = [i for i, pl in enumerate(bank.placements)
            if pl.is_shard(0)]
    return offset[0], local_shape[0], dims


def _expert_dispatch(dispatch, xg, bank):
    """``einsum("gsec,gsd->egcd", dispatch, xg)`` for this rank's experts
    only, placed (experts as ``bank``, groups as ``xg``): each rank
    gathers its own experts' tokens out of its groups."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    e0, n, dims = _expert_block(bank)
    mesh = bank.device_mesh
    xg, dispatch = settle(xg), settle(dispatch)
    pl = tuple(Shard(0) if i in dims else
               Shard(1) if xg.placements[i].is_shard(0) else Replicate()
               for i in range(mesh.ndim))
    want = tuple(Replicate() if i in dims else p
                 for i, p in enumerate(xg.placements))
    xg = xg.redistribute(mesh, want)
    dispatch = dispatch.redistribute(mesh, want)
    with block_work(mesh, pl):
        local = torch.einsum("gsec,gsd->egcd",
                             dispatch.to_local()[:, :, e0:e0 + n],
                             xg.to_local())
    g, _, e, c = dispatch.shape
    shape = (e, g, c, xg.shape[-1])
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def _expert_combine(combine, expert_out):
    """``einsum("gsec,egcd->gsd", combine, expert_out)`` from this rank's
    block of experts: a partial sum over the expert axis, reduced."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    expert_out = settle(expert_out)
    mesh = expert_out.device_mesh
    e0, n, dims = _expert_block(expert_out)
    want_out = tuple(Shard(0) if i in dims else
                     Shard(1) if combine.placements[i].is_shard(0)
                     else Replicate() for i in range(mesh.ndim))
    expert_out = expert_out.redistribute(mesh, want_out)
    want = tuple(Replicate() if i in dims else p
                 for i, p in enumerate(settle(combine).placements))
    combine = settle(combine).redistribute(mesh, want)
    with block_work(mesh, want_out):
        local = torch.einsum("gsec,egcd->gsd",
                             combine.to_local()[:, :, e0:e0 + n],
                             expert_out.to_local())
    pl = tuple(Partial() if i in dims else p for i, p in enumerate(want))
    shape = tuple(combine.shape[:2]) + (expert_out.shape[-1],)
    stride = tuple(torch.empty(shape, device="meta").stride())
    return settle(DTensor.from_local(local, mesh, pl, run_check=False,
                                     shape=shape, stride=stride))


def moe_apply_dense_ref(p, x, cfg):
    """O(E·T) dense reference: every expert sees every token; the
    dispatch oracle of the tests (no capacity drops)."""
    e, k = cfg.n_experts, cfg.n_experts_active
    gate_vals, expert_idx = _gates(router_probs(p, x), k)
    dense_w = torch.sum(F.one_hot(expert_idx, e).float()
                        * gate_vals[..., None], dim=-2)       # [B,S,E]
    outs = []
    for i in range(e):
        h = F.silu((x @ p["gate"][i]).float()).to(x.dtype)
        h = h * (x @ p["up"][i])
        outs.append(h @ p["down"][i])
    y = torch.einsum("bse,ebsd->bsd", dense_w.to(x.dtype), torch.stack(outs))
    if "shared" in p:
        y = y + glu_mlp(p["shared"], x)
    return y
