"""Mamba-2 block (SSD, state-space duality), the backbone of the zamba2
hybrid.

PyTorch counterpart of ``repro.models.mamba2``.  Per block: in_proj → (z,
xBC, dt); a depthwise causal conv over xBC; the SSD recurrence with
per-head scalar decay a_t = exp(−Δ_t·exp(A_log)); the skip D·x; gated
RMSNorm (y·silu(z)); out_proj.  n_groups = 1: B and C are shared across
heads.  State per layer: the conv tail [B, K−1, conv_dim] and the SSD
state [B, H, N, P], O(1) in sequence length.

The conv is K shifted multiply-adds summed in f32 in tap order, the same
helper for the full sequence and the decode step (no cuDNN, so no TF32).
Δ = softplus is ``logaddexp(x, 0)``, jax's own form.

On a DeviceMesh the SSD inputs and state are placed (batch, heads over
"model") — the reference's (None, "batch", "model") state layout — and
the chunked recurrence and the decode step run on each (batch, head)
shard (``sharding.local_apply``), no communication.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import local_apply, shard
from .layers import dense, dense_init, gen_device, rmsnorm, rmsnorm_init
from .linear_attention import chunked_scalar_decay, step_scalar_decay

CONV_K = 4


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    head_p = cfg.ssm_head_dim
    n_heads = d_inner // head_p
    n_state = cfg.ssm_state
    conv_dim = d_inner + 2 * n_state
    return d_inner, head_p, n_heads, n_state, conv_dim


def mamba2_block_init(gen: torch.Generator, cfg, dtype, device=None):
    """One block's params, drawn from ``gen``: the reference's leaves,
    shapes and dtypes (``a_log``, ``d_skip``, ``dt_bias`` in f32)."""
    d = cfg.d_model
    d_inner, head_p, n_heads, n_state, conv_dim = _dims(cfg)
    conv_w = torch.randn((CONV_K, conv_dim), generator=gen,
                         dtype=torch.float32, device=gen_device(gen)) * 0.2

    def f32(fill):
        return torch.full((n_heads,), fill, dtype=torch.float32,
                          device=device)

    return {
        "norm_in": rmsnorm_init(d, dtype, device),
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * n_state + n_heads,
                              dtype=dtype, device=device),
        "conv_w": conv_w.to(dtype).to(device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": f32(0.0),                                # A = −exp(a_log)
        "d_skip": f32(1.0),
        "dt_bias": f32(0.0),
        "norm_gate": rmsnorm_init(d_inner, dtype, device),
        "out_proj": dense_init(gen, d_inner, d, dtype=dtype, device=device),
    }


def mamba2_state_init(cfg, batch: int, dtype=torch.float32, device=None):
    d_inner, head_p, n_heads, n_state, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, n_heads, n_state, head_p),
                           dtype=torch.float32, device=device),
    }


def _conv_taps(xp, w, s: int):
    """Σ_j xp[:, j:j+s]·w[j] in f32, taps in order.  xp: [B, s+K−1, C]."""
    wf = w.float()
    y = xp[:, :s].float() * wf[0]
    for j in range(1, w.shape[0]):
        y = y + xp[:, j:j + s].float() * wf[j]
    return y


def _causal_conv(x, w, b, tail):
    """Depthwise causal conv1d.  x: [B, S, C]; w: [K, C]; tail: [B, K−1,
    C] history.  Returns (y [B, S, C], new tail)."""
    kk = w.shape[0]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = _conv_taps(xp, w.to(x.dtype), x.shape[1]).to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(kk - 1):, :]


def _split_proj(p, x, cfg):
    d_inner, head_p, n_heads, n_state, conv_dim = _dims(cfg)
    return torch.split(dense(p["in_proj"], x), [d_inner, conv_dim, n_heads],
                       dim=-1)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssd_inputs(p, xbc, dt, cfg, dtype):
    """The conv's output (SiLU'd here) and the raw dt → (x_ssm [..., H,
    P], B, C [..., N], log a = −exp(A_log)·Δ [..., H] f32, v = x·Δ [..., H,
    P]), Δ = softplus(dt + dt_bias)."""
    d_inner, head_p, n_heads, n_state, conv_dim = _dims(cfg)
    xbc = F.silu(xbc.float()).to(dtype)
    x_ssm, bvec, cvec = torch.split(xbc, [d_inner, n_state, n_state],
                                    dim=-1)
    x_ssm = x_ssm.reshape(*x_ssm.shape[:-1], n_heads, head_p)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    log_a = -torch.exp(p["a_log"].float()) * dt                  # ≤ 0
    v = (x_ssm.float() * dt[..., None]).to(dtype)
    return x_ssm, bvec, cvec, log_a, v


def _ssd_out(p, y, x_ssm, z, dtype):
    """y + D·x, then the gated RMSNorm and out_proj."""
    y = y.float() + p["d_skip"].float()[:, None] * x_ssm.float()
    y = y.reshape(*y.shape[:-2], -1).to(dtype)
    y = rmsnorm(p["norm_gate"], y * F.silu(z.float()).to(dtype))
    return dense(p["out_proj"], y)


def mamba2_block(p, x, state, cfg, *, chunk: int = 64):
    """x: [B, S, d] → (x + mixer(x), new state)."""
    b, s, _ = x.shape
    d_inner, head_p, n_heads, n_state, conv_dim = _dims(cfg)
    z, xbc, dt = _split_proj(
        p, shard(rmsnorm(p["norm_in"], x), "batch", None, None), cfg)
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                  state["conv"])
    x_ssm, bmat, cmat, log_a, v = _ssd_inputs(p, xbc, dt, cfg, x.dtype)
    shape = (b, s, n_heads, n_state)
    heads = ("batch", None, "model", None)
    y, ssd = local_apply(
        lambda q, k, v, la, s0: chunked_scalar_decay(q, k, v, la, s0=s0,
                                                     chunk=chunk),
        shard(cmat[:, :, None, :].expand(shape), *heads),
        shard(bmat[:, :, None, :].expand(shape), *heads), shard(v, *heads),
        shard(log_a, *heads[:3]),
        shard(state["ssd"], "batch", "model", None, None), like=(0, 4))
    return x + _ssd_out(p, y, x_ssm, z, x.dtype), {"conv": conv_tail,
                                                    "ssd": ssd}


def mamba2_block_step(p, x1, state, cfg):
    """Single-token decode.  x1: [B, d] → (y [B, d], new state)."""
    b, _ = x1.shape
    d_inner, head_p, n_heads, n_state, conv_dim = _dims(cfg)
    z, xbc, dt = _split_proj(p, rmsnorm(p["norm_in"], x1), cfg)
    # the conv over (tail ++ this token)
    window = torch.cat([state["conv"].to(xbc.dtype), xbc[:, None, :]], dim=1)
    y_conv = _conv_taps(window, p["conv_w"].to(xbc.dtype), 1)[:, 0]
    xbc = y_conv.to(xbc.dtype) + p["conv_b"].to(xbc.dtype)
    x_ssm, bvec, cvec, log_a, v = _ssd_inputs(p, xbc, dt, cfg, x1.dtype)
    shape = (b, n_heads, n_state)
    heads = ("batch", "model", None)
    y, ssd = local_apply(
        step_scalar_decay, shard(cvec[:, None, :].expand(shape), *heads),
        shard(bvec[:, None, :].expand(shape), *heads), shard(v, *heads),
        shard(log_a, *heads[:2]),
        shard(state["ssd"], "batch", "model", None, None), like=(0, 4))
    return (x1 + _ssd_out(p, y, x_ssm, z, x1.dtype),
            {"conv": window[:, 1:, :], "ssd": ssd})
