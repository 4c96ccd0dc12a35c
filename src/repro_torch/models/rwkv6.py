"""RWKV-6 "Finch" block (arXiv:2404.05892): an attention-free linear RNN
with data-dependent per-channel decay.

PyTorch counterpart of ``repro.models.rwkv6``, with its cast points:
token-shift lerp mixing with static μ, the w-LoRA decay w_t =
exp(−exp(w0 + tanh(x_w A) B)) (the LoRA in the leaf dtype, the rest in
f32), the u (time_faaaa) bonus, per-head GroupNorm (ln_x), SiLU(g) output
gating, squared-ReLU channel mix (f32).

State per layer: (att_x [B, d], ffn_x [B, d], wkv [B, H, dk, dv]), O(1) in
sequence length.  The token-shift states hold the block's *normed*
inputs, as the reference's do.

On a DeviceMesh the recurrence's inputs and ``wkv`` are placed (batch,
heads over "model") — the reference's (None, "batch", "model") state
layout — and the chunked recurrence and the decode step run on each
(batch, head) shard (``sharding.local_apply``), no communication.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import local_apply, shard
from .layers import (dense, dense_init, gen_device, groupnorm_heads,
                     layernorm, layernorm_init)
from .linear_attention import chunked_vector_decay, step_vector_decay

W_LORA_DIM = 64


def rwkv6_block_init(gen: torch.Generator, cfg, dtype, device=None):
    """One block's params, drawn from ``gen``: the reference's leaves,
    shapes and dtypes (``w0``, ``u`` and ``ln_x`` in f32)."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h

    def draw(shape, fn, scale=1.0):
        x = fn(shape, generator=gen, dtype=torch.float32, device=gen_device(gen))
        return (x * scale).to(dtype).to(device)

    def mu():
        return draw((d,), torch.rand)

    att = {
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_g": mu(), "mu_w": mu(),
        "wr": dense_init(gen, d, d, dtype=dtype, device=device),
        "wk": dense_init(gen, d, d, dtype=dtype, device=device),
        "wv": dense_init(gen, d, d, dtype=dtype, device=device),
        "wg": dense_init(gen, d, d, dtype=dtype, device=device),
        "wo": dense_init(gen, d, d, dtype=dtype, device=device),
        "w0": torch.zeros((d,), dtype=torch.float32, device=device),
        "w_lora_a": draw((d, W_LORA_DIM), torch.randn, 0.01),
        "w_lora_b": draw((W_LORA_DIM, d), torch.randn, 0.01),
        "u": torch.zeros((h, dh), dtype=torch.float32, device=device),
        "ln_x": layernorm_init(d, torch.float32, device),
    }
    ffn = {
        "mu_k": mu(), "mu_r": mu(),
        "wk": dense_init(gen, d, cfg.d_ff, dtype=dtype, device=device),
        "wv": dense_init(gen, cfg.d_ff, d, dtype=dtype, device=device),
        "wr": dense_init(gen, d, d, dtype=dtype, device=device),
    }
    return {"ln1": layernorm_init(d, dtype, device),
            "ln2": layernorm_init(d, dtype, device), "att": att, "ffn": ffn}


def rwkv6_state_init(cfg, batch: int, dtype=torch.float32, device=None):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "att_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "ffn_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                           device=device),
    }


def _shift(x, x_prev):
    """Token shift: out[t] = x[t−1]; position 0 sees x_prev."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _log_decay(att, xw):
    """log w = −exp(w0 + tanh(xw·A)·B) ∈ (−inf, 0)."""
    lora = torch.tanh(xw @ att["w_lora_a"]) @ att["w_lora_b"]
    return -torch.exp(att["w0"].float() + lora.float())


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _gate(att, y, g, n_heads: int):
    """ln_x per head, then y·SiLU(g) in y's dtype."""
    y = groupnorm_heads(att["ln_x"], y, n_heads)
    return y * F.silu(g.float()).to(y.dtype)


def _ffn_out(ffn, xk, xr, dtype):
    k = torch.square(torch.relu(dense(ffn["wk"], xk).float()))
    r = torch.sigmoid(dense(ffn["wr"], xr).float())
    return (r * dense(ffn["wv"], k.to(dtype)).float()).to(dtype)


def rwkv6_time_mix(att, x, state, cfg, *, chunk: int = 32):
    """x: [B, S, d] (normed) → (y, (x_prev', wkv')); state = (x_prev [B,
    d], wkv)."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    x_prev, wkv = state
    xs = _shift(x, x_prev.to(x.dtype))
    r = dense(att["wr"], _mix(x, xs, att["mu_r"])).reshape(b, s, h, dh)
    k = dense(att["wk"], _mix(x, xs, att["mu_k"])).reshape(b, s, h, dh)
    v = dense(att["wv"], _mix(x, xs, att["mu_v"])).reshape(b, s, h, dh)
    g = dense(att["wg"], _mix(x, xs, att["mu_g"]))
    log_w = _log_decay(att, _mix(x, xs, att["mu_w"])).reshape(b, s, h, dh)
    r, k, v, log_w = (shard(t, "batch", None, "model", None)
                      for t in (r, k, v, log_w))
    y, wkv = local_apply(
        lambda r, k, v, lw, u, s0: chunked_vector_decay(
            r, k, v, lw, u, s0=s0, chunk=chunk),
        r, k, v, log_w, shard(att["u"], "model", None),
        shard(wkv, "batch", "model", None, None), like=(0, 5))
    y = _gate(att, y.reshape(b, s, d), g, h)
    return dense(att["wo"], y), (x[:, -1, :], wkv)


def rwkv6_channel_mix(ffn, x, x_prev):
    """x: [B, S, d] (normed) → (y, x_prev')."""
    xs = _shift(x, x_prev.to(x.dtype))
    return (_ffn_out(ffn, _mix(x, xs, ffn["mu_k"]), _mix(x, xs, ffn["mu_r"]),
                     x.dtype), x[:, -1, :])


def rwkv6_block(p, x, state, cfg, *, chunk: int = 32):
    """Full block: x [B, S, d] → (x', new state dict).  Under a mesh the
    normed inputs lie whole along S and d on each batch shard, as the
    token shift and the recurrence read them."""
    att_y, (att_x, wkv) = rwkv6_time_mix(
        p["att"], shard(layernorm(p["ln1"], x), "batch", None, None),
        (state["att_x"], state["wkv"]), cfg, chunk=chunk)
    x = x + att_y
    ffn_y, ffn_x = rwkv6_channel_mix(
        p["ffn"], shard(layernorm(p["ln2"], x), "batch", None, None),
        state["ffn_x"])
    return x + ffn_y, {"att_x": att_x, "ffn_x": ffn_x, "wkv": wkv}


def rwkv6_block_step(p, x1, state, cfg):
    """Single-token decode: x1 [B, d] → (y [B, d], new state)."""
    b, d = x1.shape
    h = cfg.n_heads
    dh = d // h
    att, ffn = p["att"], p["ffn"]

    xn = layernorm(p["ln1"], x1)
    xs = state["att_x"].to(xn.dtype)
    r = dense(att["wr"], _mix(xn, xs, att["mu_r"])).reshape(b, h, dh)
    k = dense(att["wk"], _mix(xn, xs, att["mu_k"])).reshape(b, h, dh)
    v = dense(att["wv"], _mix(xn, xs, att["mu_v"])).reshape(b, h, dh)
    g = dense(att["wg"], _mix(xn, xs, att["mu_g"]))
    log_w = _log_decay(att, _mix(xn, xs, att["mu_w"])).reshape(b, h, dh)
    r, k, v, log_w = (shard(t, "batch", "model", None)
                      for t in (r, k, v, log_w))
    y, wkv = local_apply(step_vector_decay, r, k, v, log_w,
                         shard(att["u"], "model", None),
                         shard(state["wkv"], "batch", "model", None, None),
                         like=(0, 5))
    y = _gate(att, y.reshape(b, d).to(x1.dtype), g, h)
    x1 = x1 + dense(att["wo"], y)

    xn2 = layernorm(p["ln2"], x1)
    xs2 = state["ffn_x"].to(xn2.dtype)
    x1 = x1 + _ffn_out(ffn, _mix(xn2, xs2, ffn["mu_k"]),
                       _mix(xn2, xs2, ffn["mu_r"]), x1.dtype)
    return x1, {"att_x": xn, "ffn_x": xn2, "wkv": wkv}
