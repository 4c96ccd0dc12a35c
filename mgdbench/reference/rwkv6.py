"""The port's RWKV-6 variant: RWKV-6 "Finch" (arXiv:2404.05892) with the
departures below, float32, token by token.

Per layer: x += TimeMix(LN₁(x)); x += ChannelMix(LN₂(x)).  TimeMix, per
head of ``head_size`` channels: the token shift mixes each input with the
previous token's (zeros before the first), xₘ = x + (x₋₁ − x)⊙μₘ, for
r, k, v, g and w; the decay wₜ = exp(−exp(w₀ + tanh(x_w A) B)); the WKV
recurrence Sₜ = diag(wₜ)·Sₜ₋₁ + kₜᵀvₜ, yₜ = rₜ·Sₜ₋₁ + (rₜ⊙u⊙kₜ)·vₜ (u the
current token's bonus), written here as the plain per-token loop;
GroupNorm of y a head (ln_x), times SiLU(g), through W_o.  ChannelMix:
r = σ(x_r W_r), k = ReLU(x_k W_k)², out = r ⊙ (k W_v).  Then the final
norm, the head and the mean next-token cross-entropy.

Departures from the paper and the published Finch 7B, which the port's
model (and the JAX package it ports) makes and this reference therefore
makes too, each listed under ``departures`` in the configuration: the token-shift
μ are static (Finch makes them data-dependent through a LoRA, ddlerp);
there is no LayerNorm on the embedding (ln0); the final norm is an
RMSNorm without bias where the paper has a LayerNorm; the decay LoRA is
the configuration's ``decay_lora_dim`` wide.  LayerNorms and ln_x use ε = 1e-5.
"""
from __future__ import annotations

import math

import torch

from .common import cross_entropy, layernorm, mm, rmsnorm

EPS = 1e-5


def dims(conf):
    d = conf["n_embd"]
    return dict(L=conf["n_layer"], d=d, h=d // conf["head_size"],
                dh=conf["head_size"], ff=conf["dim_ffn"],
                vocab=conf["vocab_size"],
                lora=conf["decay_lora_dim"])


def program_fields(conf):
    m = dims(conf)
    return dict(n_layers=m["L"], d_model=m["d"], n_heads=m["h"],
                d_ff=m["ff"], vocab=m["vocab"], norm_eps=EPS,
                la_chunk=int(conf["assumed"]["la_chunk"]),
                tie_embeddings=False, dtype=conf["dtype"])


def leaf_specs(conf):
    m = dims(conf)
    L, d, h, dh, ff, v, r = (m[k] for k in ("L", "d", "h", "dh", "ff",
                                             "vocab", "lora"))
    dt, f = conf["dtype"], "float32"

    def normal(d_in):
        return ("normal", 1.0 / math.sqrt(d_in))

    att = [(("layers", "att", f"mu_{n}"), (L, d), dt, ("uniform",))
           for n in "rkvgw"]
    att += [(("layers", "att", n, "w"), (L, d, d), dt, normal(d))
            for n in ("wr", "wk", "wv", "wg", "wo")]
    att += [
        (("layers", "att", "w0"), (L, d), f, ("zeros",)),
        (("layers", "att", "w_lora_a"), (L, d, r), dt, ("normal", 0.01)),
        (("layers", "att", "w_lora_b"), (L, r, d), dt, ("normal", 0.01)),
        (("layers", "att", "u"), (L, h, dh), f, ("zeros",)),
        (("layers", "att", "ln_x", "scale"), (L, d), f, ("ones",)),
        (("layers", "att", "ln_x", "bias"), (L, d), f, ("zeros",)),
    ]
    ffn = [(("layers", "ffn", f"mu_{n}"), (L, d), dt, ("uniform",))
           for n in "kr"]
    ffn += [(("layers", "ffn", "wk", "w"), (L, d, ff), dt, normal(d)),
            (("layers", "ffn", "wv", "w"), (L, ff, d), dt, normal(ff)),
            (("layers", "ffn", "wr", "w"), (L, d, d), dt, normal(d))]
    norms = [(("layers", ln, p), (L, d), dt, (law,))
             for ln in ("ln1", "ln2")
             for p, law in (("scale", "ones"), ("bias", "zeros"))]
    return [
        (("embed", "tok", "table"), (v, d), dt, ("normal", 0.02)),
        (("embed", "ln_f", "scale"), (d,), dt, ("ones",)),
        (("embed", "head", "w"), (d, v), dt, normal(d)),
    ] + norms + att + ffn


def flop_dims(conf):
    m = dims(conf)
    return dict(attn_layers=0, d_attn=0, n_embed=m["vocab"] * m["d"])


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def _wkv(r, k, v, w, u):
    """The recurrence, token by token.  r, k, v, w [N, S, H, D] (w the
    decay itself), u [N, H, D] → y [N, S, H, D]."""
    n, s, h, dh = r.shape
    state = torch.zeros(n, h, dh, dh, dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        bonus = (rt * u * kt).sum(-1, keepdim=True) * vt
        ys.append(torch.einsum("nhc,nhcv->nhv", rt, state) + bonus)
        state = w[:, t][..., None] * state + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, 1)


def costs(P, conf, batch, quant):
    """[C(θ + sign·θ̃) for each sign of ``P``], float32.  The streams of
    all signs run the recurrence together, stacked on the batch dim."""
    m = dims(conf)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h, dh = m["h"], m["dh"]
    xs = list(P.rows(("embed", "tok", "table"), tokens.long()))
    for layer in range(m["L"]):
        def w(*name):
            return P.streams(("layers",) + name, layer)

        ln1s, ln1b = w("ln1", "scale"), w("ln1", "bias")
        mus = {c: w("att", f"mu_{c}") for c in "rkvgw"}
        mats = {c: w("att", f"w{c}", "w") for c in "rkvgo"}
        lora_a, lora_b, w0 = w("att", "w_lora_a"), w("att", "w_lora_b"), \
            w("att", "w0")
        u, lnxs, lnxb = w("att", "u"), w("att", "ln_x", "scale"), \
            w("att", "ln_x", "bias")
        parts = {c: [] for c in "rkvgw"}
        for i, x in enumerate(xs):
            xn = layernorm(x, ln1s[i], ln1b[i], EPS)
            xp = _shift(xn)
            mix = {c: xn + (xp - xn) * mus[c][i] for c in "rkvgw"}
            for c in "rkvg":
                parts[c].append(mm(mix[c], mats[c][i], quant))
            lora = mm(torch.tanh(mm(mix["w"], lora_a[i], quant)), lora_b[i],
                      quant)
            parts["w"].append(torch.exp(-torch.exp(w0[i] + lora)))

        def heads(c):
            return torch.cat(parts[c]).reshape(-1, s, h, dh)

        uu = torch.stack(u).repeat_interleave(b, 0)
        y = _wkv(heads("r"), heads("k"), heads("v"), heads("w"), uu)
        for i, x in enumerate(xs):
            yi = y[i * b:(i + 1) * b]
            mu_ = yi.mean(-1, keepdim=True)
            var = ((yi - mu_) ** 2).mean(-1, keepdim=True)
            yn = ((yi - mu_) * torch.rsqrt(var + EPS)).reshape(b, s, -1)
            yn = yn * lnxs[i] + lnxb[i]
            g = torch.nn.functional.silu(parts["g"][i])
            xs[i] = x + mm(yn * g, mats["o"][i], quant)
        del parts, y, mats
        ln2s, ln2b = w("ln2", "scale"), w("ln2", "bias")
        fmu = {c: w("ffn", f"mu_{c}") for c in "kr"}
        fk, fv, fr = w("ffn", "wk", "w"), w("ffn", "wv", "w"), \
            w("ffn", "wr", "w")
        for i, x in enumerate(xs):
            xn = layernorm(x, ln2s[i], ln2b[i], EPS)
            xp = _shift(xn)
            xk = xn + (xp - xn) * fmu["k"][i]
            xr = xn + (xp - xn) * fmu["r"][i]
            k = torch.relu(mm(xk, fk[i], quant)) ** 2
            xs[i] = x + torch.sigmoid(mm(xr, fr[i], quant)) \
                * mm(k, fv[i], quant)
        del fk, fv, fr
    ln_f, head = P.streams(("embed", "ln_f", "scale")), \
        P.streams(("embed", "head", "w"))
    out = []
    for i, x in enumerate(xs):
        logits = mm(rmsnorm(x, ln_f[i], EPS), head[i], quant)
        out.append(cross_entropy(logits, batch["labels"]))
        del logits
    return out
