"""Qwen3 dense decoder (hf:Qwen/Qwen3-14B), float32, from its published
equations (the ``Qwen3ForCausalLM`` modelling of ``transformers``).

Per layer, pre-norm: h = x + W_o·attn(RMSNorm₁(x)); x' = h + W_down·(SiLU(
W_gate·n) ⊙ W_up·n), n = RMSNorm₂(h).  Attention is grouped-query
(``num_key_value_heads`` groups), each head's q and k RMS-normed over
``head_dim`` (qk-norm) before the rotary embedding (rotate-half form,
inverse frequencies θ^(−2i/d)), causal softmax scaled by head_dim^−½.
Then the final RMSNorm, the untied head and the mean next-token
cross-entropy.  No departure from the published model; the weights are
random (``leaf_specs``), laid out as the port keeps them: matrices
[d_in, d_out], layers stacked on a leading dim.
"""
from __future__ import annotations

import math

import torch

from .common import cross_entropy, mm, rmsnorm


def dims(conf):
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return dict(L=conf["num_hidden_layers"], d=d, h=h,
                kvh=conf["num_key_value_heads"],
                dh=conf.get("head_dim") or d // h,
                ff=conf["intermediate_size"], vocab=conf["vocab_size"],
                eps=conf["rms_norm_eps"], theta=conf["rope_theta"])


def program_fields(conf):
    """The port's ``ArchConfig`` fields this configuration sets."""
    m = dims(conf)
    return dict(n_layers=m["L"], d_model=m["d"], n_heads=m["h"],
                n_kv_heads=m["kvh"], d_head=m["dh"], d_ff=m["ff"],
                vocab=m["vocab"], qk_norm=True, qkv_bias=False,
                rope_theta=float(m["theta"]), norm_eps=float(m["eps"]),
                tie_embeddings=bool(conf["tie_word_embeddings"]),
                dtype=conf["dtype"])


def leaf_specs(conf):
    """(path, shape, dtype, law) of every weight; law ("normal", std),
    ("ones",), ("zeros",) or ("uniform",)."""
    m = dims(conf)
    L, d, h, kvh, dh, ff, v = (m[k] for k in ("L", "d", "h", "kvh", "dh",
                                                "ff", "vocab"))
    dt = conf["dtype"]

    def normal(d_in):
        return ("normal", 1.0 / math.sqrt(d_in))

    return [
        (("embed", "tok", "table"), (v, d), dt, ("normal", 0.02)),
        (("embed", "ln_f", "scale"), (d,), dt, ("ones",)),
        (("embed", "head", "w"), (d, v), dt, normal(d)),
        (("layers", "ln1", "scale"), (L, d), dt, ("ones",)),
        (("layers", "ln2", "scale"), (L, d), dt, ("ones",)),
        (("layers", "attn", "wq", "w"), (L, d, h * dh), dt, normal(d)),
        (("layers", "attn", "wk", "w"), (L, d, kvh * dh), dt, normal(d)),
        (("layers", "attn", "wv", "w"), (L, d, kvh * dh), dt, normal(d)),
        (("layers", "attn", "wo", "w"), (L, h * dh, d), dt, normal(h * dh)),
        (("layers", "attn", "q_norm", "scale"), (L, dh), dt, ("ones",)),
        (("layers", "attn", "k_norm", "scale"), (L, dh), dt, ("ones",)),
        (("layers", "mlp", "gate", "w"), (L, d, ff), dt, normal(d)),
        (("layers", "mlp", "up", "w"), (L, d, ff), dt, normal(d)),
        (("layers", "mlp", "down", "w"), (L, ff, d), dt, normal(ff)),
    ]


def flop_dims(conf):
    """Attention layers and width for ``counts.flops.model_flops``."""
    m = dims(conf)
    return dict(attn_layers=m["L"], d_attn=m["h"] * m["dh"],
                n_embed=m["vocab"] * m["d"])


def _rope(x, theta):
    """x [B, S, H, D]; positions 0 .. S − 1."""
    s, dim = x.shape[1], x.shape[-1]
    half = dim // 2
    inv = torch.tensor([theta ** (-i / half) for i in range(half)],
                       dtype=torch.float64).float().to(x.device)
    ang = torch.arange(s, device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(q, k, v):
    """Causal GQA: q [B, S, H, D], k and v [B, S, KVH, D]."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    y = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(scores, -1), v)
    return y.reshape(b, s, h * dh)


def costs(P, conf, batch, quant):
    """[C(θ + sign·θ̃) for each sign of ``P``], float32."""
    m = dims(conf)
    eps, tokens = m["eps"], batch["tokens"]
    b, s = tokens.shape
    xs = list(P.rows(("embed", "tok", "table"), tokens.long()))
    for layer in range(m["L"]):
        def w(*name):
            return P.streams(("layers",) + name, layer)

        ln1, ln2 = w("ln1", "scale"), w("ln2", "scale")
        wq, wk, wv, wo = (w("attn", n, "w") for n in ("wq", "wk", "wv", "wo"))
        qn, kn = w("attn", "q_norm", "scale"), w("attn", "k_norm", "scale")
        for i, x in enumerate(xs):
            n = rmsnorm(x, ln1[i], eps)
            q = rmsnorm(mm(n, wq[i], quant).reshape(b, s, m["h"], m["dh"]),
                        qn[i], eps)
            k = rmsnorm(mm(n, wk[i], quant).reshape(b, s, m["kvh"], m["dh"]),
                        kn[i], eps)
            v = mm(n, wv[i], quant).reshape(b, s, m["kvh"], m["dh"])
            y = _attention(_rope(q, m["theta"]), _rope(k, m["theta"]), v)
            xs[i] = x + mm(y, wo[i], quant)
        del wq, wk, wv, wo
        gate, up, down = (w("mlp", n, "w") for n in ("gate", "up", "down"))
        for i, x in enumerate(xs):
            n = rmsnorm(x, ln2[i], eps)
            hdn = torch.nn.functional.silu(mm(n, gate[i], quant)) \
                * mm(n, up[i], quant)
            xs[i] = x + mm(hdn, down[i], quant)
        del gate, up, down
    ln_f, head = P.streams(("embed", "ln_f", "scale")), \
        P.streams(("embed", "head", "w"))
    out = []
    for i, x in enumerate(xs):
        logits = mm(rmsnorm(x, ln_f[i], eps), head[i], quant)
        out.append(cross_entropy(logits, batch["labels"]))
        del logits
    return out
