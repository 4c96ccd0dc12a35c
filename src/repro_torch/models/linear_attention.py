"""Chunked linear attention with decaying state: the shared recurrence
behind RWKV-6 (per-channel data-dependent decay) and Mamba-2 SSD (per-head
scalar decay).

PyTorch counterpart of ``repro.models.linear_attention``.  Recurrence (per
head; state S ∈ R^{dk×dv}):

    S_t = diag(w_t)·S_{t−1} + k_tᵀ v_t
    y_t = q_t·S_{t−1} + (q_t ⊙ u ⊙ k_t)·v_t          (u-bonus: RWKV only)

Chunked evaluation processes blocks of L tokens with matmuls:
  * cross-chunk:  y⁺_t = (q_t ⊙ exp(A_{t−1})) @ S_in,   A = cumsum(log w)
  * state update: S_out = diag(exp(A_L))·S_in + Σ_s (exp(A_L−A_s) ⊙ k_s)ᵀ v_s
  * intra-chunk:  scores[t,s] = Σ_c q_tc·k_sc·exp(A_{t−1,c} − A_{s,c}),  s<t

Every exp() argument is ≤ 0: the pairwise differences are masked to the
causal region *before* exponentiation, so strong decay cannot overflow
(the q·exp(A) / k·exp(−A) factorization would).  The reference's
``lax.scan`` over chunks is a Python loop carrying the f32 state, so the
[B, H, L, L, dk] pairwise tensor exists for one chunk at a time.

Everything inside runs in f32 with cuBLAS's TF32 off, whatever the
caller's setting: the state sums many decayed products, and the decode
path's step recurrence must land where the chunked form does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import full_f32_matmul


def _pad_t(x, pad: int):
    """Right-pad the time axis (axis 1) with zeros."""
    return F.pad(x, [0, 0] * (x.dim() - 2) + [0, pad])


def _chunk(x, start: int, stop: int):
    """[B, S, H, *] → the f32 block [B, H, L, *] of steps start..stop."""
    return x[:, start:stop].transpose(1, 2).float()


def _init_state(s0, b, h, dk, dv, device):
    if s0 is None:
        return torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device)
    return s0.float()


def chunked_vector_decay(q, k, v, log_w, u=None, s0=None, chunk: int = 32):
    """q, k, log_w: [B, S, H, dk] (log-decay per channel, ≤ 0); v: [B, S,
    H, dv]; u: [H, dk] bonus (RWKV's time_faaaa) or None; s0: [B, H, dk,
    dv].  Returns (y [B, S, H, dv] in q's dtype, final state f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        # right-pad to a chunk multiple: log_w = 0 (decay 1) and k = 0 keep
        # the carried state exact through the padding; pad outputs dropped
        pad = chunk - s % chunk
        y, s_fin = chunked_vector_decay(
            _pad_t(q, pad), _pad_t(k, pad), _pad_t(v, pad),
            _pad_t(log_w, pad), u, s0=s0, chunk=chunk)
        return y[:, :s], s_fin
    dev = q.device
    state = _init_state(s0, b, h, dk, dv, dev)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev), diagonal=-1)   # strict lower
    eye = torch.eye(chunk, dtype=torch.float32, device=dev)
    ys = []
    with full_f32_matmul():
        for start in range(0, s, chunk):
            qb, kb, vb, wb = (_chunk(t, start, start + chunk)
                              for t in (q, k, v, log_w))   # [B, H, L, *]
            a = torch.cumsum(wb, dim=2)                     # A_t, inclusive
            a_prev = a - wb                                 # A_{t−1}
            y_cross = torch.einsum("bhlc,bhcv->bhlv", qb * torch.exp(a_prev),
                                   state)
            # intra-chunk: pairwise decay differences, masked before exp
            diff = a_prev[:, :, :, None, :] - a[:, :, None, :, :]
            diff = torch.where(tri[:, :, None], diff, -torch.inf)
            scores = torch.einsum("bhtsc,bhsc->bhts",
                                  qb[:, :, :, None, :] * torch.exp(diff), kb)
            del diff
            if u is not None:
                diag = torch.einsum("bhlc,hc,bhlc->bhl", qb, u.float(), kb)
                scores = scores + diag[..., None] * eye
            y_intra = torch.einsum("bhts,bhsv->bhtv", scores, vb)
            # state update (every exp argument ≤ 0)
            a_last = a[:, :, -1:, :]                        # [B, H, 1, dk]
            k_hat = kb * torch.exp(a_last - a)
            state = (torch.exp(a_last[:, :, 0, :, None]) * state
                     + torch.einsum("bhlc,bhlv->bhcv", k_hat, vb))
            ys.append(y_cross + y_intra)
    y = torch.cat(ys, dim=2).transpose(1, 2)                 # [B, S, H, dv]
    return y.to(q.dtype), state


def chunked_scalar_decay(q, k, v, log_a, s0=None, chunk: int = 64):
    """Scalar-decay variant (Mamba-2 SSD: q = C, k = B, v = Δ·x): log_a
    [B, S, H] per head (≤ 0).  Decay matrices are [L, L] per head and
    scores a plain matmul.  Returns (y [B, S, H, dv], final state f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        y, s_fin = chunked_scalar_decay(
            _pad_t(q, pad), _pad_t(k, pad), _pad_t(v, pad),
            _pad_t(log_a, pad), s0=s0, chunk=chunk)
        return y[:, :s], s_fin
    dev = q.device
    state = _init_state(s0, b, h, dk, dv, dev)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))      # include diagonal (SSD)
    ys = []
    with full_f32_matmul():
        for start in range(0, s, chunk):
            # SSD semantics: y_t reads the *new* state h_t = a_t·h_{t−1} +
            # k_t v_t, so every decay exponent uses the INCLUSIVE cumsum:
            # cross exp(A_t)·h_in; intra (s ≤ t) exp(A_t − A_s), 1 at s = t
            qb, kb, vb = (_chunk(t, start, start + chunk) for t in (q, k, v))
            ab = log_a[:, start:start + chunk].transpose(1, 2).float()
            a = torch.cumsum(ab, dim=2)                     # [B, H, L]
            y_cross = torch.einsum("bhlc,bhcv->bhlv",
                                   qb * torch.exp(a)[..., None], state)
            diff = a[:, :, :, None] - a[:, :, None, :]      # [B, H, t, s]
            diff = torch.where(tri, diff, -torch.inf)
            scores = torch.einsum("bhtc,bhsc->bhts", qb, kb) * torch.exp(diff)
            y_intra = torch.einsum("bhts,bhsv->bhtv", scores, vb)
            a_last = a[:, :, -1]                            # [B, H]
            k_hat = kb * torch.exp(a_last[:, :, None] - a)[..., None]
            state = (torch.exp(a_last)[:, :, None, None] * state
                     + torch.einsum("bhlc,bhlv->bhcv", k_hat, vb))
            ys.append(y_cross + y_intra)
    y = torch.cat(ys, dim=2).transpose(1, 2)
    return y.to(q.dtype), state


# --- single-token recurrent steps (decode) ---------------------------------


def step_vector_decay(q1, k1, v1, log_w1, u, state):
    """One token.  q1, k1, log_w1: [B, H, dk]; v1: [B, H, dv]; state [B,
    H, dk, dv].  RWKV-6 order: y reads S_{t−1} plus the u-bonus of the
    current token, then the state updates."""
    q1, k1, v1 = q1.float(), k1.float(), v1.float()
    with full_f32_matmul():
        y = torch.einsum("bhc,bhcv->bhv", q1, state)
        if u is not None:
            bonus = torch.einsum("bhc,hc,bhc->bh", q1, u.float(), k1)
            y = y + bonus[..., None] * v1
    state = (torch.exp(log_w1.float())[..., None] * state
             + k1[..., None] * v1[..., None, :])
    return y, state


def step_scalar_decay(q1, k1, v1, log_a1, state):
    """One token, Mamba-2 SSD order: the state updates first (the decay
    applies to the previous state), then y reads the NEW state.  log_a1:
    [B, H]."""
    q1, k1, v1 = q1.float(), k1.float(), v1.float()
    state = (torch.exp(log_a1.float())[..., None, None] * state
             + k1[..., None] * v1[..., None, :])
    with full_f32_matmul():
        y = torch.einsum("bhc,bhcv->bhv", q1, state)
    return y, state
