"""The MGD steps the reference follows (paper Algorithm 1, central probes,
τ_θ = 1, one probe a step): at step n, C± = C(θ ± Δθ·sₙ),
C̃ = ½(C₊ − C₋), then θ ← θ − η·C̃·Δθ·sₙ/Δθ² in float32, stored back in
the configuration's type.  The signs sₙ are ``counts.signs`` under the
run's seed, step n and the leaf's id.

``follow`` runs the reference's own steps, or, given the C̃ a program
reported (``drive``), steps along that program's trajectory: it still
computes its own C₊, C₋ and C̃ at every step, but updates with the
program's C̃, so each later step is measured at the program's parameters
and the update is checked as arithmetic.  It returns, for each step, the
two probe costs and its own C̃, for each leaf the norm of the change
after the last step, and with ``first_change`` also that of its own
first change (with its own C̃₀).
"""
from __future__ import annotations

import math

import torch

from .common import PRECISION, SIGN_CHUNK, Perturbed, exact_f32, f32


def _update(leaf, signs, coef, eta, dtheta, store=None, own=None):
    """θ + (−η)·((Δθ·s)·coef), in passes, stored in the leaf's type (and
    through ``store``).  With ``own``, also the squared norm of the
    change that coefficient would have made instead."""
    flat, sf = leaf.reshape(-1), signs.reshape(-1)
    alpha = f32(-eta).to(leaf.device)
    step = f32(dtheta).to(leaf.device)
    total = torch.zeros((), dtype=torch.float64, device=leaf.device)

    def stored(x):
        return (x if store is None else store(x)).to(leaf.dtype)

    for a in range(0, flat.numel(), SIGN_CHUNK):
        b = min(flat.numel(), a + SIGN_CHUNK)
        old = flat[a:b].float()
        theta = step * sf[a:b].float()
        if own is not None:
            alt = stored(old + alpha * (theta * own)).float()
            total += ((alt - old) ** 2).sum(dtype=torch.float64)
        flat[a:b] = stored(old + alpha * (theta * coef))
    return total


def change_norms(params, theta0_leaf):
    """{path: ‖θ − θ₀‖} with θ₀'s leaves drawn again by
    ``theta0_leaf(path)`` as (part, first flat index), a part at a time."""
    norms = {}
    for path, leaf in params.items():
        total = torch.zeros((), dtype=torch.float64, device=leaf.device)
        for part, start in theta0_leaf(path):
            cur = leaf.reshape(-1)[start:start + part.numel()].float()
            total += ((cur - part.reshape(-1).float()) ** 2).sum(
                dtype=torch.float64)
        norms[path] = total
    return {p: math.sqrt(t.item()) for p, t in norms.items()}


def _hold(params, store) -> None:
    """Round θ₀ to the precision ``store`` holds, a first-dim slice at a
    time."""
    for leaf in params.values():
        rows = leaf.view(leaf.shape[0], -1) if leaf.dim() > 1 \
            else leaf.view(1, -1)
        for row in rows:
            row.copy_(store(row))


def follow(fam, conf, params, batch_of, theta0_leaf, *, dtheta: float,
           eta: float, seed: int, steps: int, precision: str = "float32",
           drive=None, first_change: bool = False):
    """``steps`` MGD steps from ``params`` (θ₀, a flat {path: tensor},
    updated in place) on ``batch_of(n)``, updating with ``drive[n]`` (a
    program's C̃) where given, else with its own C̃."""
    prec = PRECISION[precision]
    out = {"costs": [], "c_tilde": [], "change_1": None, "change_n": None}
    inv_d2 = f32(1.0 / (dtheta * dtheta))
    with exact_f32(), torch.no_grad():
        if prec.store is not None:
            _hold(params, prec.store)
        for n in range(steps):
            P = Perturbed(params, seed, n, dtheta, store=prec.store)
            c_plus, c_minus = fam.costs(P, conf, batch_of(n), prec.operand)
            c_tilde = f32(0.5).to(c_plus.device) * (c_plus - c_minus)
            own = c_tilde * inv_d2.to(c_tilde.device)
            coef = own if drive is None else \
                f32(drive[n]).to(own.device) * inv_d2.to(own.device)
            sq = {path: _update(leaf, P.sign_leaf(path), coef, eta, dtheta,
                                prec.store,
                                own if n == 0 and first_change else None)
                  for path, leaf in params.items()}
            P.release()
            del P
            out["costs"].append([c_plus.item(), c_minus.item()])
            out["c_tilde"].append(c_tilde.item())
            if n == 0 and first_change:
                out["change_1"] = {p: math.sqrt(t.item())
                                   for p, t in sq.items()}
        out["change_n"] = change_norms(params, theta0_leaf)
    return out
