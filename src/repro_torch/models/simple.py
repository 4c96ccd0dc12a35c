"""The paper's sigmoid MLPs (§3): 2-2-1 (XOR), n-n-1 (parity), 49-4-4
(NIST7x7), with optional per-neuron activation defects (§3.5)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.cost import mse
from repro_torch.core.noise import ActivationDefects, defective_sigmoid
from repro_torch.core.perturbations import leaf_seed
from repro_torch.core.utils import leaf_id_tree
from repro_torch.device import resolve_device
from .layers import dense, dense_init, pdense

_INIT_TAG = 0x1417


def mlp_init(seed: int, sizes: Sequence[int], *, device=None):
    """Layers for ``sizes`` (e.g. (2, 2, 1)): weights N(0,1)/sqrt(fan_in),
    biases zero.  Layer i draws from a generator keyed on (seed, i), so
    the weights are the same on every device; they do not match the JAX
    package's threefry draws (parity tests hand both packages the same
    numpy arrays through ``repro_torch.convert``)."""
    dev = resolve_device(device)
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        gen = torch.Generator().manual_seed(leaf_seed(seed, i, _INIT_TAG))
        layers.append(dense_init(gen, a, b, bias=True, device=dev))
    return layers


def _activate(h, defects, i):
    if defects is not None and defects[i] is not None:
        return defective_sigmoid(h, defects[i])
    return torch.sigmoid(h)


def mlp_apply(params, x,
              defects: Optional[Sequence[ActivationDefects]] = None):
    """Sigmoid MLP; ``defects[i]`` (optional) deforms layer i's outputs."""
    for i, p in enumerate(params):
        x = _activate(dense(p, x), defects, i)
    return x


def mlp_apply_perturbed(params, x, probe,
                        defects: Optional[Sequence[ActivationDefects]] = None):
    """``mlp_apply`` under θ ± θ̃(probe), the fused probe path: a tuple of
    per-sign outputs, one per entry of ``probe.ctx.signs``, bit-identical
    (f32, plain route) to ``mlp_apply`` on the materialized θ ± θ̃."""
    ids = leaf_id_tree(params)
    xs = tuple(x for _ in probe.ctx.signs)
    for i, (p, pid) in enumerate(zip(params, ids)):
        xs = pdense(p, xs, pid, probe)
        xs = tuple(_activate(h, defects, i) for h in xs)
    return xs


def make_mlp_probe_fn(defects: Optional[Sequence[ActivationDefects]] = None):
    """probe_fn(params, batch, probe) → [n_signs] MSE costs, for the fused
    path (``MGDConfig(fused=True)``)."""

    def probe_fn(params, batch, probe):
        outs = mlp_apply_perturbed(params, batch["x"], probe, defects)
        return torch.stack([mse(o, batch["y"]) for o in outs])

    return probe_fn
