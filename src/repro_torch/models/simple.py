"""The paper's own experiment networks (§3).

* ``mlp`` — sigmoid feedforward nets: 2-2-1 (XOR), n-n-1 (parity),
  49-4-4 (NIST7x7), with optional per-neuron activation defects (§3.5).
* ``cnn`` — the Fashion-MNIST 2-conv and CIFAR-10 3-conv nets of Table 2
  (3×3 convs + 2×2 max-pools + linear head, no softmax; MSE on one-hot
  targets), 20,490 and 26,154 parameters, the reference's wiring.  They
  probe by materializing θ̃ (no fused path, as in the reference).

Init functions draw from the port's own generators keyed on (seed,
layer): the same weights on every device, not the reference's threefry
draws (parity tests hand both packages the same numpy arrays through
``repro_torch.convert``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.cost import mse
from repro_torch.core.noise import ActivationDefects, defective_sigmoid
from repro_torch.core.perturbations import leaf_seed
from repro_torch.core.utils import leaf_id_tree
from repro_torch.device import resolve_device
from .layers import conv2d, conv2d_init, dense, dense_init, maxpool2, pdense

_INIT_TAG = 0x1417


def _init_gen(seed: int, layer: int) -> torch.Generator:
    return torch.Generator().manual_seed(leaf_seed(seed, layer, _INIT_TAG))


def mlp_init(seed: int, sizes: Sequence[int], *, device=None):
    """Layers for ``sizes`` (e.g. (2, 2, 1)): weights N(0,1)/sqrt(fan_in),
    biases zero; layer i draws from a generator keyed on (seed, i)."""
    dev = resolve_device(device)
    return [dense_init(_init_gen(seed, i), a, b, bias=True, device=dev)
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))]


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


def linear_apply(params, x):
    """Affine chain with no activation, over ``mlp_init``'s layer tree
    (the reference's twin of its ``LinearLaneChip`` forward).  With dyadic
    parameters and {0,1} inputs every product and partial sum is exact in
    f32, so the result is bitwise the reference's whatever the order of
    the dot products' sums."""
    h = x.float()
    for p in params:
        h = h @ p["w"]
        if "b" in p:
            h = h + p["b"]
    return h


def make_mlp_probe_fn(defects: Optional[Sequence[ActivationDefects]] = None):
    """probe_fn(params, batch, probe) → [n_signs] MSE costs, for the fused
    path (``MGDConfig(fused=True)``)."""

    def probe_fn(params, batch, probe):
        outs = mlp_apply_perturbed(params, batch["x"], probe, defects)
        return torch.stack([mse(o, batch["y"]) for o in outs])

    return probe_fn


# --- the paper's CNNs -------------------------------------------------------


def cnn_init(seed: int, *, in_hw, in_ch, channels, n_classes, head_pool,
             device=None):
    """``channels`` e.g. (16, 32) Fashion / (16, 32, 64) CIFAR: 3×3 convs
    (HWIO), each followed by a 2×2 pool, extra pools down to
    ``head_pool``, and a dense head on the NHWC-flattened features."""
    dev = resolve_device(device)
    convs = []
    c, hw = in_ch, in_hw
    for i, co in enumerate(channels):
        convs.append(conv2d_init(_init_gen(seed, i), 3, 3, c, co,
                                 device=dev))
        c = co
        hw //= 2
    while hw > head_pool:   # extra pools to reach the paper's head width
        hw //= 2
    return {"convs": convs,
            "fc": dense_init(_init_gen(seed, len(channels)), hw * hw * c,
                             n_classes, bias=True, device=dev)}


def cnn_apply(params, x, *, head_pool):
    """x: [B,H,W,C] → class scores [B,n_classes] (no softmax, per paper)."""
    for p in params["convs"]:
        x = maxpool2(torch.relu(conv2d(p, x)))
    while x.shape[1] > head_pool:
        x = maxpool2(x)
    return dense(params["fc"], x.reshape(x.shape[0], -1))


def fashion_cnn_init(seed: int, *, device=None):
    return cnn_init(seed, in_hw=28, in_ch=1, channels=(16, 32),
                    n_classes=10, head_pool=7, device=device)


def fashion_cnn_apply(params, x):
    return cnn_apply(params, x, head_pool=7)


def cifar_cnn_init(seed: int, *, device=None):
    return cnn_init(seed, in_hw=32, in_ch=3, channels=(16, 32, 64),
                    n_classes=10, head_pool=2, device=device)


def cifar_cnn_apply(params, x):
    return cnn_apply(params, x, head_pool=2)
