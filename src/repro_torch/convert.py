"""Carry parameters between the JAX package and the port.

``to_torch`` turns a nested list/tuple/dict of arrays (numpy, or anything
``numpy.asarray`` reads, such as the JAX package's params) into the same
structure of tensors on a device; ``to_numpy`` goes back.  Values and
dtypes are copied exactly, so both packages then compute on identical
parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.utils import tree_map
from repro_torch.device import resolve_device


def to_torch(tree, device=None):
    """Tensors on ``device`` (the CUDA card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True))
                    .to(dev), tree)


def to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
