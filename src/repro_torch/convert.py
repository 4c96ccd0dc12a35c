"""Carry parameters between the JAX package and the port.

``to_torch`` turns a nested list/tuple/dict of arrays (numpy, or anything
``numpy.asarray`` reads, such as the JAX package's params: the MLP's
layer list, the CNNs' ``{"convs": [{"b", "w"}, …], "fc": {"b", "w"}}``,
the transformer's tree) into the same structure of tensors on a device;
``to_numpy`` goes back.  Dicts come out with their keys sorted, the
order in which JAX flattens and rebuilds them.  Values and
dtypes are copied exactly, so both packages then compute on identical
parameters.  bfloat16 travels as its 16-bit pattern: numpy has no
bfloat16 of its own (the JAX package's arrays carry ``ml_dtypes``'), and
``torch.from_numpy`` refuses that dtype.

``state_to_torch`` carries an optimizer state the same way: the JAX
package's ``MGDState`` or ``AnalogMGDState`` (any NamedTuple with those
fields, arrays or ``None``) becomes the port's, with the counters
(``step``, ``t``) and the ``primed`` flag as host values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.utils import tree_map
from repro_torch.device import resolve_device


def _leaf_to_torch(a, dev):
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _leaf_to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # the JAX package's bfloat16 numpy dtype
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device=None):
    """Tensors on ``device`` (the CUDA card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(a, dev), tree)


def to_numpy(tree):
    """numpy arrays on the host; bfloat16 comes back as ``ml_dtypes``'
    bfloat16, the dtype of the JAX package's arrays."""
    return tree_map(_leaf_to_numpy, tree)


_HOST_INTS = ("step", "t")


def state_to_torch(state, device=None):
    """The port's ``MGDState``/``AnalogMGDState`` for a reference state."""
    from repro_torch.core.analog import AnalogMGDState
    from repro_torch.core.mgd import MGDState

    fields = state._asdict()
    cls = MGDState if "step" in fields else AnalogMGDState
    out = {}
    for name, value in fields.items():
        if name in _HOST_INTS:
            out[name] = int(np.asarray(value))
        elif name == "primed":
            out[name] = bool(np.asarray(value))
        else:
            out[name] = to_torch(value, device)
    return cls(**out)

