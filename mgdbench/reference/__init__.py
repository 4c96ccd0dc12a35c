"""Plain PyTorch references of the benchmark's configurations, in float32
with TF32 off.  One module a family (``qwen3``, ``rwkv6``), named by the
configuration file's ``reference`` key; ``common`` holds the perturbed
parameter view, the numeric helpers and the lower-precision control's
quantizer, ``mgd`` the steps the reference follows.  Nothing here imports
the program or JAX."""
from __future__ import annotations

import importlib


def family(name: str):
    """The reference module ``mgdbench.reference.<name>``."""
    if not name.isidentifier():
        raise ValueError(f"reference family {name!r} is not an identifier")
    return importlib.import_module(f"mgdbench.reference.{name}")
