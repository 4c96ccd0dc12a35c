"""Architecture registry: the JAX package's ten arch ids + input shapes.

``get_config(name)`` / ``get_smoke_config(name)`` resolve an ``--arch``
id.  The port carries all ten: the attention families (the dense GQA
decoders, the VLM and audio backbones, MoE and MLA) and the recurrent
ones (``rwkv6-7b``, ``zamba2-7b``).  ``runnable_cells()`` enumerates the
reference's 40 (arch × shape) cells, marking the long_500k skips of the
full-attention architectures.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

ARCH_IDS = [
    "rwkv6-7b",
    "qwen2-vl-2b",
    "mistral-nemo-12b",
    "qwen3-14b",
    "granite-34b",
    "qwen2-72b",
    "deepseek-v3-671b",
    "llama4-scout-17b-a16e",
    "musicgen-medium",
    "zamba2-7b",
]
PORTED = tuple(ARCH_IDS)


def _module(name: str):
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# architectures with sub-quadratic sequence handling run long_500k
LONG_CONTEXT_OK = {"rwkv6-7b", "zamba2-7b"}


def runnable_cells() -> List[Tuple[str, str, bool]]:
    """All 40 cells as (arch, shape, runnable), as the reference lists
    them (runnable says what the architecture supports, not what the port
    has ported)."""
    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            runnable = shape != "long_500k" or arch in LONG_CONTEXT_OK
            cells.append((arch, shape, runnable))
    return cells
