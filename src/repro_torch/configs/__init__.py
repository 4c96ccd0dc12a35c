"""Architecture registry: the JAX package's ten arch ids + input shapes.

``get_config(name)`` / ``get_smoke_config(name)`` resolve an ``--arch``
id.  The port carries the dense GQA decoder ``qwen3-14b``; the other nine
ids stay listed and raise until their families are ported (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

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
PORTED = ("qwen3-14b",)


def _module(name: str):
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet (ROADMAP A14, "
            f"the other model families); ported: {list(PORTED)}")
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
