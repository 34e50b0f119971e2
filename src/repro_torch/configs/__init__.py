"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

The registry names every architecture the reference assigns (``ARCH_IDS``)
and its input-shape set (``SHAPES``).  A config comes to the port with the
slice that runs it: so far only ``recurrentgemma-2b``.  Asking for any
other architecture raises ``NotImplementedError`` (ROADMAP queue 1,
item 10: what remains of the LLM stack).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Tuple

from ..models.config import ModelConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
]

ARCH_IDS = [
    "granite-20b",
    "gemma2-2b",
    "stablelm-12b",
    "gemma2-27b",
    "deepseek-v2-236b",
    "granite-moe-1b-a400m",
    "pixtral-12b",
    "recurrentgemma-2b",
    "seamless-m4t-medium",
    "xlstm-350m",
]

PORTED = ("recurrentgemma-2b",)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name}: not ported yet (ROADMAP queue 1, item 10: what remains of the LLM stack); ported: {list(PORTED)}"
        )
    return importlib.import_module(f".{name.replace('-', '_')}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
