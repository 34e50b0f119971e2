"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

The registry names every architecture the reference assigns (``ARCH_IDS``)
and its input-shape set (``SHAPES``), and serves all ten: the dense decoders
(gemma2-2b, gemma2-27b, granite-20b, stablelm-12b), the MoE and MLA
decoders (granite-moe-1b-a400m, deepseek-v2-236b), the hybrid
recurrentgemma-2b, xLSTM (xlstm-350m), the vision-prefix decoder
(pixtral-12b) and the encoder-decoder (seamless-m4t-medium).  Each config
equals the reference's field for field.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..models.config import ModelConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
    "list_configs",
    "shape_applicable",
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
    return importlib.import_module(f".{name.replace('-', '_')}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_configs() -> List[str]:
    return list(ARCH_IDS)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if (arch, shape) is runnable; else the reference's skip reason:
    long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return "long_500k skipped: full/global attention is quadratic and the KV cache is unbounded"
    return None
