"""Modality frontend stubs: the vision and audio configs specify the
transformer backbone only, so their inputs are precomputed embeddings.

The port's copy of the reference's ``models/frontends.py``: the same
shapes, dtype and 0.02 scale, the values drawn from a ``torch.Generator``
seeded with ``seed`` (they are not the reference's, whose values come from
JAX's PRNG; a test that needs equal inputs makes them with numpy and gives
them to both packages).
"""

from __future__ import annotations

import torch

from ..core.modelbank_torch import resolve_device
from .config import ModelConfig

__all__ = ["stub_patch_embeddings", "stub_frame_embeddings"]


def _normal(shape, seed: int, dtype, device) -> torch.Tensor:
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    return (0.02 * torch.randn(shape, generator=g, dtype=torch.float32, device=device)).to(dtype)


def stub_patch_embeddings(cfg: ModelConfig, batch: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """Vision stub: ``(B, num_prefix_embeddings, d_model)`` patch embeddings."""
    return _normal((batch, cfg.num_prefix_embeddings, cfg.d_model), seed, cfg.dtype, device)


def stub_frame_embeddings(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """Audio stub: ``(B, seq, d_model)`` speech frame embeddings."""
    return _normal((batch, seq, cfg.d_model), seed, cfg.dtype, device)
