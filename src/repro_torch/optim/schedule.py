"""LR schedules."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, *, floor: float = 0.1):
    """Linear warmup -> cosine decay to ``floor * peak_lr``.  The schedule
    takes a step (an int or a tensor) and returns a 0-d float32 tensor on
    the host, computed in float32 as the reference computes it."""

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        warm = peak_lr * (step + 1.0) / f32(max(warmup_steps, 1))
        t = torch.clamp((step - warmup_steps) / f32(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = peak_lr * (floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(f32(math.pi) * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
