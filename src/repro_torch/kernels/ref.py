"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each is the function its kernel computes, written with ordinary tensor ops
in the reference's order (``src/repro/kernels/ref.py``).  The CPU tests hold
it against the reference package, ``chip_smoke.py`` holds the kernel
against it on the card, and a kernel wrapper runs it for tensors that lie
on the CPU.  It is never what a CUDA tensor gets from a wrapper.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["matmul_update_ref", "flash_attention_ref", "rglru_scan_ref"]

NEG_INF = -2.0e38


def matmul_update_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C + A @ B`` with fp32 accumulation, cast back to ``C``'s dtype (a
    new tensor; ``c`` is not modified)."""
    acc = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return (c.to(torch.float32) + acc).to(c.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Kv, Sk, D)
    v: torch.Tensor,  # (B, Kv, Sk, D)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with GQA (query head ``h`` reads KV head
    ``h // (H / Kv)``), queries right-aligned to the keys (row ``i`` at
    position ``i + Sk - Sq``), optional tanh softcap, causal and
    sliding-window masks (masked logits -2e38).  Logits are taken in the
    inputs' dtype, then fp32; the weights are cast to ``v``'s dtype."""
    B, H, Sq, D = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    G = H // Kv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kr = k.repeat_interleave(G, dim=1)
    vr = v.repeat_interleave(G, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kr).to(torch.float32) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, vr)


def rglru_scan_ref(
    log_a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``h_t = exp(log_a_t) * h_{t-1} + b_t`` over axis 1, step by step;
    ``(B, S, D)`` fp32, ``h0 (B, D)`` (zeros when None)."""
    B, S, D = log_a.shape
    h = torch.zeros((B, D), dtype=torch.float32, device=log_a.device) if h0 is None else h0
    out = torch.empty_like(b)
    for t in range(S):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out[:, t] = h
    return out
