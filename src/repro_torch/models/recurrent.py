"""The RG-LRU recurrent block (recurrentgemma).

The port's copy of the RG-LRU part of the reference's
``models/recurrent.py``.  Cache convention: ``{"h": (B, d_rnn) float32,
"conv": (B, w-1, d_rnn)}``.

Where the kernel runs: the full-sequence recurrence (no cache, and
prefill) calls ``kernels.ops.rglru_scan(log_a, b, h0)`` — the hand-written
kernel on the card, its plain version on the CPU — with the cache's state
as ``h0``.  Decode stays the plain one-step update, as in the reference.

The mLSTM and sLSTM blocks (xLSTM) come later (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..nn.params import ParamSpec
from .config import ModelConfig

__all__ = ["rglru_spec", "apply_rglru_block", "init_rglru_cache"]

_RGLRU_C = 8.0


def _causal_conv(
    x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D), w: (W, D) depthwise filter, state: (B, W-1, D) history."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, D)
    out = xp[:, 0 : x.shape[1]] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + xp[:, i : i + x.shape[1]] * w[i].to(x.dtype)
    new_state = xp[:, -(W - 1) :].clone() if W > 1 else None  # not a view of xp
    return out, new_state


def rglru_spec(cfg: ModelConfig) -> Dict:
    d, dr, w = cfg.d_model, cfg.d_rnn, cfg.conv_width
    return {
        "wx_gate": ParamSpec((d, dr), ("embed", "rnn")),  # gelu branch
        "wx_rnn": ParamSpec((d, dr), ("embed", "rnn")),  # conv+rglru branch
        "conv_w": ParamSpec((w, dr), ("conv", "rnn"), init="normal", scale=0.1),
        "conv_b": ParamSpec((dr,), ("rnn",), init="zeros"),
        "wa": ParamSpec((dr, dr), ("rnn", "rnn")),  # recurrence gate r_t
        "ba": ParamSpec((dr,), ("rnn",), init="zeros"),
        "wi": ParamSpec((dr, dr), ("rnn", "rnn")),  # input gate i_t
        "bi": ParamSpec((dr,), ("rnn",), init="zeros"),
        "lam": ParamSpec((dr,), ("rnn",), init="normal", scale=0.5),  # Λ
        "wo": ParamSpec((dr, d), ("rnn", "embed")),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    return {
        "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn), dtype=dtype, device=device),
    }


def apply_rglru_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    cache: Optional[Dict] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    dtype = x.dtype
    gate = F.gelu(x @ params["wx_gate"].to(dtype), approximate="tanh")
    u = x @ params["wx_rnn"].to(dtype)
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, params["conv_w"], conv_state)
    u = u + params["conv_b"].to(dtype)

    # RG-LRU gates (fp32 recurrence for stability).
    uf = u.to(torch.float32)
    r = torch.sigmoid(uf @ params["wa"].to(torch.float32) + params["ba"].to(torch.float32))
    i = torch.sigmoid(uf @ params["wi"].to(torch.float32) + params["bi"].to(torch.float32))
    log_a = -_RGLRU_C * F.softplus(params["lam"].to(torch.float32)) * r
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i * uf)

    h0 = cache["h"] if cache is not None else None
    if decode:
        assert cache is not None and x.shape[1] == 1
        h_new = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]
        h = h_new[:, None]
        new_cache = {"h": h_new, "conv": new_conv}
    else:
        h = ops.rglru_scan(log_a, b, h0, bs=None, bd=None)
        new_cache = None
        if cache is not None:
            new_cache = {"h": h[:, -1].clone(), "conv": new_conv}  # not a view of h
    y = (h.to(dtype) * gate) @ params["wo"].to(dtype)
    return y, new_cache
