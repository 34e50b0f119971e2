"""Attention: GQA/MQA self-attention, global and sliding-window.

The port's copy of the reference's ``models/attention.py`` for the kinds
``attn`` and ``local``.  Cache convention (per attention layer):
``{"k": (B, S_buf, Kv, hd), "v": (B, S_buf, Kv, hd), "pos": (S_buf,)
absolute positions, -1 = empty}``, with ``S_buf = min(seq_budget, window)``
for local layers (a ring buffer) and the full budget otherwise.  Decode
writes at ``position % S_buf``; masks come from the stored positions, so
ring wraparound needs no special case.

Where the kernels run: full-sequence attention (no cache, and prefill)
calls ``kernels.ops.flash_attention`` — the hand-written kernel on the card,
its plain version on the CPU — for both of the reference's branches (its
``_sdpa`` below ``attn_chunk_threshold`` and ``_sdpa_chunked`` above, which
compute the same function).  The ring-buffer writes and decode (one query
over the buffer, masked by the stored positions) stay plain torch, as in
the reference, where no Pallas kernel covers them.

Unlike the reference's functional updates, prefill and decode write the
given cache's tensors in place and return them (no copy of the cache per
step).  Cross-attention, MLA and the reference's chunked path as a code
path of its own come later (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..nn.params import ParamSpec
from .config import ModelConfig
from .layers import rope, softcap

__all__ = ["attn_spec", "apply_attn", "init_attn_cache"]

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Specs and caches
# ---------------------------------------------------------------------------


def attn_spec(cfg: ModelConfig) -> Dict:
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, Kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, Kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }


def _buf_len(cfg: ModelConfig, kind: str, seq_budget: int) -> int:
    if kind == "local" and cfg.window > 0:
        return min(seq_budget, cfg.window)
    return seq_budget


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, seq_budget: int, dtype, device) -> Dict:
    S = _buf_len(cfg, kind, seq_budget)
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, S, Kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, Kv, hd), dtype=dtype, device=device),
        "pos": torch.full((S,), -1, dtype=torch.int64, device=device),
    }


# ---------------------------------------------------------------------------
# Core attention math (plain torch, the decode path)
# ---------------------------------------------------------------------------


def _sdpa(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Kv, hd)
    v: torch.Tensor,  # (B, Sk, Kv, hd)
    mask: Optional[torch.Tensor],  # (Sq, Sk) or (B, Sq, Sk) bool
    *,
    scale: float,
    cap: float,
) -> torch.Tensor:
    """GQA by repeating KV to H heads, as the reference does."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32) * scale
    logits = softcap(logits, cap)
    if mask is not None:
        m = mask if mask.dim() == 2 else mask[:, None]
        logits = torch.where(m, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def _causal_mask(Sq: int, Sk: int, window: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """(Sq, Sk) mask: key j visible to query i iff j <= i (+offset) and within
    the sliding window when ``window > 0``."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.reshape(h * k, d)


# ---------------------------------------------------------------------------
# GQA apply
# ---------------------------------------------------------------------------


def apply_attn(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,) absolute positions of x
    *,
    kind: str,  # attn | local
    causal: bool = True,
    cache: Optional[Dict] = None,
    decode: bool = False,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (output, updated_cache).

    Modes:
      * train:   cache=None, decode=False — full-sequence attention;
      * prefill: cache given (empty), decode=False — fills the cache;
      * decode:  cache given, decode=True, S == 1.
    """
    if cross_kv is not None:
        raise NotImplementedError("cross-attention is not ported yet (ROADMAP queue 1, item 8)")
    dtype = x.dtype
    B, S, _ = x.shape
    window = cfg.window if kind == "local" else 0
    scale = cfg.query_scale if cfg.query_scale > 0 else 1.0 / math.sqrt(cfg.head_dim)

    q = _project(x, params["wq"].to(dtype))
    k = _project(x, params["wk"].to(dtype))
    v = _project(x, params["wv"].to(dtype))
    q = rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    k = rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)

    def full_attn(q, k, v):
        # (B,S,H,hd) <-> (B,H,S,hd): transposed views, no copies; the
        # kernel reads the strides and any length (no block rule).
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window if causal else 0, softcap=cfg.attn_softcap,
            scale=scale, bq=None, bk=None,
        )
        return out.transpose(1, 2)

    if cache is None:
        return _out(full_attn(q, k, v), params["wo"].to(dtype)), None

    S_buf = cache["k"].shape[1]
    if not decode:
        # Prefill: attend over the in-flight sequence, then store the last
        # S_buf positions into the (ring) buffer.
        out = full_attn(q, k, v)
        keep = min(S, S_buf)
        if S == S_buf:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
            cache["pos"].copy_(positions)
        else:
            slot = positions[-keep:] % S_buf
            cache["k"].index_copy_(1, slot, k[:, -keep:])
            cache["v"].index_copy_(1, slot, v[:, -keep:])
            cache["pos"].index_copy_(0, slot, positions[-keep:].to(cache["pos"].dtype))
        return _out(out, params["wo"].to(dtype)), cache

    # Decode: S == 1, write at position % S_buf, attend over the buffer.
    pos = positions[0]
    slot = (pos % S_buf).reshape(1)
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    cache["pos"].index_copy_(0, slot, positions.to(cache["pos"].dtype))
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos)
    if window > 0:
        valid &= cpos > pos - window
    out = _sdpa(q, cache["k"], cache["v"], valid[None, :], scale=scale, cap=cfg.attn_softcap)
    return _out(out, params["wo"].to(dtype)), cache
