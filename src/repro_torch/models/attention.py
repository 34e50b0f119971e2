"""Attention: GQA/MQA (global, sliding-window and cross) and MLA
(deepseek-v2).

The port's copy of the reference's ``models/attention.py``.  Cache
convention (per self-attention layer):

  * GQA: ``{"k": (B, S_buf, Kv, hd), "v": (B, S_buf, Kv, hd), "pos":
    (S_buf,) absolute positions, -1 = empty}``;
  * MLA: ``{"ckv": (B, S_buf, kv_lora), "kr": (B, S_buf, rope_hd), "pos":
    (S_buf,)}``,

with ``S_buf = min(seq_budget, window)`` for local layers (a ring buffer)
and the full budget otherwise.  Decode writes at ``position % S_buf``;
masks come from the stored positions, so ring wraparound needs no special
case.  As in the reference, a global layer's buffer wraps the same way
once the prompt and the new tokens run past the budget: the oldest
positions are overwritten and no longer seen.

Cross-attention (the encoder-decoder's decoder) reads ``cross_kv = (k,
v)``, each ``(B, S_enc, Kv, hd)``, projected once from the encoder's
output (``models.encdec``); its query takes no rope, and it attends over
every encoder position (no causal mask, no window).

Where the kernels run: full-sequence attention (no cache, and prefill)
calls ``kernels.ops.flash_attention`` — the hand-written kernel on the card,
its plain version on the CPU — for both of the reference's branches (its
``_sdpa`` below ``attn_chunk_threshold`` and ``_sdpa_chunked`` above, which
compute the same function), MLA's prefill and cross-attention outside
decode among them.  The ring-buffer writes and decode (one query over the
buffer, masked by the stored positions; MLA's absorbed decode; one query
over the cross K/V) stay plain torch, as in the reference, where no Pallas
kernel covers them.

Unlike the reference's functional updates, prefill and decode write the
given cache's tensors in place and return them (no copy of the cache per
step).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..nn.params import ParamSpec
from .config import ModelConfig
from .layers import rope, softcap

__all__ = [
    "attn_spec", "mla_spec", "apply_attn", "apply_mla", "init_attn_cache", "init_mla_cache", "attn_cache_axes",
    "mla_cache_axes",
]

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Specs and caches
# ---------------------------------------------------------------------------


def attn_spec(cfg: ModelConfig, *, cross: bool = False) -> Dict:
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, Kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, Kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }


def mla_spec(cfg: ModelConfig) -> Dict:
    d, H = cfg.d_model, cfg.num_heads
    nope, rhd, vhd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wdq": ParamSpec((d, qr), ("embed", "lora")),
        "q_norm": {"scale": ParamSpec((qr,), ("lora",), init="ones")},
        "wuq": ParamSpec((qr, H, nope + rhd), ("lora", "heads", "head_dim")),
        "wdkv": ParamSpec((d, kvr), ("embed", "lora")),
        "kv_norm": {"scale": ParamSpec((kvr,), ("lora",), init="ones")},
        "wuk": ParamSpec((kvr, H, nope), ("lora", "heads", "head_dim")),
        "wuv": ParamSpec((kvr, H, vhd), ("lora", "heads", "head_dim")),
        "wkr": ParamSpec((d, rhd), ("embed", "head_dim")),
        "wo": ParamSpec((H, vhd, d), ("heads", "head_dim", "embed")),
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
        "pos": torch.full((S,), -1, dtype=torch.int32, device=device),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, seq_budget: int, dtype, device) -> Dict:
    return {
        "ckv": torch.zeros((batch, seq_budget, cfg.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((batch, seq_budget, cfg.rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((seq_budget,), -1, dtype=torch.int32, device=device),
    }


def attn_cache_axes(cfg: ModelConfig, kind: str) -> Dict:
    """Logical sharding axes of a GQA cache (the reference's): global
    caches shard the sequence over the model axis (``seq_kv``), sliding
    window caches are batch-sharded only."""
    seq_ax = "seq_kv" if kind != "local" else "seq"
    return {
        "k": ("batch", seq_ax, "kv_heads", "head_dim"),
        "v": ("batch", seq_ax, "kv_heads", "head_dim"),
        "pos": ("seq",),
    }


def mla_cache_axes(cfg: ModelConfig) -> Dict:
    """MLA caches are shared across heads: the sequence is sharded."""
    return {
        "ckv": ("batch", "seq_kv", "lora"),
        "kr": ("batch", "seq_kv", "head_dim"),
        "pos": ("seq",),
    }


def _store(cache: Dict, entries: Dict[str, torch.Tensor], positions: torch.Tensor) -> None:
    """Prefill's write: the last ``S_buf`` positions of ``entries`` (each
    ``(B, S, ...)``) into the cache's (ring) buffers, in place."""
    S, S_buf = positions.shape[0], cache["pos"].shape[0]
    if S == S_buf:
        for name, t in entries.items():
            cache[name].copy_(t)
        cache["pos"].copy_(positions)
        return
    keep = min(S, S_buf)
    slot = positions[-keep:] % S_buf
    for name, t in entries.items():
        cache[name].index_copy_(1, slot, t[:, -keep:])
    cache["pos"].index_copy_(0, slot, positions[-keep:].to(cache["pos"].dtype))


def _store_one(cache: Dict, entries: Dict[str, torch.Tensor], positions: torch.Tensor) -> torch.Tensor:
    """Decode's write of one position at ``position % S_buf``, in place;
    returns the position (a 0-d tensor)."""
    pos = positions[0]
    slot = (pos % cache["pos"].shape[0]).reshape(1)
    for name, t in entries.items():
        cache[name].index_copy_(1, slot, t)
    cache["pos"].index_copy_(0, slot, positions.to(cache["pos"].dtype))
    return pos


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
      * decode:  cache given, decode=True, S == 1;
      * cross-attention: ``cross_kv=(k, v)`` precomputed from the encoder's
        output; the cache is returned untouched.
    """
    dtype = x.dtype
    B, S, _ = x.shape
    window = cfg.window if kind == "local" else 0
    scale = cfg.query_scale if cfg.query_scale > 0 else 1.0 / math.sqrt(cfg.head_dim)

    q = _project(x, params["wq"].to(dtype))
    if cross_kv is not None:
        k, v = cross_kv
        if decode:  # one query over the cached cross K/V, plain torch
            out = _sdpa(q, k, v, None, scale=scale, cap=cfg.attn_softcap)
        else:
            out = ops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=False, window=0, softcap=cfg.attn_softcap, scale=scale, bq=None, bk=None,
            ).transpose(1, 2)
        return _out(out, params["wo"].to(dtype)), cache

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

    if not decode:
        # Prefill: attend over the in-flight sequence, then store the last
        # S_buf positions into the (ring) buffer.
        out = full_attn(q, k, v)
        _store(cache, {"k": k, "v": v}, positions)
        return _out(out, params["wo"].to(dtype)), cache

    # Decode: S == 1, write at position % S_buf, attend over the buffer.
    pos = _store_one(cache, {"k": k, "v": v}, positions)
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos)
    if window > 0:
        valid &= cpos > pos - window
    out = _sdpa(q, cache["k"], cache["v"], valid[None, :], scale=scale, cap=cfg.attn_softcap)
    return _out(out, params["wo"].to(dtype)), cache


# ---------------------------------------------------------------------------
# MLA apply (deepseek-v2)
# ---------------------------------------------------------------------------


def _mla_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def apply_mla(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,)
    *,
    cache: Optional[Dict] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head Latent Attention; returns (output, updated_cache).

    Full sequence and prefill: the latent KV is decompressed per head and
    the decoupled-RoPE scores are folded into one attention over
    ``nope + rope`` features, run by ``ops.flash_attention`` (scale
    ``1/sqrt(nope + rope)``, causal, no softcap).  The kernel takes one
    head_dim for ``k`` and ``v``, so ``v`` is padded with zeros from
    ``v_head_dim`` to ``nope + rope`` and the output's first ``v_head_dim``
    features are kept: zero columns add exactly nothing to the product.
    Decode (S == 1) is the reference's absorbed form, plain torch: the
    scores run in the compressed space and per-head K/V are never built.
    """
    dtype = x.dtype
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rhd, vhd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(nope + rhd)

    cq = _mla_norm(params["q_norm"]["scale"], x @ params["wdq"].to(dtype))
    q = _project(cq, params["wuq"].to(dtype))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, theta=cfg.rope_theta)

    ckv = _mla_norm(params["kv_norm"]["scale"], x @ params["wdkv"].to(dtype))
    kr = rope((x @ params["wkr"].to(dtype))[:, :, None, :], positions, theta=cfg.rope_theta)[:, :, 0]

    if not decode:
        k_nope = _project(ckv, params["wuk"].to(dtype))
        v = _project(ckv, params["wuv"].to(dtype))
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_eff = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, rhd)], dim=-1)
        v_pad = torch.nn.functional.pad(v, (0, nope + rhd - vhd))
        out = ops.flash_attention(
            q_eff.transpose(1, 2), k_eff.transpose(1, 2), v_pad.transpose(1, 2),
            causal=True, window=0, softcap=0.0, scale=scale, bq=None, bk=None,
        )
        out = out.transpose(1, 2)[..., :vhd]
        y = _out(out, params["wo"].to(dtype))
        if cache is not None:
            _store(cache, {"ckv": ckv, "kr": kr}, positions)
        return y, cache

    # Absorbed decode (S == 1).
    if cache is None:
        raise ValueError("MLA decode needs a cache")
    pos = _store_one(cache, {"ckv": ckv, "kr": kr}, positions)
    cckv, ckr, cpos = cache["ckv"], cache["kr"], cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos)

    # q_nope absorbed through W_uk: (B,1,H,nope) x (kv_lora,H,nope) -> (B,1,H,kv_lora)
    q_abs = torch.einsum("bqhk,chk->bqhc", q_nope, params["wuk"].to(dtype))
    logits = (
        torch.einsum("bqhc,bsc->bhqs", q_abs, cckv) + torch.einsum("bqhk,bsk->bhqs", q_rope, ckr)
    ).to(torch.float32) * scale
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(dtype)
    ctx = torch.einsum("bhqs,bsc->bqhc", w, cckv)  # compressed context
    out = torch.einsum("bqhc,chk->bqhk", ctx, params["wuv"].to(dtype))
    return _out(out, params["wo"].to(dtype)), cache
