"""Recurrent mixers: the RG-LRU block (recurrentgemma) and the mLSTM and
sLSTM blocks (xLSTM).

The port's copy of the reference's ``models/recurrent.py``.  Cache
conventions:

  * rec:   ``{"h": (B, d_rnn) float32, "conv": (B, w-1, d_rnn)}``;
  * mlstm: ``{"C": (B, H, dk, dv), "n": (B, H, dk), "m": (B, H)}`` float32
    and ``"conv": (B, w-1, d_in)``;
  * slstm: ``{"c", "n", "h", "m": (B, d)}`` float32.

The caches' logical axes (``*_cache_axes``, the reference's) are read by
the dry run (``launch.dryrun``) through ``transformer.cache_axes``.

Where the kernel runs: the RG-LRU's full-sequence recurrence (no cache,
and prefill) calls ``kernels.ops.rglru_scan(log_a, b, h0)`` — the
hand-written kernel on the card, its plain version on the CPU — with the
cache's state as ``h0``.  Decode stays the plain one-step update, as in
the reference.

The xLSTM blocks launch no kernel: the reference has no Pallas kernel for
them.  The mLSTM runs the reference's chunkwise-parallel form (chunks of
``min(256, S)`` positions, intra-chunk ``L x L`` matrices and the carried
``(dk, dv)`` state, all in float32), one chunk after another; with
gradients on, each chunk runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference's ``jax.checkpoint`` recomputes it.  The
sLSTM is sequential (its gates read ``h_{t-1}``): a Python loop over time
steps, as the reference's ``lax.scan``, so on the card its prefill costs
about twenty small launches a step and a layer.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..nn.params import ParamSpec
from .config import ModelConfig

__all__ = [
    "rglru_spec",
    "apply_rglru_block",
    "init_rglru_cache",
    "mlstm_spec",
    "apply_mlstm_block",
    "init_mlstm_cache",
    "slstm_spec",
    "apply_slstm_block",
    "init_slstm_cache",
    "rglru_cache_axes",
    "mlstm_cache_axes",
    "slstm_cache_axes",
]

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


def rglru_cache_axes(cfg: ModelConfig) -> Dict:
    return {"h": ("batch", "rnn"), "conv": ("batch", "conv", "rnn")}


def mlstm_cache_axes(cfg: ModelConfig) -> Dict:
    return {
        "C": ("batch", "heads", "head_dim", "head_dim"),
        "n": ("batch", "heads", "head_dim"),
        "m": ("batch", "heads"),
        "conv": ("batch", "conv", "mlp"),
    }


def slstm_cache_axes(cfg: ModelConfig) -> Dict:
    return {"c": ("batch", "rnn"), "n": ("batch", "rnn"), "h": ("batch", "rnn"), "m": ("batch", "rnn")}


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


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def mlstm_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di = 2 * d  # up-projection factor 2 (xLSTM mLSTM block)
    H = cfg.num_heads
    hd = di // H
    w = cfg.conv_width
    return {
        "w_up": ParamSpec((d, di), ("embed", "mlp")),
        "w_gate": ParamSpec((d, di), ("embed", "mlp")),
        "conv_w": ParamSpec((w, di), ("conv", "mlp"), init="normal", scale=0.1),
        "wq": ParamSpec((di, H, hd), ("mlp", "heads", "head_dim")),
        "wk": ParamSpec((di, H, hd), ("mlp", "heads", "head_dim")),
        "wv": ParamSpec((di, H, hd), ("mlp", "heads", "head_dim")),
        "wif": ParamSpec((di, 2 * H), ("mlp", "heads")),  # i/f gate projections
        "bif": ParamSpec((2 * H,), ("heads",), init="zeros"),
        "out_norm": {"scale": ParamSpec((di,), ("mlp",), init="ones")},
        "w_down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _mlstm_state(batch: int, H: int, hd: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, H, hd), dtype=torch.float32, device=device),
        torch.full((batch, H), -1e30, dtype=torch.float32, device=device),
    )


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    di = 2 * cfg.d_model
    H = cfg.num_heads
    C, n, m = _mlstm_state(batch, H, di // H, device)
    return {"C": C, "n": n, "m": m,
            "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype, device=device)}


def _mlstm_chunk(C, n, m, q, k, v, li, lf, scale: float):
    """One chunk of the chunkwise-parallel mLSTM (all float32).

    State: ``C (B,H,dk,dv)``, ``n (B,H,dk)``, ``m (B,H)``; inputs ``q``,
    ``k``, ``v (B,L,H,hd)`` and the log input / forget gates ``li``, ``lf
    (B,H,L)``.  Returns ``(C, n, m, h (B,L,H,hd))``."""
    L = q.shape[1]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B,H,L,hd)

    b = torch.cumsum(lf, dim=-1)  # (B,H,L) inclusive log-decay
    # intra-chunk log weights: W[i,j] = b_i - b_j + li_j  (j <= i)
    W = b[..., :, None] - b[..., None, :] + li[..., None, :]
    tril = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    W = torch.where(tril, W, -math.inf)
    a_inter = b + m[..., None]  # log coefficient of the carried state per row
    m_row = torch.maximum(W.amax(dim=-1), a_inter)  # (B,H,L)
    D = torch.exp(W - m_row[..., None])
    c_int = torch.exp(a_inter - m_row)  # (B,H,L)

    qs = q * scale
    S = (q @ k.transpose(-1, -2)) * scale * D  # (B,H,L,L)
    h_num = S @ v + c_int[..., None] * (qs @ C)
    n_vec = S.sum(-1) + c_int * torch.einsum("bhld,bhd->bhl", qs, n)
    denom = torch.maximum(n_vec.abs(), torch.exp(-m_row))
    h = h_num / denom[..., None]  # (B,H,L,hd_v)

    # advance the state to the end of the chunk
    bL = b[..., -1:]  # (B,H,1)
    w_end = bL - b + li  # (B,H,L) weight of each position into the new state
    m_new = torch.maximum(bL[..., 0] + m, w_end.amax(dim=-1))
    scale_old = torch.exp(bL[..., 0] + m - m_new)
    wexp = torch.exp(w_end - m_new[..., None])
    C_new = scale_old[..., None, None] * C + torch.einsum("bhl,bhld,bhle->bhde", wexp, k, v)
    n_new = scale_old[..., None] * n + torch.einsum("bhl,bhld->bhd", wexp, k)
    return C_new, n_new, m_new, h.transpose(1, 2)  # h: (B,L,H,hd)


def _rms(h: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """The blocks' per-feature RMS norm in float32, cast to ``dtype``."""
    hf = h.to(torch.float32)
    hn = hf * torch.rsqrt(hf.square().mean(dim=-1, keepdim=True) + 1e-6)
    return (hn * scale.to(torch.float32)).to(dtype)


def apply_mlstm_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    cache: Optional[Dict] = None,
    decode: bool = False,
    chunk: int = 256,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The reference's mLSTM block.  Full sequence and prefill run chunks of
    ``L = min(chunk, S)`` positions (``ValueError`` when ``L`` does not
    divide ``S``, as in the reference); decode is one chunk of length 1."""
    dtype = x.dtype
    B, Sq, d = x.shape
    di = 2 * d
    H = cfg.num_heads
    hd = di // H
    scale = 1.0 / math.sqrt(hd)

    up = x @ params["w_up"].to(dtype)
    gate = x @ params["w_gate"].to(dtype)
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(up, params["conv_w"], conv_state)  # no bias, unlike the RG-LRU's
    u = F.silu(u)

    def heads(inp, w):  # einsum("bsd,dhk->bshk") as one matrix product
        return (inp @ w.to(dtype).reshape(di, H * hd)).reshape(B, Sq, H, hd).to(torch.float32)

    q, k = heads(u, params["wq"]), heads(u, params["wk"])
    v = heads(up, params["wv"])  # v from the up-projection, before the conv
    gif = (u @ params["wif"].to(dtype)).to(torch.float32) + params["bif"].to(torch.float32)
    li = gif[..., :H].transpose(1, 2)  # (B,H,S) log input gate (pre-exp)
    lf = F.logsigmoid(gif[..., H:]).transpose(1, 2)  # log forget

    if decode:
        if cache is None or Sq != 1:
            raise ValueError("mLSTM decode takes one position and a cache")
        C, n, m, h = _mlstm_chunk(cache["C"], cache["n"], cache["m"], q, k, v, li, lf, scale)
        state = (C, n, m)
    else:
        state = (cache["C"], cache["n"], cache["m"]) if cache is not None else _mlstm_state(B, H, hd, x.device)
        L = min(chunk, Sq)
        if Sq % L != 0:
            raise ValueError(f"seq {Sq} not divisible by mlstm chunk {L}")
        remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, li, lf))
        hs = []
        for c in range(Sq // L):
            sl = slice(c * L, (c + 1) * L)
            args = (*state, q[:, sl], k[:, sl], v[:, sl], li[..., sl], lf[..., sl], scale)
            *state, h_c = checkpoint(_mlstm_chunk, *args, use_reentrant=False) if remat else _mlstm_chunk(*args)
            hs.append(h_c)
        h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    new_cache = None
    if cache is not None:
        new_cache = {"C": state[0], "n": state[1], "m": state[2], "conv": new_conv}

    h = h.reshape(B, Sq, di).to(dtype)
    h = _rms(h, params["out_norm"]["scale"], dtype)  # per-feature RMS norm, then the gated output
    y = (h * F.silu(gate)) @ params["w_down"].to(dtype)
    return y, new_cache


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def slstm_spec(cfg: ModelConfig) -> Dict:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    ff = int(math.ceil(4.0 / 3.0 * d / 64) * 64)  # post-FFN, proj factor 4/3
    return {
        "wx": ParamSpec((d, 4 * d), ("embed", "mlp")),  # z,i,f,o x-projections
        "r": ParamSpec((H, hd, 4 * hd), ("heads", "head_dim", "mlp")),  # block-diag recurrent
        "b": ParamSpec((4 * d,), ("mlp",), init="zeros"),
        "out_norm": {"scale": ParamSpec((d,), ("embed",), init="ones")},
        "ffn": {
            "wi_gate": ParamSpec((d, ff), ("embed", "mlp")),
            "wi_up": ParamSpec((d, ff), ("embed", "mlp")),
            "wo": ParamSpec((ff, d), ("mlp", "embed")),
        },
    }


def _slstm_state(batch: int, d: int, device) -> Tuple[torch.Tensor, ...]:
    z = lambda: torch.zeros((batch, d), dtype=torch.float32, device=device)  # noqa: E731
    return z(), z(), z(), torch.full((batch, d), -1e30, dtype=torch.float32, device=device)


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    c, n, h, m = _slstm_state(batch, cfg.d_model, device)
    return {"c": c, "n": n, "h": h, "m": m}


def _slstm_step(r: torch.Tensor, bias: torch.Tensor, carry, xt: torch.Tensor):
    """One sLSTM time step (float32).  ``r``: the block-diagonal recurrent
    weight ``(H, hd, 4 hd)``; ``xt``: ``(B, 4d)`` pre-projected gates.  The
    recurrent term ``(B, H, 4 hd)`` is flattened to ``(B, 4d)`` and split
    into z, i, f and o along the last axis, as the reference splits it (the
    split does not follow the heads)."""
    c, n, h, m = carry
    B, d = c.shape
    H = r.shape[0]
    rec = torch.bmm(h.reshape(B, H, -1).transpose(0, 1), r).transpose(0, 1).reshape(B, 4 * d)
    g = xt + rec + bias
    z, gi, gf, go = g.chunk(4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(go)
    lf = F.logsigmoid(gf)
    m_new = torch.maximum(lf + m, gi)
    i_p = torch.exp(gi - m_new)
    f_p = torch.exp(lf + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    # torch.maximum, not clamp_min: at a tie (n = 1 at the first step) it
    # splits the gradient between its two sides, as the reference's does
    h_new = o * c_new / torch.maximum(n_new.abs(), n_new.new_ones(()))
    return c_new, n_new, h_new, m_new


def apply_slstm_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    cache: Optional[Dict] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The reference's sLSTM block: the recurrence one time step after
    another (decode: one step), then the RMS norm and the gated post-FFN."""
    dtype = x.dtype
    B, S, d = x.shape
    xg = (x @ params["wx"].to(dtype)).to(torch.float32)  # (B,S,4d)
    if cache is not None:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        carry = _slstm_state(B, d, x.device)
    if decode and S != 1:
        raise ValueError("sLSTM decode takes one position")
    r, bias = params["r"].to(torch.float32), params["b"].to(torch.float32)
    hs = []
    for t in range(S):
        carry = _slstm_step(r, bias, carry, xg[:, t])
        hs.append(carry[2])
    hs = torch.stack(hs, dim=1)  # (B,S,d)

    new_cache = None
    if cache is not None:
        new_cache = {"c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]}

    h = _rms(hs, params["out_norm"]["scale"], dtype)
    # post gated FFN (proj factor 4/3)
    f = params["ffn"]
    g = h @ f["wi_gate"].to(dtype)
    up = h @ f["wi_up"].to(dtype)
    y = (F.gelu(g, approximate="tanh") * up) @ f["wo"].to(dtype)
    return y, new_cache
