"""A dense decoder LM in plain PyTorch: the weights the benchmark makes, and
the plain reference of a prefill's last-position logits.

The architecture is the one the port serves under the configuration's
name: pre-norm RMSNorm blocks (eps 1e-6), grouped-query causal attention
with rotary embedding on the first ``partial_rotary_factor`` of each head
(rotate-half, inverse frequencies ``theta^(-j / half)``), a SiLU-gated MLP,
a final RMSNorm and an untied head.  Its departures from the published
model are listed in the configuration file.

The forward runs in float32 with TF32 off.  ``precision="fp8"`` is the
control: every matrix product's operands rounded to float8 e4m3 (one scale
per tensor) first.  Imports torch only.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6


def sizes(cfg: Dict) -> Dict[str, int]:
    d, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return {
        "layers": int(cfg["num_hidden_layers"]), "d": d, "heads": heads, "kv_heads": int(cfg["num_key_value_heads"]),
        "head_dim": d // heads, "d_ff": int(cfg["intermediate_size"]), "vocab": int(cfg["vocab_size"]),
    }


def make_weights(cfg: Dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Random float32 weights under the port's names, drawn on ``device``
    with one call a kind of matrix for all layers: normal with standard
    deviation one over the square root of the input width (1 for the
    embedding), norm scales 1."""
    s = sizes(cfg)
    L, d, H, Kv, hd, ff, V = (s[k] for k in ("layers", "d", "heads", "kv_heads", "head_dim", "d_ff", "vocab"))

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32).mul_(fan_in ** -0.5)

    stacks = {
        "attn.wq": normal((L, d, H, hd), d), "attn.wk": normal((L, d, Kv, hd), d),
        "attn.wv": normal((L, d, Kv, hd), d), "attn.wo": normal((L, H, hd, d), H * hd),
        "mlp.wi_gate": normal((L, d, ff), d), "mlp.wi_up": normal((L, d, ff), d), "mlp.wo": normal((L, ff, d), ff),
    }
    w = {"embed.embedding": normal((V, d), 1), "head": normal((d, V), d),
         "final_norm.scale": torch.ones(d, device=device)}
    ones = torch.ones((L, d), device=device)
    for i in range(L):
        w[f"layers.{i}.norm1.scale"] = ones[i]
        w[f"layers.{i}.norm2.scale"] = ones[i]
        for name, t in stacks.items():
            w[f"layers.{i}.{name}"] = t[i]
    return w


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(torch.float8_e4m3fn).max
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + NORM_EPS) * scale


def _rope(x: torch.Tensor, fraction: float, theta: float) -> torch.Tensor:
    """Rotary embedding on the first ``fraction`` of the last axis of
    ``x (B, S, heads, head_dim)``, positions 0..S-1."""
    hd, S = x.shape[-1], x.shape[1]
    rot = int(hd * fraction)
    rot -= rot % 2
    half = rot // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], dim=-1)


def forward(w: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor, *, precision: str = "fp32") -> torch.Tensor:
    """Logits ``(B, V)`` at the last position of each prompt of ``tokens
    (B, S)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q8 = _fp8 if precision == "fp8" else (lambda t: t)

    def mm(x, weight):
        return q8(x) @ q8(weight)

    s = sizes(cfg)
    H, Kv, hd = s["heads"], s["kv_heads"], s["head_dim"]
    frac, theta = float(cfg["partial_rotary_factor"]), float(cfg["rope_theta"])
    B, S = tokens.shape
    mask = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()
    with torch.inference_mode():
        x = w["embed.embedding"][tokens]
        for i in range(s["layers"]):
            p = f"layers.{i}."
            h = _rms_norm(x, w[p + "norm1.scale"])
            q = mm(h, w[p + "attn.wq"].reshape(s["d"], H * hd)).reshape(B, S, H, hd)
            k = mm(h, w[p + "attn.wk"].reshape(s["d"], Kv * hd)).reshape(B, S, Kv, hd)
            v = mm(h, w[p + "attn.wv"].reshape(s["d"], Kv * hd)).reshape(B, S, Kv, hd)
            q, k = _rope(q, frac, theta), _rope(k, frac, theta)
            k = k.repeat_interleave(H // Kv, dim=2)
            v = v.repeat_interleave(H // Kv, dim=2)
            scores = torch.einsum("bqhd,bkhd->bhqk", q8(q), q8(k)) / math.sqrt(hd)
            probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", q8(probs), q8(v)).reshape(B, S, H * hd)
            x = x + mm(o, w[p + "attn.wo"].reshape(H * hd, s["d"]))
            h = _rms_norm(x, w[p + "norm2.scale"])
            x = x + mm(F.silu(mm(h, w[p + "mlp.wi_gate"])) * mm(h, w[p + "mlp.wi_up"]), w[p + "mlp.wo"])
        x = _rms_norm(x[:, -1], w["final_norm.scale"])
        return mm(x, w["head"])
