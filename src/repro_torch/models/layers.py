"""Shared layers: norms, RoPE, MLPs, embeddings, softcaps.

The port's copy of the reference's ``models/layers.py``.  Apply functions
are pure, ``apply(params, x, ...) -> y``, where ``params`` is a
``ParamTree`` module or a dict of tensors; parameters are cast at each use
exactly as the reference casts them.  Spec builders return ``ParamSpec``
trees.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..nn.params import ParamSpec, tree_map

__all__ = [
    "stacked",
    "norm_spec",
    "apply_norm",
    "mlp_spec",
    "apply_mlp",
    "embedding_spec",
    "softcap",
    "rope",
]


def stacked(spec, n: int):
    """Prepend a ``layers`` stacking dim of size ``n`` to every leaf spec."""
    return tree_map(
        lambda l: ParamSpec((n,) + l.shape, ("layers",) + l.axes, l.dtype, l.init, l.scale), spec
    )


# -- normalization -----------------------------------------------------------


def norm_spec(d: int, kind: str = "rmsnorm") -> Dict:
    spec = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        spec["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return spec


def apply_norm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    if "bias" in params:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    else:  # rmsnorm, scale initialised to ones and multiplied directly
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return y.to(dtype)


# -- MLPs ---------------------------------------------------------------------


def mlp_spec(d: int, d_ff: int, kind: str) -> Dict:
    if kind in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamSpec((d, d_ff), ("embed", "mlp")),
            "wi_up": ParamSpec((d, d_ff), ("embed", "mlp")),
            "wo": ParamSpec((d_ff, d), ("mlp", "embed")),
        }
    if kind == "gelu":
        return {
            "wi": ParamSpec((d, d_ff), ("embed", "mlp")),
            "wo": ParamSpec((d_ff, d), ("mlp", "embed")),
        }
    raise ValueError(f"unknown mlp kind {kind}")


def apply_mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    dtype = x.dtype
    if kind in ("swiglu", "geglu"):
        g = x @ params["wi_gate"].to(dtype)
        u = x @ params["wi_up"].to(dtype)
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        return (act * u) @ params["wo"].to(dtype)
    h = F.gelu(x @ params["wi"].to(dtype), approximate="tanh")
    return h @ params["wo"].to(dtype)


# -- embeddings ---------------------------------------------------------------


def embedding_spec(vocab: int, d: int) -> Dict:
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"), init="normal", scale=1.0)}


# -- misc ---------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    theta: float = 10000.0,
    fraction: float = 1.0,
) -> torch.Tensor:
    """Rotary embedding on the last dim of ``x``: (..., seq, heads, head_dim).

    ``positions``: (..., seq) integers.  ``fraction`` < 1 rotates only the
    first ``fraction * head_dim`` features (stablelm partial rotary).
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq  # (..., seq, half)
    angles = angles[..., None, :]  # broadcast over heads: (..., seq, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    if x_pass.shape[-1]:
        return torch.cat([out, x_pass], dim=-1)
    return out
