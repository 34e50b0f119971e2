"""Mixture-of-Experts: top-k router and per-sequence sort-based dispatch.

The port's copy of the reference's ``models/moe.py`` without its mesh
branch (``jax.shard_map`` over the batch and model axes), which has no
counterpart on one card.  What stays is the reference's local math:

  * routing in float32: softmax over the experts, the ``top_k`` choices
    (ties to the lower expert index, as ``jax.lax.top_k``), gates
    renormalised over the choices;
  * per-sequence capacity ``C = min(max(ceil(S*k/E * factor), 1), S*k)``
    (Switch-style, group = sequence): a stable sort of the (token, choice)
    pairs by expert gives each pair its position within its expert; pairs
    at or past ``C`` drop to the residual path (their gate is zeroed);
  * dispatch and combine one choice at a time, so every live operand is
    ``(B, S, d)``;
  * the expert products ``becd,edf->becf`` (plain matrix products, as the
    reference computes them outside any Pallas kernel);
  * the load-balancing aux loss and the shared experts (deepseek-v2).

A token's ``k`` choices name distinct experts, so every kept slot receives
exactly one token: the dispatch copies into kept slots (``index_copy_``),
and dropped pairs land in a spare row that is never read, so the result
does not depend on the order in which the card runs the copies.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..nn.params import ParamSpec
from .config import ModelConfig

__all__ = ["moe_spec", "apply_moe", "capacity", "route", "router_probs", "top_k"]


def moe_spec(cfg: ModelConfig) -> Dict:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    spec = {
        "router": ParamSpec((d, E), ("embed", "experts"), init="normal", scale=0.02),
        "wi_gate": ParamSpec((E, d, ff), ("experts", "embed", "mlp")),
        "wi_up": ParamSpec((E, d, ff), ("experts", "embed", "mlp")),
        "wo": ParamSpec((E, ff, d), ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts > 0:
        sff = ff * cfg.num_shared_experts
        spec["shared"] = {
            "wi_gate": ParamSpec((d, sff), ("embed", "mlp")),
            "wi_up": ParamSpec((d, sff), ("embed", "mlp")),
            "wo": ParamSpec((sff, d), ("mlp", "embed")),
        }
    return spec


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert for a sequence of ``S`` tokens."""
    k = cfg.top_k
    return min(max(int(math.ceil(S * k / cfg.num_experts * cfg.capacity_factor)), 1), S * k)


def router_probs(params, x: torch.Tensor) -> torch.Tensor:
    """The router's softmax over the experts, ``(B, S, E)`` in float32."""
    return torch.softmax((x @ params["router"].to(x.dtype)).to(torch.float32), dim=-1)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest probabilities of each token and their experts,
    largest first, ties to the lower expert index (``jax.lax.top_k``'s
    order: a stable descending sort); the gates renormalised over the
    choices."""
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]
    return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def route(cfg: ModelConfig, probs: torch.Tensor, C: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities ``(B, S, E)`` to ``(slot_pair, gk_pair,
    starts)``: each (token, choice) pair's slot in the ``(B, E*C)`` expert
    buffer (``E*C`` when dropped) and its kept gate, both ``(B, S, k)`` in
    token order, and each expert's first position among the sorted pairs
    ``(B, E)``."""
    B, S, E = probs.shape
    k, Sk = cfg.top_k, S * cfg.top_k
    dev = probs.device
    gate, eidx = top_k(probs, k)

    e_flat = eidx.reshape(B, Sk)
    g_flat = gate.reshape(B, Sk)
    e_sort, order = torch.sort(e_flat, dim=1, stable=True)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    starts = torch.searchsorted(e_sort, experts, side="left")  # (B, E)
    pos_in_e = torch.arange(Sk, device=dev)[None, :] - torch.gather(starts, 1, e_sort)
    keep = pos_in_e < C
    slot_sorted = torch.where(keep, e_sort * C + pos_in_e, E * C)
    # back to token order: (B, S, k) per-choice slots and kept gates
    slot_pair = torch.empty_like(e_flat).scatter_(1, order, slot_sorted).reshape(B, S, k)
    kept = torch.gather(g_flat, 1, order) * keep
    gk_pair = torch.zeros_like(g_flat).scatter_(1, order, kept).reshape(B, S, k)
    return slot_pair, gk_pair, starts


def _dispatch(x: torch.Tensor, slot_pair: torch.Tensor, EC: int) -> torch.Tensor:
    """Tokens into the ``(B, EC, d)`` expert buffer, one choice at a time.
    Row ``EC`` of each sequence takes the dropped pairs and is cut off."""
    B, S, d = x.shape
    buf = torch.zeros((B * (EC + 1), d), dtype=x.dtype, device=x.device)
    base = (torch.arange(B, device=x.device) * (EC + 1))[:, None]
    flat = x.reshape(B * S, d)
    for i in range(slot_pair.shape[-1]):
        buf.index_copy_(0, (base + slot_pair[:, :, i]).reshape(-1), flat)
    return buf.view(B, EC + 1, d)[:, :EC]


def _combine(out_flat: torch.Tensor, slot_pair: torch.Tensor, gk_pair: torch.Tensor) -> torch.Tensor:
    """Expert outputs ``(B, EC, d)`` back to token positions, weighted by
    the kept gates, one choice at a time (a dropped pair reads a clamped
    slot with gate 0)."""
    B, EC, d = out_flat.shape
    S = slot_pair.shape[1]
    brow = torch.arange(B, device=out_flat.device)[:, None]
    y = torch.zeros((B, S, d), dtype=out_flat.dtype, device=out_flat.device)
    for i in range(slot_pair.shape[-1]):
        sl = slot_pair[:, :, i].clamp_max(EC - 1)
        y = y + out_flat[brow, sl] * gk_pair[:, :, i, None].to(out_flat.dtype)
    return y


def apply_moe(params, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    dtype = x.dtype
    B, S, d = x.shape
    E, Sk = cfg.num_experts, S * cfg.top_k

    probs = router_probs(params, x)
    C = capacity(cfg, S)
    slot_pair, gk_pair, starts = route(cfg, probs, C)

    h = _dispatch(x, slot_pair, E * C).reshape(B, E, C, d)
    gct = torch.einsum("becd,edf->becf", h, params["wi_gate"].to(dtype))
    up = torch.einsum("becd,edf->becf", h, params["wi_up"].to(dtype))
    out = torch.einsum("becf,efd->becd", F.silu(gct) * up, params["wo"].to(dtype))
    y = _combine(out.reshape(B, E * C, d), slot_pair, gk_pair)

    # load-balancing aux loss (per sequence, averaged)
    counts = torch.cat([starts[:, 1:] - starts[:, :-1], Sk - starts[:, -1:]], dim=1).to(torch.float32)
    frac = counts / Sk
    aux = E * torch.mean(torch.sum(frac * probs.mean(dim=1), dim=-1))

    if cfg.num_shared_experts > 0:
        sp = params["shared"]
        g = x @ sp["wi_gate"].to(dtype)
        u = x @ sp["wi_up"].to(dtype)
        y = y + (F.silu(g) * u) @ sp["wo"].to(dtype)
    return y, aux
