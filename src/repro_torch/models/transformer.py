"""Decoder-LM assembly: blocks, the layer loop, caches, serving entry points.

The port's copy of the reference's ``models/transformer.py`` for the layer
kinds ``attn``, ``local`` and ``rec``.  Depth is ``prefix`` layers followed
by ``num_units`` repetitions of ``cfg.pattern``.  The reference scans one
unit body over stacked parameters with ``lax.scan`` (under
``jax.checkpoint`` when ``remat="full"``, with ``maybe_constrain`` sharding
hints); the port keeps one module per layer and runs a Python loop over
them.  Remat and sharding hints have no counterpart in serving and are
dropped.

Parameters: ``LanguageModel`` holds them under the reference's tree keys
(``embed.embedding``, ``prefix.0.rec.wa``, ``layers.4.attn.wq``,
``final_norm.scale``), with unit ``u``, slot ``s`` at layer
``len(prefix) + u * len(pattern) + s`` (``nn/convert.py``).  They stay in
the dtype their specs give (float32) and are cast at each use as the
reference casts them.  The embedding rows are gathered before the cast to
``cfg.dtype`` (the reference casts the table first, for sharding): the
values are the same, and the 256k-row table is not cast whole per token.

Caches: a list with one entry per layer, in depth order (the reference
stacks the units' caches).  Prefill and decode update them in place.

MoE, MLA, the self-contained ``mlstm``/``slstm`` kinds, ``prefix_embeds``,
cross-attention units and ``lm_loss`` come later (ROADMAP queue 1, item 10: what remains of the LLM stack).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..nn.convert import unstack_tree
from ..nn.params import ParamSpec, ParamTree, init_tree
from .attention import apply_attn, attn_spec, init_attn_cache
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, embedding_spec, mlp_spec, norm_spec, softcap, stacked
from .recurrent import apply_rglru_block, init_rglru_cache, rglru_spec

__all__ = [
    "LanguageModel",
    "apply_block",
    "apply_lm",
    "block_spec",
    "decode_step",
    "init_cache",
    "init_lm",
    "lm_logits",
    "lm_spec",
    "prefill",
]

_LATER = "(ROADMAP queue 1, item 10: what remains of the LLM stack)"


# ---------------------------------------------------------------------------
# Block spec / apply
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, kind: str, *, moe: bool = False, d_ff: int, cross: bool = False) -> Dict:
    if moe or cross:
        raise NotImplementedError(f"MoE and cross-attention blocks are not ported yet {_LATER}")
    if kind in ("mlstm", "slstm"):
        raise NotImplementedError(f"{kind} blocks are not ported yet {_LATER}")
    spec: Dict[str, Any] = {"norm1": norm_spec(cfg.d_model, cfg.norm_kind)}
    if kind in ("attn", "local"):
        spec["attn"] = attn_spec(cfg)
    elif kind == "rec":
        spec["rec"] = rglru_spec(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    spec["norm2"] = norm_spec(cfg.d_model, cfg.norm_kind)
    spec["mlp"] = mlp_spec(cfg.d_model, d_ff, cfg.mlp_kind)
    if cfg.post_norms:
        spec["post_norm1"] = norm_spec(cfg.d_model, cfg.norm_kind)
        spec["post_norm2"] = norm_spec(cfg.d_model, cfg.norm_kind)
    return spec


def apply_block(
    params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[Dict] = None,
    decode: bool = False,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x, new_cache)."""
    h = apply_norm(params["norm1"], x)
    if kind in ("attn", "local"):
        y, new_cache = apply_attn(
            params["attn"], cfg, h, positions, kind=kind, causal=causal, cache=cache, decode=decode
        )
    else:  # rec
        y, new_cache = apply_rglru_block(params["rec"], cfg, h, cache=cache, decode=decode)
    if cfg.post_norms:
        y = apply_norm(params["post_norm1"], y)
    x = x + y

    h = apply_norm(params["norm2"], x)
    y = apply_mlp(params["mlp"], h, cfg.mlp_kind)
    if cfg.post_norms:
        y = apply_norm(params["post_norm2"], y)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# Model spec and module
# ---------------------------------------------------------------------------


def lm_spec(cfg: ModelConfig) -> Dict:
    """The reference's spec tree: ``units[s]`` stacks slot ``s`` of every
    unit along a leading ``layers`` axis (which the fan-in rule skips)."""
    spec: Dict[str, Any] = {"embed": embedding_spec(cfg.vocab_size, cfg.d_model)}
    spec["prefix"] = tuple(
        block_spec(cfg, k, d_ff=cfg.prefix_dense_ff or cfg.d_ff) for k in cfg.prefix
    )
    spec["units"] = tuple(
        stacked(block_spec(cfg, k, d_ff=cfg.d_ff), cfg.num_units) for k in cfg.pattern
    )
    spec["final_norm"] = norm_spec(cfg.d_model, cfg.norm_kind)
    if not cfg.tie_embeddings:
        spec["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return spec


class LanguageModel(torch.nn.Module):
    """The decoder LM's parameters, one ``ParamTree`` per layer (see the
    module docstring for the names).  Built empty (``meta`` tensors); fill
    it with :meth:`from_state_dict` or use :func:`init_lm`; run it with
    :func:`apply_lm`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        n_pre = len(cfg.prefix)
        self.embed = ParamTree(embedding_spec(cfg.vocab_size, cfg.d_model))
        self.prefix = torch.nn.ModuleList(
            ParamTree(block_spec(cfg, k, d_ff=cfg.prefix_dense_ff or cfg.d_ff)) for k in cfg.prefix
        )
        self.layers = torch.nn.ModuleDict(
            {
                str(i): ParamTree(block_spec(cfg, kind, d_ff=cfg.d_ff))
                for i, kind in enumerate(cfg.layer_kinds())
                if i >= n_pre
            }
        )
        self.final_norm = ParamTree(norm_spec(cfg.d_model, cfg.norm_kind))
        if not cfg.tie_embeddings:
            empty = torch.empty((cfg.d_model, cfg.vocab_size), dtype=torch.float32, device="meta")
            self.head = torch.nn.Parameter(empty, requires_grad=False)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def block(self, i: int) -> ParamTree:
        """Layer ``i`` in depth order, prefix first."""
        n_pre = len(self.cfg.prefix)
        return self.prefix[i] if i < n_pre else self.layers[str(i)]

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state: Dict[str, torch.Tensor]) -> "LanguageModel":
        model = cls(cfg)
        model.load_state_dict(state, strict=True, assign=True)
        return model


def init_lm(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> LanguageModel:
    """A ``LanguageModel`` with random weights drawn by ``init_tree`` from
    ``generator`` (which must live on ``device``)."""
    return LanguageModel.from_state_dict(cfg, unstack_tree(init_tree(lm_spec(cfg), generator, device), cfg))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_budget: int, dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """One empty cache per layer, in depth order."""
    caches = []
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local"):
            caches.append(init_attn_cache(cfg, kind, batch, seq_budget, dtype, device))
        elif kind == "rec":
            caches.append(init_rglru_cache(cfg, batch, dtype, device))
        else:
            raise NotImplementedError(f"{kind} caches are not ported yet {_LATER}")
    return caches


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["embedding"][tokens].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype, device=x.device)
    return x


def apply_lm(
    params: LanguageModel,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S)
    positions: torch.Tensor,  # (S,)
    *,
    caches: Optional[List[Dict]] = None,
    decode: bool = False,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[List[Dict]], torch.Tensor]:
    """Returns (hidden (B,S,d), new_caches, aux_loss_sum); the aux loss is
    zero (no MoE layer is ported)."""
    x = _embed_tokens(params, cfg, tokens)
    new_caches = [] if caches is not None else None
    for i, kind in enumerate(cfg.layer_kinds()):
        c = caches[i] if caches is not None else None
        x, nc = apply_block(params.block(i), cfg, kind, x, positions, cache=c, decode=decode, causal=causal)
        if new_caches is not None:
            new_caches.append(nc)
    x = apply_norm(params["final_norm"], x)
    return x, new_caches, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_logits(params: LanguageModel, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"]["embedding"].T if cfg.tie_embeddings else params["head"]
    logits = (hidden @ w.to(hidden.dtype)).to(cfg.logit_dtype)
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def prefill(
    params: LanguageModel, cfg: ModelConfig, tokens: torch.Tensor, caches: List[Dict]
) -> Tuple[torch.Tensor, List[Dict]]:
    """Run the prompt through the model, filling caches; returns
    (last-position logits (B, V), caches)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    hidden, caches, _ = apply_lm(params, cfg, tokens, positions, caches=caches)
    return lm_logits(params, cfg, hidden[:, -1:])[:, 0], caches


def decode_step(
    params: LanguageModel,
    cfg: ModelConfig,
    token: torch.Tensor,  # (B, 1)
    pos: Union[int, torch.Tensor],  # absolute position of this token
    caches: List[Dict],
) -> Tuple[torch.Tensor, List[Dict]]:
    positions = torch.as_tensor(pos, device=token.device).reshape(1).to(torch.int64)
    hidden, caches, _ = apply_lm(params, cfg, token, positions, caches=caches, decode=True)
    return lm_logits(params, cfg, hidden[:, 0]), caches
