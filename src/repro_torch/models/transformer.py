"""Decoder-LM assembly: blocks, the layer loop, caches, loss, serving entry
points.

The port's copy of the reference's ``models/transformer.py``: the layer
kinds ``attn``, ``local`` and ``rec``, with GQA or MLA attention and dense
or MoE MLPs, and the self-contained xLSTM kinds ``mlstm`` and ``slstm``
(a norm and the mixer, no MLP sub-layer, never MoE).  A block built with
``cross=True`` (the encoder-decoder's decoder, ``models.encdec``) adds a
cross-attention sub-layer after self-attention.  Depth is ``prefix``
layers (unrepeated, dense: deepseek-v2's first layer) followed by
``num_units`` repetitions of ``cfg.pattern``; a
repeated layer's MLP is a mixture of experts when the config has experts
(:func:`_layer_is_moe`).  The reference scans one unit body over stacked
parameters with ``lax.scan`` (under ``jax.checkpoint`` when
``remat="full"``, with ``maybe_constrain`` sharding hints); the port keeps
one module per layer and runs a Python loop over them.  When the
parameters require gradients and ``remat="full"``, each layer runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward, as the reference recomputes its unit body.  Sharding
hints have no counterpart on one card and are dropped.

Parameters: ``LanguageModel`` holds them under the reference's tree keys
(``embed.embedding``, ``prefix.0.rec.wa``, ``layers.4.attn.wq``,
``layers.1.mlp.wi_gate`` of shape ``(E, d, ff)``, ``final_norm.scale``),
with unit ``u``, slot ``s`` at layer ``len(prefix) + u * len(pattern) + s``
(``nn/convert.py``).  They stay in the dtype their specs give (float32)
and are cast at each use as the reference casts them.  The embedding rows
are gathered before the cast to ``cfg.dtype`` (the reference casts the
table first, for sharding): the values are the same, and the 256k-row
table is not cast whole per token.

Training reads the parameters in the reference's stacked layout
(:class:`StackedParams`: ``units[s]`` leaves with a leading ``num_units``
axis, sliced per layer by ``unbind``, so each stacked tensor gets one
gradient).  :func:`lm_loss` is the reference's chunked cross-entropy.

Caches: a list with one entry per layer, in depth order (the reference
stacks the units' caches).  Prefill and decode update attention caches in
place; recurrent layers return new state tensors.

``prefix_embeds`` (the vision frontend's stub patch embeddings, ``(B, P,
d)``) are prepended to the embedded text in :func:`apply_lm`,
:func:`prefill` and :func:`lm_loss`: positions run over prefix plus text,
the loss is taken over the text positions only, and a cache's budget must
cover ``P + S_text`` plus the tokens to decode.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..nn.convert import unstack_tree
from ..nn.params import ParamSpec, ParamTree, init_tree, tree_leaves
from .attention import (
    apply_attn,
    apply_mla,
    attn_cache_axes,
    attn_spec,
    init_attn_cache,
    init_mla_cache,
    mla_cache_axes,
    mla_spec,
)
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, embedding_spec, mlp_spec, norm_spec, softcap, stacked
from .moe import apply_moe, moe_spec
from .recurrent import (
    apply_mlstm_block,
    apply_rglru_block,
    apply_slstm_block,
    init_mlstm_cache,
    init_rglru_cache,
    init_slstm_cache,
    mlstm_cache_axes,
    mlstm_spec,
    rglru_cache_axes,
    rglru_spec,
    slstm_cache_axes,
    slstm_spec,
)

__all__ = [
    "LanguageModel",
    "StackedParams",
    "apply_block",
    "apply_lm",
    "block_spec",
    "cache_axes",
    "chunked_xent",
    "decode_step",
    "init_cache",
    "init_lm",
    "lm_logits",
    "lm_loss",
    "lm_spec",
    "prefill",
    "run_layers",
]


# ---------------------------------------------------------------------------
# Block spec / apply
# ---------------------------------------------------------------------------


_SELF_CONTAINED = ("mlstm", "slstm")  # kinds with no separate MLP sub-layer


def block_spec(cfg: ModelConfig, kind: str, *, moe: bool = False, d_ff: int, cross: bool = False) -> Dict:
    if kind == "mlstm":
        return {"norm": norm_spec(cfg.d_model, cfg.norm_kind), "mix": mlstm_spec(cfg)}
    if kind == "slstm":
        return {"norm": norm_spec(cfg.d_model, cfg.norm_kind), "mix": slstm_spec(cfg)}
    spec: Dict[str, Any] = {"norm1": norm_spec(cfg.d_model, cfg.norm_kind)}
    if kind in ("attn", "local"):
        spec["attn"] = mla_spec(cfg) if cfg.mla else attn_spec(cfg)
    elif kind == "rec":
        spec["rec"] = rglru_spec(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    if cross:
        spec["norm_x"] = norm_spec(cfg.d_model, cfg.norm_kind)
        spec["xattn"] = attn_spec(cfg, cross=True)
    spec["norm2"] = norm_spec(cfg.d_model, cfg.norm_kind)
    spec["mlp"] = moe_spec(cfg) if moe else mlp_spec(cfg.d_model, d_ff, cfg.mlp_kind)
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
    moe: bool = False,
    cache: Optional[Dict] = None,
    decode: bool = False,
    causal: bool = True,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss); the aux loss is zero unless
    ``moe``.  ``cross_kv``: the encoder's K/V for a ``cross=True`` block."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _SELF_CONTAINED:
        h = apply_norm(params["norm"], x)
        fn = apply_mlstm_block if kind == "mlstm" else apply_slstm_block
        y, new_cache = fn(params["mix"], cfg, h, cache=cache, decode=decode)
        return x + y, new_cache, aux

    h = apply_norm(params["norm1"], x)
    if kind in ("attn", "local"):
        if cfg.mla:
            y, new_cache = apply_mla(params["attn"], cfg, h, positions, cache=cache, decode=decode)
        else:
            y, new_cache = apply_attn(
                params["attn"], cfg, h, positions, kind=kind, causal=causal, cache=cache, decode=decode
            )
    else:  # rec
        y, new_cache = apply_rglru_block(params["rec"], cfg, h, cache=cache, decode=decode)
    if cfg.post_norms:
        y = apply_norm(params["post_norm1"], y)
    x = x + y

    if cross_kv is not None:
        h = apply_norm(params["norm_x"], x)
        y, _ = apply_attn(params["xattn"], cfg, h, positions, kind="attn", causal=False, decode=decode,
                          cross_kv=cross_kv)
        x = x + y

    h = apply_norm(params["norm2"], x)
    if moe:
        y, aux = apply_moe(params["mlp"], cfg, h)
    else:
        y = apply_mlp(params["mlp"], h, cfg.mlp_kind)
    if cfg.post_norms:
        y = apply_norm(params["post_norm2"], y)
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# Model spec and module
# ---------------------------------------------------------------------------


def _layer_is_moe(cfg: ModelConfig, kind: str, in_prefix: bool) -> bool:
    return cfg.is_moe and not in_prefix and kind not in _SELF_CONTAINED


def _prefix_spec(cfg: ModelConfig, kind: str) -> Dict:
    return block_spec(cfg, kind, moe=False, d_ff=cfg.prefix_dense_ff or cfg.d_ff)


def _unit_spec(cfg: ModelConfig, kind: str) -> Dict:
    return block_spec(cfg, kind, moe=_layer_is_moe(cfg, kind, False), d_ff=cfg.d_ff)


def lm_spec(cfg: ModelConfig) -> Dict:
    """The reference's spec tree: ``units[s]`` stacks slot ``s`` of every
    unit along a leading ``layers`` axis (which the fan-in rule skips, as
    it skips a following ``experts`` axis)."""
    spec: Dict[str, Any] = {"embed": embedding_spec(cfg.vocab_size, cfg.d_model)}
    spec["prefix"] = tuple(_prefix_spec(cfg, k) for k in cfg.prefix)
    spec["units"] = tuple(stacked(_unit_spec(cfg, k), cfg.num_units) for k in cfg.pattern)
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
        self.prefix = torch.nn.ModuleList(ParamTree(_prefix_spec(cfg, k)) for k in cfg.prefix)
        self.layers = torch.nn.ModuleDict(
            {
                str(i): ParamTree(_unit_spec(cfg, kind))
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


def _split_units(node, n: int) -> List:
    """A stacked (sub)tree as ``n`` trees of slices, one ``unbind`` a leaf."""
    if isinstance(node, dict):
        parts = {k: _split_units(v, n) for k, v in node.items()}
        return [{k: parts[k][u] for k in node} for u in range(n)]
    return list(node.unbind(0))


class StackedParams:
    """A parameter tree in the reference's layout (``embed``, ``prefix``,
    ``units`` stacked along a leading ``num_units`` axis, ``final_norm``,
    ``head``) read as :func:`apply_lm` reads a ``LanguageModel``:
    ``block(i)`` is layer ``i``'s dict of tensors, the units' as slices of
    the stacked leaves (one ``unbind`` per leaf, so autograd hands each
    stacked tensor one gradient).  ``pattern`` and ``num_units`` default
    to the config's; the encoder-decoder passes its halves' (a tree without
    ``prefix`` has none)."""

    def __init__(self, cfg: ModelConfig, tree: Dict, *, pattern: Optional[Tuple[str, ...]] = None,
                 num_units: Optional[int] = None):
        self.cfg, self.tree = cfg, tree
        pattern = cfg.pattern if pattern is None else pattern
        num_units = cfg.num_units if num_units is None else num_units
        prefix = tree.get("prefix", ())
        n_pre, n_slots = len(cfg.prefix) if "prefix" in tree else 0, len(pattern)
        slots = [_split_units(slot, num_units) for slot in tree["units"]]
        if len(prefix) != n_pre or len(slots) != n_slots:
            raise ValueError(f"{cfg.name}: the tree has {len(prefix)} prefix layers and {len(slots)} "
                             f"pattern slots, the config {n_pre} and {n_slots}")
        self._blocks = list(prefix) + [slots[s][u] for u in range(num_units) for s in range(n_slots)]

    def __getitem__(self, key: str):
        return self.tree[key]

    def block(self, i: int) -> Dict:
        return self._blocks[i]


def _requires_grad(params) -> bool:
    leaves = (t for _, t in tree_leaves(params.tree)) if isinstance(params, StackedParams) else params.parameters()
    return any(t.requires_grad for t in leaves)


def init_lm(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> LanguageModel:
    """A ``LanguageModel`` with random weights drawn by ``init_tree`` from
    ``generator`` (which must live on ``device``)."""
    return LanguageModel.from_state_dict(cfg, unstack_tree(init_tree(lm_spec(cfg), generator, device), cfg))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_budget: int, dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """One empty cache per layer, in depth order."""
    return [_kind_cache(cfg, kind, batch, seq_budget, dtype, device) for kind in cfg.layer_kinds()]


def _kind_cache(cfg: ModelConfig, kind: str, batch: int, seq_budget: int, dtype, device) -> Dict:
    if kind in ("attn", "local"):
        if cfg.mla:
            return init_mla_cache(cfg, batch, seq_budget, dtype, device)
        return init_attn_cache(cfg, kind, batch, seq_budget, dtype, device)
    if kind == "rec":
        return init_rglru_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def _kind_cache_axes(cfg: ModelConfig, kind: str) -> Dict:
    if kind in ("attn", "local"):
        return mla_cache_axes(cfg) if cfg.mla else attn_cache_axes(cfg, kind)
    if kind == "rec":
        return rglru_cache_axes(cfg)
    if kind == "mlstm":
        return mlstm_cache_axes(cfg)
    if kind == "slstm":
        return slstm_cache_axes(cfg)
    raise ValueError(kind)


def cache_axes(cfg: ModelConfig) -> List[Dict]:
    """The logical-axes tree of :func:`init_cache`: one dict per layer, in
    depth order (the reference stacks the units' caches, and their axes,
    along a leading ``layers`` axis)."""
    return [_kind_cache_axes(cfg, kind) for kind in cfg.layer_kinds()]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["embedding"][tokens].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype, device=x.device)
    return x


def run_layers(
    params,
    cfg: ModelConfig,
    kinds: Tuple[str, ...],
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    n_pre: int = 0,
    caches: Optional[List[Dict]] = None,
    decode: bool = False,
    causal: bool = True,
    cross_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Optional[List[Dict]], torch.Tensor]:
    """The layer loop: layer ``i`` of kind ``kinds[i]`` is ``params.block(i)``
    (its MLP dense for the first ``n_pre``), reading ``caches[i]`` and
    ``cross_kv[i]`` when given.  Returns (x, new_caches, the MoE aux losses
    summed in depth order).  With gradients on, ``remat="full"`` and no
    caches, each layer runs under ``torch.utils.checkpoint``."""
    new_caches = [] if caches is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "full" and caches is None and torch.is_grad_enabled() and _requires_grad(params)
    for i, kind in enumerate(kinds):
        c = caches[i] if caches is not None else None
        xkv = cross_kv[i] if cross_kv is not None else None
        kw = dict(moe=_layer_is_moe(cfg, kind, i < n_pre), cache=c, decode=decode, causal=causal, cross_kv=xkv)
        if remat:
            def layer(x, block=params.block(i), kind=kind, kw=kw):
                y, _, aux = apply_block(block, cfg, kind, x, positions, **kw)
                return y, aux

            x, aux = checkpoint(layer, x, use_reentrant=False)
            nc = None
        else:
            x, nc, aux = apply_block(params.block(i), cfg, kind, x, positions, **kw)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches, aux_total


def apply_lm(
    params: LanguageModel,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S_text)
    positions: torch.Tensor,  # (S,) over the whole sequence (prefix + text)
    *,
    caches: Optional[List[Dict]] = None,
    decode: bool = False,
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, P, d) modality stub
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[List[Dict]], torch.Tensor]:
    """Returns (hidden (B,S,d), new_caches, aux_loss_sum): the MoE layers'
    aux losses summed in depth order.  ``params``: a ``LanguageModel`` or
    :class:`StackedParams`.  ``prefix_embeds`` are cast to ``cfg.dtype``
    and prepended to the embedded tokens.  With gradients on,
    ``remat="full"`` and no caches, each layer runs under
    ``torch.utils.checkpoint``."""
    x = _embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x, new_caches, aux_total = run_layers(params, cfg, cfg.layer_kinds(), x, positions, n_pre=len(cfg.prefix),
                                          caches=caches, decode=decode, causal=causal)
    x = apply_norm(params["final_norm"], x)
    return x, new_caches, aux_total


def lm_logits(params: LanguageModel, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"]["embedding"].T if cfg.tie_embeddings else params["head"]
    logits = (hidden @ w.to(hidden.dtype)).to(cfg.logit_dtype)
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy over the sequence)
# ---------------------------------------------------------------------------


def _exp_shifted_(s: torch.Tensor):
    """``(exp(s - m), m)`` with ``m`` the last dim's max (0 where it is
    infinite), the exponentials written over ``s``: ``torch.logsumexp``'s
    arithmetic without its temporary of ``s``'s size."""
    m = torch.amax(s, dim=-1, keepdim=True)
    m.masked_fill_(m.abs() == float("inf"), 0.0)
    return s.sub_(m).exp_(), m


def _xent_chunk(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor, cap: float):
    """One chunk's summed nll, label count and summed ``lse**2``; the
    float32 logits are the only buffer of their size."""
    logits = softcap((h @ w).to(torch.float32), cap)
    gold = torch.gather(logits, -1, y.clamp_min(0)[..., None])[..., 0]
    e, m = _exp_shifted_(logits)
    lse = e.sum(-1).log_().add_(m[..., 0])
    mask = (y >= 0).to(torch.float32)
    return ((lse - gold) * mask).sum(), mask.sum(), (lse.square() * mask).sum()


class _XentChunk(torch.autograd.Function):
    """:func:`_xent_chunk` with its logits recomputed in the backward, as
    the reference's ``jax.checkpoint`` of the chunk recomputes them; the
    backward works on the float32 logits in place, so a chunk holds about
    two logits-sized float32 buffers (autograd through the forward would
    keep five)."""

    @staticmethod
    def forward(ctx, h, w, y, cap):
        with torch.no_grad():
            out = _xent_chunk(h, w, y, cap)
        ctx.save_for_backward(h, w, y)
        ctx.cap = cap
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_nll, g_cnt, g_zl):
        h, w, y = ctx.saved_tensors
        cap = ctx.cap
        z = (h @ w).to(torch.float32)
        t = z.div_(cap).tanh_() if cap > 0 else None  # tanh(z / cap), in z's buffer
        s = t * cap if t is not None else z
        p, m = _exp_shifted_(s)  # the softmax, in s's buffer
        total = p.sum(-1, keepdim=True)
        p.div_(total)
        lse = total.log_().add_(m)
        mask = (y >= 0).to(torch.float32)[..., None]
        # d(nll_sum)/ds = mask (p - onehot); d(zl_sum)/ds = mask 2 lse p
        p.mul_(mask * (g_nll + 2.0 * g_zl * lse))
        p.scatter_add_(-1, y.clamp_min(0)[..., None], -(g_nll * mask))
        if t is not None:
            p.mul_(t.square_().neg_().add_(1.0))  # ds/dz = 1 - tanh^2
            del t
        dz = p.to(h.dtype)
        del p, s, z
        dh = dz @ w.T if ctx.needs_input_grad[0] else None
        dw = h.reshape(-1, h.shape[-1]).T @ dz.reshape(-1, dz.shape[-1]) if ctx.needs_input_grad[1] else None
        return dh, dw, None, None


def lm_loss(params: Dict, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``lm_loss``: ``batch`` holds ``tokens`` and
    ``labels`` ``(B, S)`` (label -1 = ignored) and, for a vision config,
    ``prefix_embeds (B, P, d)``, prepended to the text (the loss is taken
    over the text positions only); returns ``(loss, metrics)`` with
    ``nll``, ``tokens`` and ``aux``.  ``params``: the
    parameter tree in the reference's stacked layout (the training state's;
    read through :class:`StackedParams`).  The cross-entropy runs in
    chunks of ``xent_chunk`` positions (:func:`chunked_xent`), so the
    backward holds one chunk's float32 logits; ``final_softcap``, the
    ``zloss`` term and the MoE aux term ``aux_loss_weight * aux /
    num_layers`` as the reference adds them."""
    if not isinstance(params, dict):
        raise TypeError(f"lm_loss takes the stacked parameter tree, not {type(params).__name__} "
                        "(nn.convert.stack_tree turns a model's state_dict into it)")
    params = StackedParams(cfg, params)
    tokens, labels = batch["tokens"], batch["labels"]
    prefix_embeds = batch.get("prefix_embeds")
    P = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    hidden, _, aux = apply_lm(params, cfg, tokens, torch.arange(P + tokens.shape[1], device=tokens.device),
                              prefix_embeds=prefix_embeds)
    hidden = hidden[:, P:]  # loss over text positions only
    w = params["embed"]["embedding"].T if cfg.tie_embeddings else params["head"]
    nll_sum, cnt, zl_sum = chunked_xent(hidden, w.to(hidden.dtype), labels, cfg.xent_chunk, cfg.final_softcap)
    denom = torch.clamp_min(cnt, 1.0)
    loss = nll_sum / denom
    if cfg.zloss > 0:
        loss = loss + cfg.zloss * zl_sum / denom
    if cfg.is_moe:
        loss = loss + cfg.aux_loss_weight * aux / max(cfg.num_layers, 1)
    return loss, {"nll": nll_sum / denom, "tokens": cnt, "aux": aux}


def chunked_xent(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, xent_chunk: int, cap: float):
    """The summed nll, label count and summed ``lse**2`` of ``hidden @ w``
    (softcapped by ``cap``) against ``labels``, ``xent_chunk`` positions of
    every sequence at a time (the whole sequence when it is 0 or does not
    divide it), each chunk's logits recomputed in the backward when
    gradients are on (:class:`_XentChunk`)."""
    S = hidden.shape[1]
    L = min(xent_chunk if xent_chunk > 0 else S, S)
    if S % L != 0:
        L = S
    grad = torch.is_grad_enabled() and (hidden.requires_grad or w.requires_grad)
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll_sum, cnt, zl_sum = zero, zero, zero
    for c in range(S // L):
        h, y = hidden[:, c * L:(c + 1) * L], labels[:, c * L:(c + 1) * L]
        if grad:
            nll, n, zl = _XentChunk.apply(h, w, y, cap)
        else:
            nll, n, zl = _xent_chunk(h, w, y, cap)
        nll_sum, cnt, zl_sum = nll_sum + nll, cnt + n, zl_sum + zl
    return nll_sum, cnt, zl_sum


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def prefill(
    params: LanguageModel,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    caches: List[Dict],
    *,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """Run the prompt (after ``prefix_embeds``, when given) through the
    model, filling caches; returns (last-position logits (B, V), caches).
    The next token's position is ``P + S_text``."""
    P = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    positions = torch.arange(P + tokens.shape[1], device=tokens.device)
    hidden, caches, _ = apply_lm(params, cfg, tokens, positions, caches=caches, prefix_embeds=prefix_embeds)
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
