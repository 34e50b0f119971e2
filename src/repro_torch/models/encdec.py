"""Encoder-decoder assembly (seamless-m4t): audio-stub encoder + text decoder.

The port's copy of the reference's ``models/encdec.py``.  The modality
frontend is a stub: the encoder takes precomputed frame embeddings ``(B,
S_enc, d)`` (``models.frontends.stub_frame_embeddings``).  Encoder blocks
run non-causal self-attention; decoder blocks carry causal, cached
self-attention and cross-attention over the encoder's output, whose K/V
are projected once per layer (:func:`_cross_kv_all`) and kept in the cache
for decode.  The logits are tied to the decoder's embedding and pass
through ``final_softcap``; the loss (:func:`encdec_loss`) is the
reference's, without softcap or zloss.

Where the kernel runs: the encoder's self-attention (non-causal, ``Sq ==
Sk``), the decoder's self-attention outside decode and its cross-attention
outside decode (non-causal, ``Sq != Sk``) call ``ops.flash_attention``;
decode's attention is plain torch, as in the reference.

Parameters: :class:`EncoderDecoder` holds them under the reference's tree
keys, one module per layer: ``encoder.layers.<i>`` (unit ``u``, slot
``s`` of ``encoder_pattern`` at ``i = u * len(encoder_pattern) + s``),
``encoder.final_norm``, ``decoder.embed``, ``decoder.layers.<i>`` (of
``pattern``) and ``decoder.final_norm`` (``nn/convert.py`` carries the
reference's ``encoder.units`` / ``decoder.units`` both ways).  Training
reads the reference's stacked tree through :class:`StackedParams`, as the
decoder LM's does.

Caches: ``{"layers": [per decoder layer self-attention cache], "cross_kv":
[per decoder layer (k, v), each (B, S_enc, Kv, hd)]}``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..nn.convert import unstack_tree
from ..nn.params import ParamTree, init_tree
from .attention import _project, init_attn_cache
from .config import ModelConfig
from .layers import apply_norm, embedding_spec, norm_spec, softcap, stacked
from .transformer import StackedParams, _embed_tokens, block_spec, chunked_xent, run_layers

__all__ = [
    "EncoderDecoder",
    "apply_decoder",
    "encdec_decode_step",
    "encdec_loss",
    "encdec_prefill",
    "encdec_spec",
    "encode",
    "init_encdec",
    "encdec_cache_axes",
    "init_encdec_cache",
]


def _enc_units(cfg: ModelConfig) -> int:
    return cfg.encoder_layers // len(cfg.encoder_pattern)


def _enc_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg.encoder_pattern * _enc_units(cfg)


def _dec_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg.pattern * cfg.num_units


def _enc_block(cfg: ModelConfig, kind: str) -> Dict:
    return block_spec(cfg, kind, moe=False, d_ff=cfg.d_ff)


def _dec_block(cfg: ModelConfig, kind: str) -> Dict:
    return block_spec(cfg, kind, moe=False, d_ff=cfg.d_ff, cross=True)


def encdec_spec(cfg: ModelConfig) -> Dict:
    """The reference's spec tree: each half's ``units[s]`` stacks slot
    ``s`` of its units along a leading ``layers`` axis."""
    return {
        "encoder": {
            "units": tuple(stacked(_enc_block(cfg, k), _enc_units(cfg)) for k in cfg.encoder_pattern),
            "final_norm": norm_spec(cfg.d_model, cfg.norm_kind),
        },
        "decoder": {
            "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
            "units": tuple(stacked(_dec_block(cfg, k), cfg.num_units) for k in cfg.pattern),
            "final_norm": norm_spec(cfg.d_model, cfg.norm_kind),
        },
    }


class _Half(torch.nn.Module):
    """One half of the model: its layers in depth order, its final norm and
    (the decoder's) embedding; read as ``apply_lm`` reads a
    ``LanguageModel`` (``block(i)``, ``half["final_norm"]``)."""

    def __init__(self, cfg: ModelConfig, blocks: List[Dict], embed: bool):
        super().__init__()
        if embed:
            self.embed = ParamTree(embedding_spec(cfg.vocab_size, cfg.d_model))
        self.layers = torch.nn.ModuleDict({str(i): ParamTree(spec) for i, spec in enumerate(blocks)})
        self.final_norm = ParamTree(norm_spec(cfg.d_model, cfg.norm_kind))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def block(self, i: int) -> ParamTree:
        return self.layers[str(i)]


class EncoderDecoder(torch.nn.Module):
    """The encoder-decoder's parameters (see the module docstring for the
    names).  Built empty (``meta`` tensors); fill it with
    :meth:`from_state_dict` or use :func:`init_encdec`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder (encoder_layers = 0)")
        self.cfg = cfg
        self.encoder = _Half(cfg, [_enc_block(cfg, k) for k in _enc_kinds(cfg)], embed=False)
        self.decoder = _Half(cfg, [_dec_block(cfg, k) for k in _dec_kinds(cfg)], embed=True)

    def __getitem__(self, key: str):
        return getattr(self, key)

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state: Dict[str, torch.Tensor]) -> "EncoderDecoder":
        model = cls(cfg)
        model.load_state_dict(state, strict=True, assign=True)
        return model


def init_encdec(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> EncoderDecoder:
    """An ``EncoderDecoder`` with random weights drawn by ``init_tree`` from
    ``generator`` (which must live on ``device``)."""
    return EncoderDecoder.from_state_dict(cfg, unstack_tree(init_tree(encdec_spec(cfg), generator, device), cfg))


Params = Union[EncoderDecoder, Dict[str, Any]]


def _halves(params: Params, cfg: ModelConfig):
    """The two halves, each read by ``block(i)``: the module's, or the
    reference's stacked tree (training) read through ``StackedParams``."""
    if isinstance(params, dict) and isinstance(params["encoder"], dict):
        return {
            "encoder": StackedParams(cfg, params["encoder"], pattern=cfg.encoder_pattern, num_units=_enc_units(cfg)),
            "decoder": StackedParams(cfg, params["decoder"]),
        }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: ``(B, S_enc, d)`` stub embeddings -> encoder hidden ``(B,
    S_enc, d)``, non-causal self-attention throughout."""
    enc = _halves(params, cfg)["encoder"]
    x = frames.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = run_layers(enc, cfg, _enc_kinds(cfg), x, positions, causal=False)
    return apply_norm(enc["final_norm"], x)


def _cross_kv_all(params: Params, cfg: ModelConfig, enc_out: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder layer's cross K/V from the encoder's output, without
    rope: a list of ``(k, v)``, each ``(B, S_enc, Kv, hd)``."""
    dec = _halves(params, cfg)["decoder"]
    dtype = enc_out.dtype
    out = []
    for i in range(len(_dec_kinds(cfg))):
        xattn = dec.block(i)["xattn"]
        out.append((_project(enc_out, xattn["wk"].to(dtype)), _project(enc_out, xattn["wv"].to(dtype))))
    return out


def apply_decoder(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cross_kv: List[Tuple[torch.Tensor, torch.Tensor]],
    *,
    caches: Optional[Dict] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The decoder over ``tokens`` at ``positions`` (causal self-attention,
    cross-attention over ``cross_kv``); ``caches``: ``{"layers": [...]}``.
    Returns (hidden ``(B, S, d)``, ``{"layers": new caches}`` or None)."""
    dec = _halves(params, cfg)["decoder"]
    x = _embed_tokens(dec, cfg, tokens)
    x, new_layers, _ = run_layers(dec, cfg, _dec_kinds(cfg), x, positions,
                                  caches=caches["layers"] if caches is not None else None,
                                  decode=decode, causal=True, cross_kv=cross_kv)
    x = apply_norm(dec["final_norm"], x)
    return x, ({"layers": new_layers} if caches is not None else None)


def _dec_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    w = _halves(params, cfg)["decoder"]["embed"]["embedding"].T
    logits = (hidden @ w.to(hidden.dtype)).to(cfg.logit_dtype)
    return softcap(logits, cfg.final_softcap)


def encdec_loss(params: Dict, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``encdec_loss``: ``batch`` holds ``frames (B, S_enc,
    d)``, ``tokens`` and ``labels (B, S_dec)``; ``params``: the stacked
    tree (the training state's).  The cross-entropy against the tied
    decoder embedding runs in chunks of ``xent_chunk`` positions
    (``chunked_xent``), without softcap or zloss, as in the reference."""
    if not isinstance(params, dict):
        raise TypeError(f"encdec_loss takes the stacked parameter tree, not {type(params).__name__} "
                        "(nn.convert.stack_tree turns a model's state_dict into it)")
    halves = _halves(params, cfg)
    enc_out = encode(halves, cfg, batch["frames"])
    cross_kv = _cross_kv_all(halves, cfg, enc_out)
    tokens, labels = batch["tokens"], batch["labels"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    hidden, _ = apply_decoder(halves, cfg, tokens, positions, cross_kv)
    w = halves["decoder"]["embed"]["embedding"].T.to(hidden.dtype)
    nll, cnt, _ = chunked_xent(hidden, w, labels, cfg.xent_chunk, 0.0)
    loss = nll / torch.clamp_min(cnt, 1.0)
    return loss, {"nll": loss, "tokens": cnt, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_encdec_cache(cfg: ModelConfig, batch: int, seq_budget: int, enc_len: int, dtype=torch.bfloat16,
                      device="cuda") -> Dict:
    """The decoder's self-attention caches and slots for the cross K/V
    (replaced by :func:`encdec_prefill`'s)."""
    Kv, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros():
        return torch.zeros((batch, enc_len, Kv, hd), dtype=dtype, device=device)

    return {
        "layers": [init_attn_cache(cfg, kind, batch, seq_budget, dtype, device) for kind in _dec_kinds(cfg)],
        "cross_kv": [(zeros(), zeros()) for _ in _dec_kinds(cfg)],
    }


def encdec_cache_axes(cfg: ModelConfig) -> Dict:
    """The logical-axes tree of :func:`init_encdec_cache` (the reference
    writes it as a literal in its dry run): the decoder's self-attention
    caches and the cross K/V, sequence replicated."""
    kv = ("batch", "seq", "kv_heads", "head_dim")
    return {
        "layers": [{"k": kv, "v": kv, "pos": ("seq",)} for _ in _dec_kinds(cfg)],
        "cross_kv": [(kv, kv) for _ in _dec_kinds(cfg)],
    }


def encdec_prefill(
    params: Params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor, caches: Dict
) -> Tuple[torch.Tensor, Dict]:
    """Encode ``frames``, project the cross K/V and run the decoder prompt
    into the caches; returns (last-position logits ``(B, V)``, caches)."""
    halves = _halves(params, cfg)
    enc_out = encode(halves, cfg, frames)
    cross_kv = _cross_kv_all(halves, cfg, enc_out)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    hidden, new = apply_decoder(halves, cfg, tokens, positions, cross_kv, caches={"layers": caches["layers"]})
    return _dec_logits(halves, cfg, hidden[:, -1:])[:, 0], {"layers": new["layers"], "cross_kv": cross_kv}


def encdec_decode_step(
    params: Params, cfg: ModelConfig, token: torch.Tensor, pos, caches: Dict
) -> Tuple[torch.Tensor, Dict]:
    """One decoder token at absolute position ``pos`` over the caches."""
    halves = _halves(params, cfg)
    positions = torch.as_tensor(pos, device=token.device).reshape(1).to(torch.int64)
    hidden, new = apply_decoder(halves, cfg, token, positions, caches["cross_kv"],
                                caches={"layers": caches["layers"]}, decode=True)
    return _dec_logits(halves, cfg, hidden[:, 0]), {"layers": new["layers"], "cross_kv": caches["cross_kv"]}
