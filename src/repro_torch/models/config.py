"""One config dataclass covering all assigned architecture families.

The port's copy of the reference's ``models/config.py``: the same fields,
defaults and checks, with torch dtypes for ``dtype`` and ``logit_dtype``.
Only recurrentgemma-2b's serving path runs in this package so far.  The
fields that only other families (MoE, MLA, encoder-decoder, frontends),
training or the reference's distribution knobs read are kept so that a
config reads the same on both sides, but a value other than the default
raises ``NotImplementedError``: nothing in the port would read it yet
(ROADMAP queue 1, item 10: what remains of the LLM stack).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Tuple

import torch

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # Block pattern: layer kinds cycled over the depth.  Kinds:
    #   attn   — global attention block
    #   local  — sliding-window attention block
    #   rec    — RG-LRU recurrent block (recurrentgemma)
    #   mlstm / slstm — xLSTM blocks
    pattern: Tuple[str, ...] = ("attn",)
    # Leading layers outside the repeated pattern (deepseek-v2's dense first layer).
    prefix: Tuple[str, ...] = ()
    prefix_dense_ff: int = 0  # d_ff of the dense prefix layer(s)

    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu (non-gated)
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm

    # Attention options
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    window: int = 0  # sliding-window size for 'local' layers
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    post_norms: bool = False  # gemma2 sandwich (post-attn/post-mlp norms)
    tie_embeddings: bool = True
    embed_scale: float = 1.0  # gemma multiplies embeddings by sqrt(d_model)

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # MLA (deepseek-v2)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # Recurrent blocks
    d_rnn: int = 0
    conv_width: int = 4

    # Encoder-decoder (seamless)
    encoder_layers: int = 0
    encoder_pattern: Tuple[str, ...] = ("attn",)

    # Modality frontend stubs
    frontend: str = "none"  # none | vision_stub | audio_stub
    num_prefix_embeddings: int = 0

    # The reference switches full-sequence attention to a query-chunked
    # path above this length.
    attn_chunk_threshold: int = 8192
    attn_q_chunk: int = 1024

    # Loss / numerics
    zloss: float = 0.0
    logit_dtype: Any = torch.float32
    dtype: Any = torch.bfloat16
    xent_chunk: int = 512

    # Distribution knobs of the reference (remat, scanned layers, gradient
    # accumulation, dry-run unrolling); the port reads only scan_layers.
    remat: str = "full"
    scan_layers: bool = True
    train_accum: int = 1
    unroll_scans: bool = False

    def __post_init__(self):
        set_unread = [f for f in _NOT_READ if getattr(self, f) != _DEFAULTS[f]]
        if set_unread:
            raise NotImplementedError(
                f"{self.name}: {', '.join(set_unread)} not read by the port yet (ROADMAP queue 1, item 10: what remains of the LLM stack)"
            )
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        scanned = self.num_layers - len(self.prefix)
        if self.scan_layers and scanned % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: {scanned} scanned layers not divisible by pattern {self.pattern}"
            )

    # -- derived ------------------------------------------------------------

    @property
    def num_units(self) -> int:
        return (self.num_layers - len(self.prefix)) // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_subquadratic(self) -> bool:
        """True if decode-state size is O(1) in context length."""
        kinds = self.pattern + self.prefix + (self.encoder_pattern if self.is_encdec else ())
        return "attn" not in kinds

    def layer_kinds(self) -> Tuple[str, ...]:
        """The kind of every layer, prefix first: layer ``len(prefix) +
        u * len(pattern) + s`` is pattern slot ``s`` of unit ``u``."""
        return self.prefix + self.pattern * self.num_units

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# Fields whose families, training path or knobs are not ported yet.
_NOT_READ = (
    "num_experts", "num_shared_experts", "top_k", "d_ff_expert", "capacity_factor", "aux_loss_weight",
    "mla", "q_lora_rank", "kv_lora_rank", "rope_head_dim", "nope_head_dim", "v_head_dim",
    "encoder_layers", "encoder_pattern", "frontend", "num_prefix_embeddings",
    "attn_chunk_threshold", "attn_q_chunk", "zloss", "xent_chunk", "remat", "train_accum", "unroll_scans",
)
_DEFAULTS = {f.name: f.default for f in fields(ModelConfig)}
